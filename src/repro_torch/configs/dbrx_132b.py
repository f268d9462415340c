"""dbrx-132b [moe] — 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base]"""

from repro_torch.configs.base import ArchConfig, register


@register
def dbrx_132b() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab=100352,
        pattern=("attn",),
        mlp_pattern=("moe",),
        n_experts=16,
        n_experts_per_tok=4,
        moe_d_ff=10752,
        capacity_factor=1.25,
        rope_theta=500000.0,
        norm="layernorm",
        optimizer="adafactor",
        remat="block",
        n_microbatches=16,
    )
