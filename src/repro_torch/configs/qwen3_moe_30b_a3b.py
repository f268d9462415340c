"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained.
[hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.configs.base import ArchConfig, register


@register
def qwen3_moe_30b_a3b() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,          # per-expert hidden (fine-grained MoE)
        vocab=151936,
        pattern=("attn",),
        mlp_pattern=("moe",),
        n_experts=128,
        n_experts_per_tok=8,
        moe_d_ff=768,
        capacity_factor=1.25,
        rope_theta=1000000.0,
        norm="rmsnorm",
        optimizer="adamw",
        remat="block",
    )
