"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA (kv=32).  [arXiv:2404.14219]"""

from repro_torch.configs.base import ArchConfig, register


@register
def phi3_mini_3p8b() -> ArchConfig:
    return ArchConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab=32064,
        pattern=("attn",),
        mlp_pattern=("swiglu",),
        rope_theta=10000.0,
        norm="rmsnorm",
        optimizer="adamw",
        remat="block",
    )
