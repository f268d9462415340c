"""llama3-405b [dense] — GQA, 128k vocab.  [arXiv:2407.21783]"""

from repro_torch.configs.base import ArchConfig, register


@register
def llama3_405b() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab=128256,
        pattern=("attn",),
        mlp_pattern=("swiglu",),
        rope_theta=500000.0,
        norm="rmsnorm",
        # 405B-class memory policy: factored second moments so the optimizer
        # state fits 256 x 16 GB alongside the fp32 master copy.
        optimizer="adafactor",
        remat="block",
        n_microbatches=16,
        notes="GQA kv=8; aaren mode replaces all attention layers.",
    )
