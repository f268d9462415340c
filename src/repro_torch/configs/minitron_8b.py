"""minitron-8b [dense] — pruned nemotron, GQA kv=8, 256k vocab.
[arXiv:2407.14679]"""

from repro_torch.configs.base import ArchConfig, register


@register
def minitron_8b() -> ArchConfig:
    return ArchConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=256000,
        pattern=("attn",),
        mlp_pattern=("swiglu",),
        rope_theta=10000.0,
        norm="rmsnorm",
        optimizer="adamw",
        remat="block",
    )
