"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]

The paper's Aaren transform is INAPPLICABLE here (no attention to replace —
DESIGN.md §Arch-applicability); the arch is implemented natively with the
chunked SSD scan, which shares the scan-with-carry skeleton with Aaren's
Appendix-A evaluation.
"""

from repro_torch.configs.base import ArchConfig, register


@register
def mamba2_1p3b() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=1,          # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,
        vocab=50280,
        pattern=("ssd",),
        mlp_pattern=("none",),
        ssm_state=128,
        d_conv=4,
        expand=2,           # d_inner = 4096
        ssm_heads=64,       # SSD head dim 64
        norm="rmsnorm",
        tie_embeddings=True,
        optimizer="adamw",
        remat="block",
        attn_mode="aaren",  # no-op for this pattern; kept for uniform CLI
    )
