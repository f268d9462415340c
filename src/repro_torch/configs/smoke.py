"""Reduced same-family smoke variants of the registered architectures.

``smoke_config(name)`` keeps the *structure* (family, mixer pattern, MLP
kind, norm) and shrinks every capacity dimension so a forward or a serving
tick runs on the CPU in milliseconds.  A copy of
``repro.configs.smoke.smoke_config``; the drift test holds them equal.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, get_config


def smoke_config(name: str, **overrides) -> ArchConfig:
    cfg = get_config(name)
    period = len(cfg.pattern)
    small: dict = dict(
        n_layers=period + 1 if period > 1 else 3,  # periods + remainder path
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        window=8,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        n_microbatches=2,
    )
    if cfg.n_experts:
        small.update(n_experts=4, n_experts_per_tok=2, moe_d_ff=64)
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_heads=4, expand=2)
    if cfg.rnn_width:
        small.update(rnn_width=128)
    if cfg.is_encdec:
        small.update(n_enc_layers=2, enc_frames=16)
    if cfg.vision_tokens:
        small.update(vision_tokens=8)
    small.update(overrides)
    return cfg.replace(name=cfg.name + "-smoke", **small)
