"""Residual blocks: (norm → mixer → +) (norm → mlp → +), three eval modes.

Port of ``repro.models.blocks`` for the signatures the serving slice runs:
``("aaren", "swiglu")`` and ``("aaren", "gelu")``.  Any other mixer or MLP
raises; those come with later slices.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_gelu_mlp,
    apply_norm,
    apply_swiglu,
    gelu_mlp_specs,
    norm_specs,
    swiglu_specs,
)

Sig = tuple[str, str]
SUPPORTED_MLPS = ("swiglu", "gelu")
# Auxiliary metrics of a dense block (the MoE router's, which a dense model
# reports as 0), as in the JAX package.
ZERO_AUX = {"load_balance_loss": 0.0, "dropped_frac": 0.0}


def check_sig(sig: Sig) -> None:
    mixer, mlp = sig
    if mixer != "aaren" or mlp not in SUPPORTED_MLPS:
        raise NotImplementedError(
            f"block {sig!r}: the port runs ('aaren', 'swiglu'|'gelu') "
            "blocks only; other mixers and MLPs come with later slices")


def block_specs(sig: Sig, cfg: ArchConfig) -> dict:
    check_sig(sig)
    mlp = (swiglu_specs if sig[1] == "swiglu" else gelu_mlp_specs)(
        cfg.d_model, cfg.d_ff)
    return {"norm1": norm_specs(cfg.d_model, cfg.norm),
            "mixer": attn.attn_proj_specs(cfg, with_query_token=True),
            "norm2": norm_specs(cfg.d_model, cfg.norm),
            "mlp": mlp}


def block_state_init(sig: Sig, cfg: ArchConfig, batch: int, device):
    check_sig(sig)
    return attn.aaren_state_init(cfg, batch, device)


def _apply_mlp(p: dict, x: torch.Tensor, sig: Sig, cfg: ArchConfig):
    h = apply_norm(p["norm2"], x, cfg.norm)
    if sig[1] == "swiglu":
        return x + apply_swiglu(p["mlp"], h)
    return x + apply_gelu_mlp(p["mlp"], h)


def block_sequence(p: dict, x: torch.Tensor, sig: Sig, cfg: ArchConfig, *,
                   lengths: torch.Tensor | None = None):
    """Full-sequence block.  Returns (x, final carry)."""
    check_sig(sig)
    h = apply_norm(p["norm1"], x, cfg.norm)
    y, state = attn.aaren_sequence(p["mixer"], h, cfg, lengths=lengths)
    return _apply_mlp(p, x + y, sig, cfg), state


def block_step(p: dict, x_t: torch.Tensor, state, sig: Sig, cfg: ArchConfig):
    """One-token decode.  Returns (x_t, new_state)."""
    check_sig(sig)
    h = apply_norm(p["norm1"], x_t, cfg.norm)
    y, new_state = attn.aaren_step(p["mixer"], h, state, cfg)
    return _apply_mlp(p, x_t + y, sig, cfg), new_state


def block_chunk(p: dict, x: torch.Tensor, state, sig: Sig, cfg: ArchConfig,
                *, mask: torch.Tensor | None = None):
    """Fixed-shape chunk through one block's carry.  Returns (x, new_state).

    x: (B, C, D); mask: (B, C) valid-position flags (None = all valid).
    Norms and MLPs are position-wise, so only the mixer needs the mask.
    """
    check_sig(sig)
    h = apply_norm(p["norm1"], x, cfg.norm)
    y, new_state = attn.aaren_chunk(p["mixer"], h, state, cfg, mask=mask)
    return _apply_mlp(p, x + y, sig, cfg), new_state
