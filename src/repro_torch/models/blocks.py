"""Residual blocks: (norm → mixer → +) (norm → mlp → +), three eval modes.

Port of ``repro.models.blocks`` for the signatures the port runs: an
``"aaren"``, ``"attn"`` (global softmax) or ``"attn_local"``
(sliding-window softmax) mixer with a ``"swiglu"`` or ``"gelu"`` MLP.  Any
other mixer or MLP raises; those come with later slices.  Decode states are
an Aaren ``ScanState`` carry or a softmax KV-cache dict.
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
SUPPORTED_MIXERS = ("aaren", "attn", "attn_local")
SUPPORTED_MLPS = ("swiglu", "gelu")
# Auxiliary metrics of a dense block (the MoE router's, which a dense model
# reports as 0), as in the JAX package.
ZERO_AUX = {"load_balance_loss": 0.0, "dropped_frac": 0.0}


def check_sig(sig: Sig) -> None:
    mixer, mlp = sig
    if mixer not in SUPPORTED_MIXERS or mlp not in SUPPORTED_MLPS:
        raise NotImplementedError(
            f"block {sig!r}: the port runs ('aaren'|'attn'|'attn_local', "
            "'swiglu'|'gelu') blocks only; other mixers and MLPs come with "
            "later slices")


def _window(sig: Sig, cfg: ArchConfig) -> int | None:
    return cfg.window if sig[0] == "attn_local" else None


def _cache_len(sig: Sig, cfg: ArchConfig, cache_len: int | None):
    """A sliding-window layer keeps at most ``window`` positions."""
    if cache_len is None or sig[0] != "attn_local":
        return cache_len
    return min(cfg.window, cache_len)


def block_specs(sig: Sig, cfg: ArchConfig) -> dict:
    check_sig(sig)
    mlp = (swiglu_specs if sig[1] == "swiglu" else gelu_mlp_specs)(
        cfg.d_model, cfg.d_ff)
    return {"norm1": norm_specs(cfg.d_model, cfg.norm),
            "mixer": attn.attn_proj_specs(
                cfg, with_query_token=sig[0] == "aaren"),
            "norm2": norm_specs(cfg.d_model, cfg.norm),
            "mlp": mlp}


def block_state_init(sig: Sig, cfg: ArchConfig, batch: int,
                     cache_len: int | None, device):
    """The empty decode state: an Aaren carry, or a KV cache of
    ``cache_len`` slots (``min(window, cache_len)`` for ``attn_local``)."""
    check_sig(sig)
    if sig[0] == "aaren":
        return attn.aaren_state_init(cfg, batch, device)
    if cache_len is None:
        raise ValueError(f"a {sig[0]!r} layer's KV cache needs a cache_len")
    return attn.softmax_state_init(cfg, batch, _cache_len(sig, cfg, cache_len),
                                   device)


def _apply_mlp(p: dict, x: torch.Tensor, sig: Sig, cfg: ArchConfig):
    h = apply_norm(p["norm2"], x, cfg.norm)
    if sig[1] == "swiglu":
        return x + apply_swiglu(p["mlp"], h)
    return x + apply_gelu_mlp(p["mlp"], h)


def block_sequence(p: dict, x: torch.Tensor, sig: Sig, cfg: ArchConfig, *,
                   cache_len: int | None = None,
                   segment_ids: torch.Tensor | None = None,
                   positions: torch.Tensor | None = None,
                   lengths: torch.Tensor | None = None):
    """Full-sequence block.  Returns (x, decode state).

    A softmax layer returns a KV cache of ``cache_len`` slots, or None
    when ``cache_len`` is None (training keeps no cache).
    ``segment_ids``/``positions``: packed-sequence arrays (only the mixer
    reads them; Aaren has no RoPE and ignores ``positions``)."""
    check_sig(sig)
    h = apply_norm(p["norm1"], x, cfg.norm)
    if sig[0] == "aaren":
        y, state = attn.aaren_sequence(p["mixer"], h, cfg,
                                       segment_ids=segment_ids,
                                       lengths=lengths)
    else:
        y, state = attn.softmax_sequence(
            p["mixer"], h, cfg, window=_window(sig, cfg),
            cache_len=_cache_len(sig, cfg, cache_len), lengths=lengths,
            segment_ids=segment_ids, positions=positions)
    return _apply_mlp(p, x + y, sig, cfg), state


def block_step(p: dict, x_t: torch.Tensor, state, sig: Sig, cfg: ArchConfig):
    """One-token decode.  Returns (x_t, new_state)."""
    check_sig(sig)
    h = apply_norm(p["norm1"], x_t, cfg.norm)
    if sig[0] == "aaren":
        y, new_state = attn.aaren_step(p["mixer"], h, state, cfg)
    else:
        y, new_state = attn.softmax_step(p["mixer"], h, state, cfg,
                                         window=_window(sig, cfg))
    return _apply_mlp(p, x_t + y, sig, cfg), new_state


def block_chunk(p: dict, x: torch.Tensor, state, sig: Sig, cfg: ArchConfig,
                *, mask: torch.Tensor | None = None):
    """Fixed-shape chunk through one block's carry.  Returns (x, new_state).

    x: (B, C, D); mask: (B, C) valid-position flags (None = all valid).
    Norms and MLPs are position-wise, so only the mixer needs the mask.
    Only Aaren has the position-free carry this needs.
    """
    check_sig(sig)
    if sig[0] != "aaren":
        raise ValueError(f"chunked prefill needs a position-free carry; "
                         f"{sig[0]!r} has none")
    h = apply_norm(p["norm1"], x, cfg.norm)
    y, new_state = attn.aaren_chunk(p["mixer"], h, state, cfg, mask=mask)
    return _apply_mlp(p, x + y, sig, cfg), new_state
