"""Residual blocks: (norm → mixer → +) (norm → mlp → +), three eval modes.

Port of ``repro.models.blocks``: an ``"aaren"``, ``"attn"`` (global
softmax), ``"attn_local"`` (sliding-window softmax), ``"rglru"`` (Griffin's
recurrence) or ``"ssd"`` (Mamba-2) mixer with a ``"swiglu"``, ``"gelu"``,
``"moe"`` (routed experts) or ``"none"`` MLP (a block without the second
half).  Decode states are an Aaren ``ScanState`` carry, a softmax
KV-cache dict, an RG-LRU ``{"h", "conv"}`` dict or an SSD ``{"s",
"conv"}`` dict.  A full-sequence block also returns the MLP's auxiliary
metrics (the MoE router's; 0 for the other MLPs).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import (
    apply_gelu_mlp,
    apply_norm,
    apply_swiglu,
    gelu_mlp_specs,
    norm_specs,
    swiglu_specs,
)

Sig = tuple[str, str]
SUPPORTED_MIXERS = ("aaren", "attn", "attn_local", "rglru", "ssd")
SUPPORTED_MLPS = ("swiglu", "gelu", "moe", "none")
# Auxiliary metrics of a dense block (the MoE router's, which a dense model
# reports as 0), as in the JAX package.
ZERO_AUX = {"load_balance_loss": 0.0, "dropped_frac": 0.0}
_RECURRENT = {"rglru": (rglru_mod.rglru_sequence, rglru_mod.rglru_step),
              "ssd": (ssd_mod.ssd_sequence, ssd_mod.ssd_step)}


def check_sig(sig: Sig) -> None:
    mixer, mlp = sig
    for kind, name, known in (("mixer", mixer, SUPPORTED_MIXERS),
                              ("MLP", mlp, SUPPORTED_MLPS)):
        if name not in known:
            raise ValueError(f"block {sig!r}: unknown {kind} {name!r}; the "
                             f"port runs the mixers {SUPPORTED_MIXERS} and "
                             f"the MLPs {SUPPORTED_MLPS}")


def _window(sig: Sig, cfg: ArchConfig) -> int | None:
    return cfg.window if sig[0] == "attn_local" else None


def _cache_len(sig: Sig, cfg: ArchConfig, cache_len: int | None):
    """A sliding-window layer keeps at most ``window`` positions."""
    if cache_len is None or sig[0] != "attn_local":
        return cache_len
    return min(cfg.window, cache_len)


def block_specs(sig: Sig, cfg: ArchConfig) -> dict:
    check_sig(sig)
    mixer, mlp = sig
    if mixer == "rglru":
        mixer_specs = rglru_mod.rglru_specs(cfg)
    elif mixer == "ssd":
        mixer_specs = ssd_mod.ssd_specs(cfg)
    else:
        mixer_specs = attn.attn_proj_specs(cfg,
                                           with_query_token=mixer == "aaren")
    specs = {"norm1": norm_specs(cfg.d_model, cfg.norm),
             "mixer": mixer_specs}
    if mlp != "none":
        specs["norm2"] = norm_specs(cfg.d_model, cfg.norm)
        specs["mlp"] = (moe_mod.moe_specs(cfg) if mlp == "moe" else
                        (swiglu_specs if mlp == "swiglu" else gelu_mlp_specs)(
                            cfg.d_model, cfg.d_ff))
    return specs


def block_state_init(sig: Sig, cfg: ArchConfig, batch: int,
                     cache_len: int | None, device):
    """The empty decode state: an Aaren carry, an RG-LRU or SSD state of
    zeros, or a KV cache of ``cache_len`` slots (``min(window,
    cache_len)`` for ``attn_local``)."""
    check_sig(sig)
    if sig[0] == "aaren":
        return attn.aaren_state_init(cfg, batch, device)
    if sig[0] == "rglru":
        return rglru_mod.rglru_state_init(cfg, batch, device)
    if sig[0] == "ssd":
        return ssd_mod.ssd_state_init(cfg, batch, device)
    if cache_len is None:
        raise ValueError(f"a {sig[0]!r} layer's KV cache needs a cache_len")
    return attn.softmax_state_init(cfg, batch, _cache_len(sig, cfg, cache_len),
                                   device)


def _apply_mlp(p: dict, x: torch.Tensor, sig: Sig, cfg: ArchConfig,
               want_aux: bool, decode: bool = False):
    """(x + MLP(norm2(x)), aux).  ``aux`` is the MoE router's metrics, or
    ``ZERO_AUX`` for the other MLPs and when ``want_aux`` is off."""
    mlp = sig[1]
    if mlp == "none":
        return x, dict(ZERO_AUX)
    h = apply_norm(p["norm2"], x, cfg.norm)
    if mlp == "swiglu":
        return x + apply_swiglu(p["mlp"], h), dict(ZERO_AUX)
    if mlp == "gelu":
        return x + apply_gelu_mlp(p["mlp"], h), dict(ZERO_AUX)
    if not want_aux:
        return x + moe_mod.apply_moe(p["mlp"], h, cfg,
                                     decode=decode), dict(ZERO_AUX)
    y, aux = moe_mod.apply_moe(p["mlp"], h, cfg, return_aux=True,
                               decode=decode)
    return x + y, aux


def block_sequence(p: dict, x: torch.Tensor, sig: Sig, cfg: ArchConfig, *,
                   cache_len: int | None = None, want_aux: bool = True,
                   segment_ids: torch.Tensor | None = None,
                   positions: torch.Tensor | None = None,
                   lengths: torch.Tensor | None = None):
    """Full-sequence block.  Returns (x, decode state, aux).

    A softmax layer returns a KV cache of ``cache_len`` slots, or None
    when ``cache_len`` is None (training keeps no cache).
    ``segment_ids``/``positions``: packed-sequence arrays (only the mixer
    reads them; Aaren has no RoPE and ignores ``positions``; a MoE MLP
    routes padding too).  An RG-LRU or SSD layer refuses ``segment_ids``
    and ``lengths`` with the JAX package's ``ValueError``: its recurrence
    has no maskable identity element.  ``aux``: the MoE router's
    ``load_balance_loss`` and ``dropped_frac`` (0-d f32 tensors), or
    ``ZERO_AUX``."""
    check_sig(sig)
    h = apply_norm(p["norm1"], x, cfg.norm)
    if sig[0] in _RECURRENT:
        if segment_ids is not None or lengths is not None:
            raise ValueError(
                f"{sig[0]} has no packed-segment or ragged-length support: "
                "its recurrence has no maskable identity element")
        y, state = _RECURRENT[sig[0]][0](p["mixer"], h, cfg)
    elif sig[0] == "aaren":
        y, state = attn.aaren_sequence(p["mixer"], h, cfg,
                                       segment_ids=segment_ids,
                                       lengths=lengths)
    else:
        y, state = attn.softmax_sequence(
            p["mixer"], h, cfg, window=_window(sig, cfg),
            cache_len=_cache_len(sig, cfg, cache_len), lengths=lengths,
            segment_ids=segment_ids, positions=positions)
    x, aux = _apply_mlp(p, x + y, sig, cfg, want_aux)
    return x, state, aux


def block_step(p: dict, x_t: torch.Tensor, state, sig: Sig, cfg: ArchConfig):
    """One-token decode.  Returns (x_t, new_state)."""
    check_sig(sig)
    h = apply_norm(p["norm1"], x_t, cfg.norm)
    if sig[0] in _RECURRENT:
        y, new_state = _RECURRENT[sig[0]][1](p["mixer"], h, state, cfg)
    elif sig[0] == "aaren":
        y, new_state = attn.aaren_step(p["mixer"], h, state, cfg)
    else:
        y, new_state = attn.softmax_step(p["mixer"], h, state, cfg,
                                         window=_window(sig, cfg))
    x_t, _ = _apply_mlp(p, x_t + y, sig, cfg, want_aux=False, decode=True)
    return x_t, new_state


def block_chunk(p: dict, x: torch.Tensor, state, sig: Sig, cfg: ArchConfig,
                *, mask: torch.Tensor | None = None):
    """Fixed-shape chunk through one block's carry.  Returns (x, new_state).

    x: (B, C, D); mask: (B, C) valid-position flags (None = all valid).
    Norms and dense MLPs are position-wise, so only the mixer needs the
    mask.  Aaren folds all C positions in one prefix scan (masked positions
    are ⊕-identity).  An RG-LRU or SSD carry advances strictly token by
    token — its conv window and decay have no masked identity element — so
    it needs C == 1 (the engine runs such models at chunk 1) and ignores
    the mask (the engine keeps an all-padding row's carry itself).  A MoE
    MLP routes padded positions too: with capacity per row and per call, a
    chunk may drop other tokens than a one-shot prefill when capacity
    binds, as in the JAX package.
    """
    check_sig(sig)
    h = apply_norm(p["norm1"], x, cfg.norm)
    if sig[0] in _RECURRENT:
        if h.shape[1] != 1:
            raise ValueError(
                f"{sig[0]} carries advance one token at a time; chunked "
                f"prefill needs chunk == 1, got chunk = {h.shape[1]}")
        y, new_state = _RECURRENT[sig[0]][1](p["mixer"], h, state, cfg)
    elif sig[0] == "aaren":
        y, new_state = attn.aaren_chunk(p["mixer"], h, state, cfg, mask=mask)
    else:
        raise ValueError(f"chunked prefill needs a position-free carry; "
                         f"{sig[0]!r} has none")
    x, _ = _apply_mlp(p, x + y, sig, cfg, want_aux=False,
                      decode=x.shape[1] == 1)
    return x, new_state
