"""The Aaren attention mixer — port of the Aaren half of
``repro.models.attention``.

Entry points, as in the JAX package:

* :func:`attn_proj_specs` / :func:`aaren_state_init`;
* :func:`aaren_sequence` — full-sequence prefill (``lengths`` masks a
  ragged right-padded tail), returning the final carry;
* :func:`aaren_step`     — the O(1) one-token decode update;
* :func:`aaren_chunk`    — fold a fixed-shape (B, C) chunk into the carry,
  the serving engine's hot path.

The softmax mixer (ring KV cache, flash kernels) comes with a later slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import aaren as aaren_core
from repro_torch.core.scan_attention import ScanState, mask_to_identity
from repro_torch.kernels import ops as kops
from repro_torch.models.param import ParamSpec


def attn_proj_specs(cfg: ArchConfig, *, with_query_token: bool) -> dict:
    d, h, g, k = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    specs = {
        "wq": ParamSpec((d, h, k)),
        "wk": ParamSpec((d, g, k)),
        "wv": ParamSpec((d, g, k)),
        "wo": ParamSpec((h, k, d)),
    }
    if with_query_token:
        # The learned query token q^(j) — the paper's ~0.016% param overhead.
        specs["query"] = ParamSpec((d,), init="query")
    return specs


def _aaren_weights(p: dict) -> aaren_core.AarenWeights:
    return aaren_core.AarenWeights(query=p["query"], wq=p["wq"], wk=p["wk"],
                                   wv=p["wv"], wo=p["wo"])


def aaren_state_init(cfg: ArchConfig, batch: int, device) -> ScanState:
    return aaren_core.empty_carry(batch, cfg.n_heads, cfg.resolved_head_dim,
                                  device=device)


def _prefix_attention(q_heads, k, v, scale, *, carry=None, mask=None):
    """Scores + per-head values, then the prefix-scan kernel boundary.

    ``mask`` (B, N): valid positions; the rest enter the scan as ⊕-identity
    leaves.  Returns ((B, N, H, d) in v's dtype, final carry).
    """
    s = aaren_core._scores(q_heads, k, scale)                  # (B, H, N)
    vh = aaren_core._values_per_head(v, q_heads.shape[0]).float()
    if mask is not None:
        s, vh = mask_to_identity(s, vh, mask[:, None, :])
    o, final = kops.aaren_prefix_attention(s, vh, carry)       # (B, H, N, d)
    return o.transpose(1, 2).to(v.dtype), final


def aaren_sequence(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   lengths: torch.Tensor | None = None):
    """Full-sequence Aaren (prefix scan from the empty carry).

    ``lengths`` (B,): ragged right-padded rows — the padded tail enters as
    ⊕-identity leaves, so the final carry is the state at each row's true
    length.  Returns (y (B, N, D), final carry).
    """
    mask = None
    if lengths is not None:
        mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                < lengths[:, None])

    def attention_fn(q_heads, k, v, scale):
        return _prefix_attention(q_heads, k, v, scale, mask=mask)

    return aaren_core.aaren_layer_parallel(_aaren_weights(p), x, attention_fn)


def aaren_step(p: dict, x_t: torch.Tensor, state: ScanState, cfg: ArchConfig):
    """O(1) streaming update — the paper's constant-memory inference."""
    return aaren_core.aaren_layer_step(_aaren_weights(p), x_t, state)


def aaren_chunk(p: dict, x: torch.Tensor, state: ScanState, cfg: ArchConfig,
                *, mask: torch.Tensor | None = None):
    """Chunked prefill: fold a fixed-shape (B, C, D) chunk into the carry.

    ``mask`` (B, C) marks the real positions: some slots are mid-prefill (C
    prompt tokens), some decode (one valid token), free slots are all
    padding.  Masked positions enter the scan as ⊕-identity leaves.
    """
    w = _aaren_weights(p)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    q_heads = aaren_core.head_queries(w)
    k, v = aaren_core._project_kv(w, x)
    ctx, final = _prefix_attention(q_heads, k, v, scale, carry=state,
                                   mask=mask)
    return aaren_core._project_out(w, ctx), final
