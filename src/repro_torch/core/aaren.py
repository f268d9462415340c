"""Aaren — [A]ttention [a]s a [re]current neural [n]etwork (paper §3.3).

Port of ``repro.core.aaren``.  An Aaren layer has the interface of causal
self-attention, but its query is a learned constant token per layer
(projected to per-head queries), and the cumulative softmax is evaluated
with the ⊕ scan of ``repro_torch.core.scan_attention``:

* :func:`aaren_layer_parallel` — all N outputs at once (prefill), through
  the kernel boundary ``kernels/ops.aaren_prefix_attention``;
* :func:`aaren_layer_step`     — the O(1) streaming update (the RNN cell);
* :func:`aaren_attention_parallel` / :func:`aaren_attention_chunked` — the
  plain torch prefix attention with and without an incoming carry, the
  reference the kernel boundary is held to (nothing on the main path
  calls them).

GQA: ``kv_heads`` divides ``heads``; query head ``h`` reads kv head
``h // (H/G)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.scan_attention import (
    ScanState,
    combine,
    final_state,
    fold_carry,
    make_empty_state,
    make_leaf_state,
    mask_to_identity,
    prefix_scan_states,
    readout,
)


class AarenWeights(NamedTuple):
    """Parameters of one Aaren layer.

    ``query``: (d_model,) learned query token q^{(j)} (paper §3.3);
    ``wq``: (d_model, H, d_head) query projection (applied to ``query``);
    ``wk``/``wv``: (d_model, G, d_head) key/value projections;
    ``wo``: (H, d_head, d_model) output projection.
    """

    query: torch.Tensor
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor


def head_queries(w: AarenWeights) -> torch.Tensor:
    """Project the learned query token to per-head queries: (H, d_head), f32."""
    d, h, k = w.wq.shape
    return (w.query.float() @ w.wq.float().reshape(d, h * k)).reshape(h, k)


def _project_kv(w: AarenWeights, x: torch.Tensor):
    """x: (B, N, D) -> k, v: (B, N, G, d_head) in x's dtype."""
    d, g, k = w.wk.shape
    kk = (x @ w.wk.to(x.dtype).reshape(d, g * k)).unflatten(-1, (g, k))
    vv = (x @ w.wv.to(x.dtype).reshape(d, g * k)).unflatten(-1, (g, k))
    return kk, vv


def _scores(q_heads: torch.Tensor, k: torch.Tensor, scale: float):
    """q_heads: (H, d), k: (B, N, G, d) -> s: (B, H, N) (f32).

    GQA: query head h reads kv head h // (H/G), through the (G, H/G, d)
    reshape of the JAX package.
    """
    h = q_heads.shape[0]
    g = k.shape[2]
    qg = q_heads.reshape(g, h // g, q_heads.shape[-1])  # (G, H/G, d)
    s = torch.einsum("bngk,grk->bgrn", k.float(), qg) * scale
    return s.reshape(k.shape[0], h, k.shape[1])


def _values_per_head(v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """v: (B, N, G, d) -> (B, H, N, d) with kv-head grouping."""
    b, n, g, d = v.shape
    v = v.transpose(1, 2)  # (B, G, N, d)
    v = v[:, :, None].expand(b, g, n_heads // g, n, d)
    return v.reshape(b, n_heads, n, d)


def aaren_attention_parallel(q_heads, k, v, scale: float):
    """All-prefix attention from the empty state in plain torch.

    q_heads: (H, d); k, v: (B, N, G, d).  Returns ((B, N, H, d) in v's
    dtype, final ScanState with m,u (B, H), w (B, H, d)).
    """
    s = _scores(q_heads, k, scale)                                # (B, H, N)
    vh = _values_per_head(v, q_heads.shape[0]).float()            # (B,H,N,d)
    states = prefix_scan_states(s, vh)
    return readout(states).transpose(1, 2).to(v.dtype), final_state(states)


def aaren_attention_chunked(q_heads, k, v, carry: ScanState, scale: float,
                            mask: torch.Tensor | None = None):
    """Prefix attention over one chunk, folding in an incoming carry.

    ``mask`` (B, N) bool marks the valid chunk positions; the rest enter
    the scan as ⊕-identity leaves, so a fixed-shape chunk can hold a ragged
    tail.  Returns ((B, N, H, d), final ScanState).
    """
    s = _scores(q_heads, k, scale)
    vh = _values_per_head(v, q_heads.shape[0]).float()
    if mask is not None:
        s, vh = mask_to_identity(s, vh, mask[:, None, :])  # (B,N) -> heads
    out, final = _chunk_with_carry(s, vh, carry)
    return out.transpose(1, 2).to(v.dtype), final


def _chunk_with_carry(s, vh, carry: ScanState):
    """Scores (B, H, N) and values (B, H, N, d) scanned after ``carry``:
    (readout (B, H, N, d), final state)."""
    states = fold_carry(carry, prefix_scan_states(s, vh))
    return readout(states), final_state(states)


def _project_out(w: AarenWeights, ctx: torch.Tensor) -> torch.Tensor:
    """ctx: (B, N, H, d_head) -> (B, N, D)."""
    h, k, d = w.wo.shape
    return ctx.flatten(-2) @ w.wo.to(ctx.dtype).reshape(h * k, d)


def aaren_attention_step(q_heads, k_t, v_t, carry: ScanState, scale: float):
    """O(1) streaming update with a single token.

    k_t/v_t: (B, 1, G, d); carry leaves: m,u (B, H), w (B, H, d).
    Returns ((B, 1, H, d) output, new carry).
    """
    s = _scores(q_heads, k_t, scale)[..., 0]  # (B, H)
    vh = _values_per_head(v_t, q_heads.shape[0])[..., 0, :].float()
    new = combine(carry, make_leaf_state(s, vh))
    out = readout(new)  # (B, H, d)
    return out[:, None].to(v_t.dtype), new


def empty_carry(batch: int, n_heads: int, head_dim: int, *,
                device) -> ScanState:
    """Constant-memory decode state of one Aaren layer: O(H·(2+d)) floats."""
    return make_empty_state((batch, n_heads), head_dim, device=device)


def aaren_layer_parallel(w: AarenWeights, x: torch.Tensor, attention_fn,
                         scale: float | None = None):
    """Prefill evaluation of a full Aaren layer: (B, N, D) -> (B, N, D).

    ``attention_fn(q_heads, k, v, scale) -> ((B, N, H, d), final carry)``
    evaluates the prefix attention (``models/attention.py`` supplies the
    kernel dispatch).
    """
    if scale is None:
        scale = 1.0 / math.sqrt(w.wk.shape[-1])
    q_heads = head_queries(w)
    k, v = _project_kv(w, x)
    ctx, final = attention_fn(q_heads, k, v, scale)
    return _project_out(w, ctx), final


def aaren_layer_step(w: AarenWeights, x_t: torch.Tensor, carry: ScanState,
                     scale: float | None = None):
    """O(1) streaming evaluation: x_t (B, 1, D) -> (B, 1, D), new carry."""
    if scale is None:
        scale = 1.0 / math.sqrt(w.wk.shape[-1])
    q_heads = head_queries(w)
    k_t, v_t = _project_kv(w, x_t)
    ctx, new_carry = aaren_attention_step(q_heads, k_t, v_t, carry, scale)
    return _project_out(w, ctx), new_carry
