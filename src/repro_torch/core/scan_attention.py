"""Attention as an RNN — the paper's ⊕ scan algebra on torch tensors.

Softmax attention for one query over context ``(k_i, v_i)`` is the ratio of
two rolling sums stabilised by a running max (paper §3.1).  A set of tokens
is summarised by the tuple ``(m, u, w)`` — max score, softmax denominator,
softmax numerator — and two summaries merge with the associative operator
``⊕`` (:func:`combine`, paper §3.2 and App. B).  This module is the port of
``repro.core.scan_attention``: the same conventions (f32 state, a finite
``NEG_INF`` sentinel, an empty state that reads out 0), so every ported
piece can be held against the JAX package.

Layout: scores ``(..., N)``, values ``(..., N, d)``; a state has ``m, u``
of shape ``(...,)`` and ``w`` of shape ``(..., d)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Large-but-finite "minus infinity".  ``exp(NEG_INF - m)`` underflows to an
# exact 0.0 without ever producing ``(-inf) - (-inf) = nan`` when two empty
# states are combined.  -0.7 * f32_max keeps headroom for additions.
NEG_INF = -0.7 * float(np.finfo(np.float32).max)


class ScanState(NamedTuple):
    """The 3-tuple the paper's associative operator acts on (App. B).

    ``m``: running max of scores over the index set            (...,)
    ``u``: sum of exp(s_i - m)   — the softmax denominator     (...,)
    ``w``: sum of exp(s_i - m) v_i — the softmax numerator     (..., d)
    """

    m: torch.Tensor
    u: torch.Tensor
    w: torch.Tensor


def make_empty_state(batch_shape: tuple, d: int, *, device,
                     dtype=torch.float32) -> ScanState:
    """Identity element of ``⊕``: the state of the empty index set."""
    return ScanState(
        m=torch.full(batch_shape, NEG_INF, dtype=dtype, device=device),
        u=torch.zeros(batch_shape, dtype=dtype, device=device),
        w=torch.zeros(batch_shape + (d,), dtype=dtype, device=device),
    )


def make_leaf_state(s: torch.Tensor, v: torch.Tensor) -> ScanState:
    """The per-token leaf ``(m,u,w)_{ {i} } = (s_i, 1, v_i)`` (paper §3.2)."""
    return ScanState(m=s, u=torch.ones_like(s), w=v.to(s.dtype))


def mask_to_identity(s: torch.Tensor, v: torch.Tensor, mask: torch.Tensor):
    """Turn masked-out positions into ⊕-identity leaves.

    ``mask`` broadcasts against ``s`` (..., N); masked positions get
    ``s = NEG_INF`` (so ``exp(s - m)`` underflows to exact 0) and ``v = 0``.
    Returns (s, v).
    """
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                        device=s.device))
    v = torch.where(mask[..., None], v, torch.zeros((), dtype=v.dtype,
                                                    device=v.device))
    return s, v


def combine(lhs: ScanState, rhs: ScanState) -> ScanState:
    """The paper's associative operator ``⊕``; ``lhs`` is the earlier set.

        m = max(m_A, m_B)
        u = u_A exp(m_A - m) + u_B exp(m_B - m)
        w = w_A exp(m_A - m) + w_B exp(m_B - m)

    ``m``/``u`` are either ``(...,)`` against ``w (..., d)`` or the lifted
    ``(..., N, 1)`` layout against ``w (..., N, d)``.
    """
    m = torch.maximum(lhs.m, rhs.m)
    alpha = torch.exp(lhs.m - m)  # in [0, 1]; exactly 0 for the empty state
    beta = torch.exp(rhs.m - m)
    u = lhs.u * alpha + rhs.u * beta
    if alpha.ndim < lhs.w.ndim:
        alpha, beta = alpha[..., None], beta[..., None]
    w = lhs.w * alpha + rhs.w * beta
    return ScanState(m=m, u=u, w=w)


def readout(state: ScanState) -> torch.Tensor:
    """Attention output ``o = w / u``; the empty state (``u == 0``) reads 0.

    ``w`` is exactly 0 wherever ``u`` is, so guarding the denominator alone
    suffices; for any non-empty state the result is bit-identical to
    ``w / u``.
    """
    safe_u = torch.where(state.u == 0.0, torch.ones_like(state.u), state.u)
    return state.w / safe_u[..., None]


def _shifted(x: torch.Tensor, off: int, fill: float, dim: int) -> torch.Tensor:
    """x[..., i, ...] -> x[..., i - off, ...] with ``fill`` for i < off."""
    pad_shape = list(x.shape)
    pad_shape[dim] = off
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x.narrow(dim, 0, x.shape[dim] - off)], dim=dim)


def prefix_scan(leaves: ScanState) -> ScanState:
    """All-prefix ⊕ states of a row of leaf states, in their dtype.

    ``leaves``: m,u (..., N), w (..., N, d).  A log-step Hillis–Steele scan
    (the paper's Algorithm 1): at step ``off`` every position folds in the
    state ``off`` places to its left, with the ⊕ identity shifted in at the
    edge.  Returns m,u (..., N) and w (..., N, d).
    """
    m, u, w = leaves.m[..., None], leaves.u[..., None], leaves.w
    n = m.shape[-2]
    off = 1
    while off < n:
        older = ScanState(m=_shifted(m, off, NEG_INF, -2),
                          u=_shifted(u, off, 0.0, -2),
                          w=_shifted(w, off, 0.0, -2))
        m, u, w = combine(older, ScanState(m=m, u=u, w=w))
        off *= 2
    return ScanState(m=m[..., 0], u=u[..., 0], w=w)


def prefix_scan_states(s: torch.Tensor, v: torch.Tensor) -> ScanState:
    """All-prefix states ``{(m_k, u_k, w_k)}_{k=1..N}`` in f32.

    s: (..., N) scores, v: (..., N, d) values -> ScanState with m,u (..., N)
    and w (..., N, d): :func:`prefix_scan` of the leaves ``(s_i, 1, v_i)``.
    """
    return prefix_scan(make_leaf_state(s.float(), v.float()))
