"""Attention as an RNN — the paper's ⊕ scan algebra on torch tensors.

Softmax attention for one query over context ``(k_i, v_i)`` is the ratio of
two rolling sums stabilised by a running max (paper §3.1).  A set of tokens
is summarised by the tuple ``(m, u, w)`` — max score, softmax denominator,
softmax numerator — and two summaries merge with the associative operator
``⊕`` (:func:`combine`, paper §3.2 and App. B).  This module is the port of
``repro.core.scan_attention``: the same conventions (f32 state, a finite
``NEG_INF`` sentinel, an empty state that reads out 0), so every ported
piece can be held against the JAX package.

Every evaluation strategy the paper discusses is here in plain torch, for
any device: :func:`attention_many_to_one` (Fig. 1a),
:func:`attention_recurrent` through the RNN cell :func:`scan_state_step`
(§3.1), :func:`attention_many_to_many` through the prefix scan (§3.2) and
:func:`attention_blockwise` (App. A), with
:func:`causal_attention_reference` for the Transformer's view (Fig. 1b).

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


def segment_starts_from_ids(segment_ids: torch.Tensor) -> torch.Tensor:
    """Boolean start flags from a packed row's segment ids (..., N).

    Position ``i`` starts a segment iff its id differs from position
    ``i-1``'s and is a real segment (``id != 0``: 0 is the padding id,
    whose positions are ⊕-identity leaves and never reset).  Position 0 is
    not flagged: a reset there would cut off the incoming carry, which is
    the identity for a fresh packed row and a real state when a chunked
    caller seeds the row's first document with its scanned prefix.
    """
    prev = torch.cat([segment_ids[..., :1], segment_ids[..., :-1]], dim=-1)
    return (segment_ids != prev) & (segment_ids != 0)


def combine_segmented(lhs, rhs):
    """Segmented ⊕ on flagged states ``(m, u, w, f)`` (⊕ plus a reset flag).

    ``f > 0`` marks "this operand's window contains a segment start".
    ``rhs`` is the later window: if it contains a start, ``lhs`` is dropped
    (the scan restarts at the boundary); otherwise this is :func:`combine`.
    The flag composes by OR.  Associative (Blelloch's segmented scan).
    """
    m_l, u_l, w_l, f_l = lhs
    m_r, u_r, w_r, f_r = rhs
    keep = f_r == 0.0
    m = torch.where(keep, torch.maximum(m_l, m_r), m_r)
    alpha = torch.where(keep, torch.exp(m_l - m), 0.0)
    beta = torch.exp(m_r - m)  # == 1 where the reset pinned m to m_r
    if alpha.ndim < w_l.ndim:
        alpha_w, beta_w = alpha[..., None], beta[..., None]
    else:
        alpha_w, beta_w = alpha, beta
    u = u_l * alpha + u_r * beta
    w = w_l * alpha_w + w_r * beta_w
    return m, u, w, torch.maximum(f_l, f_r)


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


def prefix_scan_segmented(leaves: ScanState, flags: torch.Tensor):
    """All-prefix states of a row of leaves, restarting at every flag.

    ``leaves``: m,u (..., N), w (..., N, d); ``flags`` (..., N) bool/float,
    nonzero at the first token of each segment.  The Hillis–Steele scan of
    :func:`prefix_scan` on :func:`combine_segmented`.  Returns ``(states,
    seen)``: position ``i`` accumulates only its own segment's prefix, and
    ``seen`` (..., N) is 1.0 once a flag has occurred at or before ``i``.
    """
    m, u, w = leaves.m[..., None], leaves.u[..., None], leaves.w
    f = flags.to(m.dtype)[..., None]
    n = m.shape[-2]
    off = 1
    while off < n:
        older = (_shifted(m, off, NEG_INF, -2), _shifted(u, off, 0.0, -2),
                 _shifted(w, off, 0.0, -2), _shifted(f, off, 0.0, -2))
        m, u, w, f = combine_segmented(older, (m, u, w, f))
        off *= 2
    return ScanState(m=m[..., 0], u=u[..., 0], w=w), f[..., 0]


def prefix_scan_states_segmented(s: torch.Tensor, v: torch.Tensor,
                                 segment_starts: torch.Tensor):
    """Per-segment all-prefix states in f32: the scan restarts at every
    start flag.  Returns ``(states, seen)`` as :func:`prefix_scan_segmented`
    (``seen`` gates an incoming carry: it folds only into positions before
    the first reset)."""
    return prefix_scan_segmented(make_leaf_state(s.float(), v.float()),
                                 segment_starts)


# ---------------------------------------------------------------------------
# The paper's evaluation strategies (§3.1–3.2, App. A) — plain torch on any
# device.  They are the reference formulations the prefix-scan kernels are
# held to; the models route every Aaren layer through
# ``kernels/ops.aaren_prefix_attention`` instead.
# ---------------------------------------------------------------------------


def scores(q: torch.Tensor, k: torch.Tensor,
           scale: float | None = None) -> torch.Tensor:
    """``s_i = q . k_i``, scaled by ``1/sqrt(d)`` unless ``scale`` is given,
    in f32.

    q: (..., d), or (..., N, d) matching k's token dim; k: (..., N, d).
    Returns (..., N).
    """
    if scale is None:
        scale = 1.0 / float(np.sqrt(k.shape[-1]))
    q, k = q.float(), k.float()
    if q.ndim == k.ndim:  # per-position queries (baselines and tests)
        s = (q * k).sum(dim=-1)
    else:  # one query vector against every position: the Aaren case
        s = (k @ q[..., None])[..., 0]
    return s * scale


def final_state(states: ScanState) -> ScanState:
    """The last position's state of all-prefix states."""
    return ScanState(m=states.m[..., -1], u=states.u[..., -1],
                     w=states.w[..., -1, :])


def fold_carry(carry: ScanState, states: ScanState) -> ScanState:
    """``carry ⊕ state_k`` at every position k of all-prefix states: the
    prefix property that lets a scan continue from an earlier one."""
    lifted = ScanState(m=carry.m[..., None].expand(states.m.shape),
                       u=carry.u[..., None].expand(states.u.shape),
                       w=carry.w[..., None, :].expand(states.w.shape))
    return combine(lifted, states)


def attention_many_to_one(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """softmax(q K^T) V for one query vector: fully parallel, O(N) memory
    (Fig. 1a).  q: (..., d), k/v: (..., N, d) -> (..., d)."""
    p = torch.softmax(scores(q, k, scale), dim=-1)
    return (p[..., None, :] @ v.to(p.dtype))[..., 0, :].to(v.dtype)


def scan_state_step(state: ScanState, s_t: torch.Tensor,
                    v_t: torch.Tensor) -> ScanState:
    """One RNN-cell update with a new token's score and value (Fig. 2):
    the constant-memory inference path of §3.3.  ``s_t`` (...,), ``v_t``
    (..., d)."""
    return combine(state, make_leaf_state(s_t, v_t))


def attention_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Token-by-token evaluation through the RNN cell, O(1) memory.

    Slow by construction (N sequential steps): the semantic anchor the
    scan and blockwise forms are tested against.  (..., d) out.
    """
    s = scores(q, k, scale)
    state = make_empty_state(tuple(s.shape[:-1]), v.shape[-1],
                             device=s.device)
    vf = v.float()
    for t in range(s.shape[-1]):
        state = scan_state_step(state, s[..., t], vf[..., t, :])
    return readout(state).to(v.dtype)


def attention_many_to_many(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """``{o_k = Attention(q, x_{1:k})}_{k=1..N}`` in parallel through the
    prefix scan (§3.2).  q: (..., d), k/v: (..., N, d) -> (..., N, d)."""
    states = prefix_scan_states(scores(q, k, scale), v)
    return readout(states).to(v.dtype)


def attention_many_to_many_with_state(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        carry: ScanState | None = None, scale: float | None = None,
        mask: torch.Tensor | None = None):
    """Prefix-scan attention that continues from an incoming carry.

    Chunked prefill at the framework level (App. A): each block of a long
    prompt folds the previous blocks' state.  ``mask`` (..., N) bool marks
    the valid positions; the rest enter as ⊕-identity leaves, so a
    fixed-shape chunk can hold a shorter effective length.  Returns
    (outputs (..., N, d), final ScanState).
    """
    s = scores(q, k, scale)
    if mask is not None:
        s, v = mask_to_identity(s, v, mask)
    states = prefix_scan_states(s, v)
    if carry is not None:
        states = fold_carry(carry, states)
    return readout(states).to(v.dtype), final_state(states)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int,
                        scale: float | None = None) -> torch.Tensor:
    """All-prefix outputs block by block with an O(b) working set (App. A).

    The same function as :func:`attention_many_to_many`: the sequence goes
    in blocks of ``block_size`` tokens, each scanned on its own and folded
    into the carry of the blocks before it.  ``N`` must be a multiple of
    ``block_size``.
    """
    n = k.shape[-2]
    if n % block_size:
        raise ValueError(f"N={n} not divisible by block_size={block_size}")
    s = scores(q, k, scale)
    vf = v.float()
    carry = make_empty_state(tuple(s.shape[:-1]), v.shape[-1],
                             device=s.device)
    outs = []
    for lo in range(0, n, block_size):
        states = fold_carry(carry, prefix_scan_states(
            s[..., lo:lo + block_size], vf[..., lo:lo + block_size, :]))
        carry = final_state(states)
        outs.append(readout(states))
    return torch.cat(outs, dim=-2).to(v.dtype)


def causal_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               scale: float | None = None) -> torch.Tensor:
    """Row-wise causal softmax attention ``o_k = Attention(q_k, x_{1:k})``:
    a Transformer's causal attention through the RNN view (Fig. 1b).
    q/k/v: (..., N, d) -> (..., N, d); O(N²)."""
    if scale is None:
        scale = 1.0 / float(np.sqrt(k.shape[-1]))
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    n = s.shape[-1]
    keep = torch.ones((n, n), dtype=torch.bool, device=s.device).tril()
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.to(p.dtype)).to(v.dtype)
