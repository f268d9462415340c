"""The kernel boundaries of the two mixers: ``aaren_prefix_attention``
(Aaren) and ``flash_mha`` (softmax attention).

Port of ``repro.kernels.ops.aaren_prefix_attention`` and ``flash_mha`` with
their custom VJPs.  Every Aaren prefill, chunk, decode and training pass
reaches the prefix-scan kernels through here, and every softmax forward the
flash kernels.  Dispatch is by device, inside the kernel wrappers: a CPU
tensor takes the plain torch versions, a CUDA tensor the CUDA kernels.

Gradients go through one ``torch.autograd.Function`` for both devices, with
the JAX package's residual contract: the forward runs the scan with
``return_residuals`` and saves ``(s, v, o, m, u)`` plus the final and
incoming carries; the backward runs the reverse scan ``aaren_scan_bwd``
seeded with ``(-m_f, g_{w_f}, -g_{u_f})`` and finishes with
:func:`aaren_bwd_epilogue`.  A call that needs no gradient (serving) runs
the scan without residuals; packed rows (``segment_ids``) run the segmented
forms of both scans.  ``FlashAttention`` does the same for softmax
attention: its forward saves ``(q, k, v, o, lse)`` and its backward runs
the dq and dk/dv passes.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.scan_attention import (
    NEG_INF,
    ScanState,
    mask_to_identity,
    segment_starts_from_ids,
)
from repro_torch.kernels.aaren_scan import aaren_scan
from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
)


def aaren_bwd_epilogue(s, m0, u0, w0, m_f, u_f, w_f, g_m, g_u, g_w,
                       ds, n1, g1, b1, hit_mask=None):
    """Elementwise epilogue of the fused Aaren backward.

    Turns the reverse scan's final state ``(n1, g1, b1)`` into the
    incoming-carry cotangents and adds the max-subgradient of the ``m_f``
    output to ``ds``, split across exact ties the way autodiff's
    balanced-eq rule does.  ``hit_mask`` (segmented scans only) restricts
    the tie detector to the last segment — the span ``m_f`` is the max of.
    A line-for-line port of the JAX package's epilogue; plain torch on both
    devices.  Returns (ds, dm0, du0, dw0).
    """
    e01 = torch.exp(m0 + n1)                     # exp(m0 - M_N-ish), <= 1
    dw0 = e01 * g1
    du0 = -e01 * b1
    c = g_m - g_u * u_f - (g_w * w_f).sum(dim=-1, keepdim=True)
    hit_s = (s == m_f).to(s.dtype)
    if hit_mask is not None:
        hit_s = hit_s * hit_mask
    hit_0 = (m0 == m_f).to(s.dtype)
    cnt = hit_s.sum(dim=-1, keepdim=True) + hit_0
    c = c / torch.clamp(cnt, min=1.0)
    ds = ds + c * hit_s
    dm0 = u0 * du0 + (w0 * dw0).sum(dim=-1, keepdim=True) + c * hit_0
    return ds, dm0, du0, dw0


def _segment_ends(starts):
    """Reverse-scan boundary flags: the forward's starts shifted left one.

    Token ``j`` ends its segment iff ``j + 1`` starts one; a row's last
    token is never flagged, so the final-carry cotangents flow back through
    padding into the last real segment, as the forward carries through it.
    """
    return torch.nn.functional.pad(starts[:, 1:], (0, 1)).contiguous()


def _in_last_segment(starts):
    """(R, N) 1.0 where no segment start occurs strictly after the position:
    the span ``m_f`` is the max of, so its subgradient routes only there."""
    future = torch.cummax(starts.flip(-1).to(torch.int32), dim=-1).values
    return (_segment_ends(future.flip(-1)) == 0).float()


class AarenScan(torch.autograd.Function):
    """(s, v, m0, u0, w0, starts) -> (o, m_f, u_f, w_f) with the analytic
    backward.

    All inputs f32 and contiguous, shapes as :func:`aaren_scan`; ``starts``
    None or its (R, N) bool segment-start flags.  Unused outputs arrive in
    the backward as zeros (``materialize_grads``), so the seed is then
    ``(-m_f, 0, 0)``.
    """

    @staticmethod
    def forward(ctx, s, v, m0, u0, w0, starts):
        o, m_f, u_f, w_f, m_all, u_all = aaren_scan(
            s, v, m0, u0, w0, segment_starts=starts, return_residuals=True)
        ctx.save_for_backward(s, v, o, m_all, u_all, m_f, u_f, w_f, m0, u0,
                              w0, starts)
        return o, m_f, u_f, w_f

    @staticmethod
    def backward(ctx, g_o, g_m, g_u, g_w):
        (s, v, o, m_all, u_all, m_f, u_f, w_f, m0, u0, w0,
         starts) = ctx.saved_tensors
        g_u = g_u.contiguous()
        g_w = g_w.contiguous()
        ends = hit_mask = None
        if starts is not None:
            ends = _segment_ends(starts)
            hit_mask = _in_last_segment(starts)
        # (u_f, w_f) cotangents seed the reverse carry (a suffix "past" token
        # N); see kernels/aaren_scan_bwd.py.
        ds, dv, n1, g1, b1 = aaren_scan_bwd(
            s, v, o, m_all, u_all, g_o.contiguous(), -m_f, g_w, -g_u,
            segment_ends=ends)
        ds, dm0, du0, dw0 = aaren_bwd_epilogue(
            s, m0, u0, w0, m_f, u_f, w_f, g_m, g_u, g_w, ds, n1, g1, b1,
            hit_mask=hit_mask)
        return ds, dv, dm0, du0, dw0, None


def aaren_prefix_attention(s, v, carry: ScanState | None = None, *,
                           segment_ids=None, segment_starts=None):
    """All-prefix Aaren attention over arbitrary leading batch dims.

    s: (..., N) scores; v: (..., N, d) values; carry leaves: m,u (...,),
    w (..., d).  Returns (o: (..., N, d) in v's dtype, final carry
    ScanState in f32).  Differentiable in s, v and the carry.

    Packed rows: ``segment_ids`` (int, id 0 = padding; shape (..., N) or
    missing one leading dim, e.g. (B, N) against (B, H, N) scores) restarts
    the scan at every segment start; padding enters as ⊕-identity leaves
    and reads 0.  Ids must form contiguous same-id runs per row (the
    packer's contract).  ``segment_starts`` overrides the start flags
    computed from the ids.  An incoming ``carry`` reaches exactly the
    positions before a row's first start; the final carry is the last
    segment's state (padding never resets it).
    """
    batch_shape = tuple(s.shape[:-1])
    n = s.shape[-1]
    d = v.shape[-1]
    r = math.prod(batch_shape)
    starts2 = pad_mask = None
    if segment_ids is not None or segment_starts is not None:
        if segment_ids is not None:
            seg = torch.as_tensor(segment_ids, device=s.device)
            if seg.ndim == s.ndim - 1:      # e.g. (B, N) against (B, H, N)
                seg = seg.unsqueeze(-2)
            seg = seg.expand(s.shape)
            # Padding (id 0) enters as ⊕-identity leaves: the scan carries
            # the last segment's state through it, and its outputs are
            # pinned to 0 below.
            pad_mask = seg != 0
            s, v = mask_to_identity(s, v, pad_mask)
        if segment_starts is None:
            segment_starts = segment_starts_from_ids(seg)
        starts = torch.as_tensor(segment_starts, device=s.device) != 0
        if starts.ndim == s.ndim - 1:
            starts = starts.unsqueeze(-2)
        starts2 = starts.expand(s.shape).reshape(r, n).contiguous()
    s2 = s.reshape(r, n).float().contiguous()
    v2 = v.reshape(r, n, d).float().contiguous()
    if carry is None:
        m0 = torch.full((r, 1), NEG_INF, device=s.device)
        u0 = torch.zeros((r, 1), device=s.device)
        w0 = torch.zeros((r, d), device=s.device)
    else:
        m0 = carry.m.reshape(r, 1).float().contiguous()
        u0 = carry.u.reshape(r, 1).float().contiguous()
        w0 = carry.w.reshape(r, d).float().contiguous()
    args = (s2, v2, m0, u0, w0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        o, m_f, u_f, w_f = AarenScan.apply(*args, starts2)
    else:
        o, m_f, u_f, w_f = aaren_scan(*args, segment_starts=starts2)
    if pad_mask is not None:
        o = torch.where(pad_mask.reshape(r, n, 1), o, 0.0)
    final = ScanState(m=m_f.reshape(batch_shape), u=u_f.reshape(batch_shape),
                      w=w_f.reshape(batch_shape + (d,)))
    return o.reshape(batch_shape + (n, d)).to(v.dtype), final


class FlashAttention(torch.autograd.Function):
    """(q, k, v) -> o in the kernels' (B, H, N, d) layout, with the analytic
    backward from the residuals ``(q, k, v, o, lse)`` — the contract of the
    JAX package's ``_flash_fwd``."""

    @staticmethod
    def forward(ctx, q, k, v, q_lens, kv_lens, causal, window, scale):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, q_lens=q_lens, kv_lens=kv_lens,
                                 return_residuals=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.lens = (q_lens, kv_lens)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=causal, window=window,
            scale=scale, q_lens=ctx.lens[0], kv_lens=ctx.lens[1])
        return dq, dk, dv, None, None, None, None, None


def flash_mha(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None, q_lens=None, kv_lens=None,
              q_segment_ids=None, kv_segment_ids=None):
    """Flash attention over (B, Nq, H, d) q and (B, Nk, G, d) k/v.

    The model's layout is sequence-major; the kernels want head-major
    (B, H, N, d), so the boundary transposes.  ``q_lens``/``kv_lens``:
    optional (B,) true lengths, masked inside the kernels and their
    backward.  Differentiable in q, k and v; a call that needs no gradient
    (prefill) runs the forward kernel without its ``lse`` residual.
    Returns (B, Nq, H, d).
    """
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError(
            "packed sequences through flash attention (segment ids) come "
            "with ROADMAP queue A item 7b (A7b)")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o = FlashAttention.apply(qt, kt, vt, q_lens, kv_lens, causal, window,
                                 float(scale))
    else:
        o = flash_attention(qt, kt, vt, causal=causal, window=window,
                            scale=scale, q_lens=q_lens, kv_lens=kv_lens)
    return o.transpose(1, 2)
