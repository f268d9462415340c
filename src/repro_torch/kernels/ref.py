"""Dense oracles for the Aaren prefix scan and flash attention, with their
VJPs — the port of ``repro.kernels.ref`` (``aaren_scan_reference``,
``aaren_scan_vjp_reference``, ``aaren_scan_segmented_reference``,
``flash_reference``, ``flash_vjp_reference``; flash's segment ids come
with ROADMAP item A7b), written
with the simplest correct torch so they double as the readable spec.  The
flash oracles are the plain versions of B3–B5 under the JAX oracles'
signatures.  Only the tests use them."""

from __future__ import annotations

import math

import torch

from repro_torch.core.scan_attention import NEG_INF
from repro_torch.kernels import flash_attention as fa


def aaren_scan_reference(s, v, m0=None, u0=None, w0=None):
    """All-prefix softmax attention from scores, with optional carry.

    s: (R, N); v: (R, N, d); m0/u0: (R, 1); w0: (R, d).
    Returns (o: (R, N, d), m_f: (R, 1), u_f: (R, 1), w_f: (R, d)).

    Direct O(N^2) evaluation: o_i = softmax(s_{1:i} ∪ carry) · (v_{1:i} ∪ w).
    The carry enters as one pseudo-token with score ``m0`` and "value"
    ``w0 / u0`` weighted by ``u0`` — i.e. exactly the ⊕ fold.
    """
    r, n = s.shape
    s = s.float()
    v = v.float()
    dev = s.device
    if m0 is None:
        m0 = torch.full((r, 1), NEG_INF, device=dev)
        u0 = torch.zeros((r, 1), device=dev)
        w0 = torch.zeros((r, v.shape[-1]), device=dev)
    neg = torch.full((), NEG_INF, device=dev)

    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))
    s_ij = torch.where(mask[None], s[:, None, :], neg)          # (R, N, N)
    m_pref = torch.maximum(s_ij.amax(dim=-1), m0)               # (R, N)
    p = torch.exp(torch.where(mask[None], s_ij - m_pref[..., None], neg))
    carry_w = torch.exp(m0 - m_pref) * u0                       # (R, N)
    u = p.sum(dim=-1) + carry_w
    u0_safe = torch.where(u0 == 0.0, torch.ones_like(u0), u0)
    w = torch.einsum("rij,rjd->rid", p, v) + carry_w[..., None] * (
        w0[:, None, :] / u0_safe[..., None])
    o = w / u[..., None]
    return o, m_pref[:, -1:], u[:, -1:], w[:, -1, :]


def aaren_scan_vjp_reference(s, v, m0, u0, w0, g_o, g_m, g_u, g_w):
    """Analytic cotangents of :func:`aaren_scan_reference`, densely.

    Direct O(N^2) evaluation of the formulas the fused backward kernel
    implements as a suffix scan: with prefix max/denominator residuals
    ``(M_i, U_i)`` and ``p_ij = exp(s_j - M_i)/U_i``,

        ds_j  = Σ_{i>=j} p_ij (g_i · (v_j - o_i))  +  seed + max terms
        dv_j  = Σ_{i>=j} p_ij g_i                  +  seed term

    Seed terms carry the (u_f, w_f) cotangents; the ``max`` subgradient of
    ``m_f`` routes ``C = g_m - g_u u_f - g_w·w_f`` to the arg-max score.
    Returns (ds, dv, dm0, du0, dw0).
    """
    r, n = s.shape
    s, v = s.float(), v.float()
    m0, u0, w0 = m0.float(), u0.float(), w0.float()
    g_o, g_m, g_u, g_w = (g.float() for g in (g_o, g_m, g_u, g_w))
    dev = s.device

    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))
    m_pref = torch.maximum(torch.cummax(s, dim=1).values, m0)   # (R, N) = M_i
    e = torch.where(mask[None], torch.exp(s[:, None, :] - m_pref[..., None]),
                    torch.zeros((), device=dev))
    e0 = torch.exp(m0 - m_pref)                                 # (R, N): carry
    u = e.sum(dim=-1) + e0 * u0                                 # (R, N) = U_i
    p = e / u[..., None]                                        # (R, N, N)
    u0_safe = torch.where(u0 == 0.0, torch.ones_like(u0), u0)
    o = (torch.einsum("rij,rjd->rid", p, v)
         + (e0 * u0 / u)[..., None] * (w0[:, None, :] / u0_safe[..., None]))
    m_f, u_f = m_pref[:, -1:], u[:, -1:]

    gdotv = torch.einsum("rid,rjd->rij", g_o, v)                # g_i · v_j
    gdoto = (g_o * o).sum(dim=-1)                               # g_i · o_i
    e_n = torch.exp(s - m_f)                                  # exp(s_j - M_N)
    ds = torch.einsum("rij->rj", p * (gdotv - gdoto[..., None]))
    ds = ds + e_n * (torch.einsum("rjd,rd->rj", v, g_w) + g_u)
    dv = (torch.einsum("rij,rid->rjd", p, g_o)
          + e_n[..., None] * g_w[:, None, :])

    # Incoming-carry cotangents.
    q0 = e0 / u                                                 # (R, N)
    dw0 = torch.einsum("ri,rid->rd", q0, g_o) + torch.exp(m0 - m_f) * g_w
    du0 = (-(q0 * gdoto).sum(dim=-1, keepdim=True)
           + torch.exp(m0 - m_f) * g_u)
    # max subgradient of m_f, split across exact ties like autodiff.
    w_f = (torch.einsum("rj,rjd->rd", e[:, -1, :], v)
           + (e0[:, -1:] * u0) * (w0 / u0_safe))
    c = g_m - g_u * u_f - (g_w * w_f).sum(dim=-1, keepdim=True)
    hit_s = (s == m_f).float()
    hit_0 = (m0 == m_f).float()
    cnt = hit_s.sum(dim=-1, keepdim=True) + hit_0
    c = c / torch.clamp(cnt, min=1.0)
    ds = ds + c * hit_s
    dm0 = u0 * du0 + (w0 * dw0).sum(dim=-1, keepdim=True) + c * hit_0
    return ds, dv, dm0, du0, dw0


def aaren_scan_segmented_reference(s, v, segment_ids):
    """All-prefix softmax attention restarting at every segment (densely).

    s: (R, N); v: (R, N, d); segment_ids: (R, N) int — id 0 is padding.
    Position ``i`` attends ``{j <= i : seg_j == seg_i != 0}`` (its own
    document's prefix); padding positions attend nothing and read 0.
    Returns (o: (R, N, d), m_f: (R, 1), u_f: (R, 1), w_f: (R, d)), the
    finals being the state at the row's last real position — the last
    segment's, as the segmented scan leaves it (padding never resets).
    """
    r, n = s.shape
    s, v = s.float(), v.float()
    dev = s.device
    seg = segment_ids.to(device=dev, dtype=torch.int64)
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
    mask = causal[None] & same                                  # (R, N, N)
    neg = torch.full((), NEG_INF, device=dev)
    s_ij = torch.where(mask, s[:, None, :], neg)
    m_pref = s_ij.amax(dim=-1)                                  # (R, N)
    p = torch.where(mask, torch.exp(s_ij - m_pref[..., None]),
                    torch.zeros((), device=dev))
    u = p.sum(dim=-1)
    w = torch.einsum("rij,rjd->rid", p, v)
    o = w / torch.where(u == 0.0, torch.ones_like(u), u)[..., None]
    pos = torch.arange(n, device=dev)[None, :].expand(r, n)
    last = torch.where(seg != 0, pos, -1).argmax(dim=-1)        # (R,)
    rows = torch.arange(r, device=dev)
    return (o, m_pref[rows, last][:, None], u[rows, last][:, None],
            w[rows, last])


def flash_reference(q, k, v, *, causal=True, window=None, scale=None,
                    q_lens=None, kv_lens=None):
    """Row-wise softmax attention under causal / window / length masks:
    the plain version of B3 (``flash_attention_plain``, dense torch).

    q: (B, H, Nq, d); k/v: (B, G, Nk, d), GQA-aware.  Queries at or beyond
    ``q_lens`` and rows with no live key output 0.  Returns (B, H, Nq, d)
    in q's dtype.
    """
    b, _, n_q, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    return fa.flash_attention_plain(
        q, k, v, fa._lens(q_lens, b, n_q, q.device),
        fa._lens(kv_lens, b, k.shape[2], q.device), causal=causal,
        window=window, scale=scale)[0]


def flash_vjp_reference(q, k, v, do, *, causal=True, window=None, scale=None,
                        q_lens=None, kv_lens=None):
    """Analytic flash-attention cotangents: the plain versions of B3, B4
    and B5 in sequence.  With ``p = softmax(mask(q kᵀ scale))`` and
    ``D_i = do_i · o_i``: ``dS = p ⊙ (do vᵀ − D)``, ``dq = dS k · scale``,
    ``dk = dSᵀ q · scale``, ``dv = pᵀ do``, group-summed for GQA.  Returns
    (dq, dk, dv) in the input dtypes.
    """
    b, _, n_q, d = q.shape
    kw = dict(causal=causal, window=window,
              scale=1.0 / math.sqrt(d) if scale is None else scale)
    ql = fa._lens(q_lens, b, n_q, q.device)
    kl = fa._lens(kv_lens, b, k.shape[2], q.device)
    o, lse = fa.flash_attention_plain(q, k, v, ql, kl, **kw)
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, ql, kl)
    return (fa.flash_bwd_dq_plain(*args, **kw),
            *fa.flash_bwd_dkv_plain(*args, **kw))
