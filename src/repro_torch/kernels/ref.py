"""Dense oracles for the Aaren prefix scan and flash attention, with their
VJPs — the port of ``repro.kernels.ref`` (``aaren_scan_reference``,
``aaren_scan_vjp_reference``, ``aaren_scan_segmented_reference``,
``flash_reference``, ``flash_vjp_reference``, segment ids included),
written with the simplest correct torch so they double as the readable
spec.  The
flash oracles are the plain versions of B3–B5 under the JAX oracles'
signatures.  Only the tests use them.

Three more oracles pin the rounding points of the bf16 tensor-core forms
of B3, B4 and B5 (:func:`flash_attention_tc_oracle`,
:func:`flash_bwd_dq_tc_oracle`, :func:`flash_bwd_dkv_tc_oracle`): the
products of two bf16 inputs stay exact f32 sums, while ``p`` and ``dS``
are rounded to bf16 before the products that read them, as the kernels
do.  On f32 inputs they round nothing and equal the plain versions
exactly.  ``chip_smoke.py`` holds the kernels to them at a tighter bar
than the f32 plain versions; nothing on a main path calls them.
:func:`aaren_scan_chunked_reference` is B1's chunked parallel scan in
plain torch, the algebra of ``csrc/aaren_scan.cu``, and
:func:`aaren_scan_bwd_chunked_reference` B2's chunked suffix scan, the
algebra of ``csrc/aaren_scan_bwd.cu``."""

from __future__ import annotations

import math

import torch

from repro_torch.core.scan_attention import NEG_INF, combine_segmented
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


def aaren_scan_chunked_reference(s, v, m0, u0, w0, segment_starts=None, *,
                                 chunk=64):
    """B1 as ``csrc/aaren_scan.cu`` computes it: a chunked parallel scan.

    s: (R, N); v: (R, N, d); m0/u0: (R, 1); w0: (R, d); ``segment_starts``
    (R, N) bool or None.  The row is cut into chunks of ``chunk`` tokens
    (the last one short).  Each chunk is reduced from the ⊕ identity by the
    token recurrence (``m' = max(m, s_i)``, ``a = exp(m - m')``, ``b =
    exp(s_i - m')``, ``u = u a + b``, ``w = w a + b v_i``; at a flag ``m' =
    s_i, a = 0, b = 1``) to its aggregate and a "holds a start" flag; the
    carry-in is folded with the aggregates left to right by
    :func:`~repro_torch.core.scan_attention.combine_segmented`, which gives
    each chunk its exclusive carry; the token recurrence then runs again
    over each chunk from its carry.  Tokens past N are not stepped.
    Returns (o (R, N, d), m_f (R, 1), u_f (R, 1), w_f (R, d), m (R, N),
    u (R, N)): the final carry is the state after the last token.
    """
    r, n = s.shape
    d = v.shape[-1]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    s_c = torch.nn.functional.pad(s.float(), (0, pad), value=NEG_INF)
    s_c = s_c.view(r, n_chunks, chunk)
    v_c = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    v_c = v_c.view(r, n_chunks, chunk, d)
    flags = (torch.zeros((r, n), dtype=torch.bool, device=s.device)
             if segment_starts is None else segment_starts.bool())
    f_c = torch.nn.functional.pad(flags, (0, pad)).view(r, n_chunks, chunk)
    live = (torch.arange(n_chunks * chunk, device=s.device) < n).view(
        n_chunks, chunk)

    def walk(m, u, w, trace=None):
        """The token recurrence over every chunk at once from (m, u, w):
        (R, C), (R, C), (R, C, d).  Returns the states and the chunks'
        "holds a start" flags."""
        started = torch.zeros_like(m, dtype=torch.bool)
        for t in range(chunk):
            si, fi, ok = s_c[..., t], f_c[..., t], live[:, t]
            mn = torch.where(fi, si, torch.maximum(m, si))
            a = torch.where(fi, 0.0, torch.exp(m - mn))
            b = torch.where(fi, 1.0, torch.exp(si - mn))
            m = torch.where(ok, mn, m)
            u = torch.where(ok, u * a + b, u)
            w = torch.where(ok[:, None], w * a[..., None]
                            + b[..., None] * v_c[..., t, :], w)
            started = started | fi
            if trace is not None:
                trace.append((m, u, w))
        return m, u, w, started

    empty = torch.full((r, n_chunks), NEG_INF, device=s.device)
    agg = walk(empty, torch.zeros_like(empty),
               torch.zeros((r, n_chunks, d), device=s.device))
    carry = (m0[:, 0].float(), u0[:, 0].float(), w0.float(),
             torch.zeros((r,), device=s.device))
    carries = []
    for j in range(n_chunks):
        carries.append(carry[:3])
        carry = combine_segmented(carry, (agg[0][:, j], agg[1][:, j],
                                          agg[2][:, j], agg[3][:, j].float()))
    m, u, w = (torch.stack(x, dim=1) for x in zip(*carries))
    trace = []
    m, u, w, _ = walk(m, u, w, trace)
    m_all, u_all, w_all = (torch.stack(x, dim=2).flatten(1, 2)[:, :n]
                           for x in zip(*trace))
    o = w_all / torch.where(u_all == 0.0, 1.0, u_all)[..., None]
    return (o, m[:, -1:], u[:, -1:], w[:, -1], m_all, u_all)


def aaren_scan_bwd_chunked_reference(s, v, o, m, u, g, n0, g0, b0,
                                     segment_ends=None, *, chunk=32):
    """B2 as ``csrc/aaren_scan_bwd.cu`` computes it: a chunked parallel
    suffix scan.

    Arguments and returns as ``kernels.aaren_scan_bwd.aaren_scan_bwd``:
    s, m, u (R, N); v, o, g (R, N, d); the seed n0, b0 (R, 1), g0 (R, d);
    ``segment_ends`` (R, N) bool or None.  The row is cut into chunks of
    ``chunk`` tokens (the last one short).  Each chunk's aggregate from the
    ⊕ identity ``(NEG_INF, 0, 0)`` is taken in closed form: the tokens up to
    its first end (all of them without one), ``n = max(NEG_INF, -m_j)``,
    ``w_j = exp(-m_j - n)``, ``Ĝ = Σ (w_j/u_j) g_j``, ``B̂ = Σ w_j
    (g_j·o_j)/u_j`` (``1/u := 0`` where ``u == 0``), with a "holds an end"
    flag.  The seed is folded with the aggregates right to left by
    :func:`~repro_torch.core.scan_attention.combine_segmented` (an aggregate
    that holds an end replaces the carry), which gives each chunk its
    exclusive carry; the token recurrence then runs over each chunk from its
    carry, right to left (``n' = max(n, -m_j)``, ``a = exp(n - n')``, ``b =
    exp(-m_j - n')``, ``Ĝ = Ĝ a + g_j (b/u_j)``, ``B̂ = B̂ a + b
    (g_j·o_j)/u_j``; at an end flag ``n' = -m_j, a = 0``), and every token
    reads ``e = exp(s_j + n)``, ``ds_j = e (v_j·Ĝ - B̂)``, ``dv_j = e Ĝ``.
    Tokens past N are not stepped.  ``(n1, g1, b1)`` is the state after
    token 0.
    """
    r, n = s.shape
    d = v.shape[-1]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    zero = u == 0.0
    inv_u = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, u))

    def cut(x, *tail):
        x = torch.nn.functional.pad(x.float(), (0, 0) * len(tail) + (0, pad))
        return x.view(r, n_chunks, chunk, *tail)

    ln_c, iu_c, g_c = cut(-m), cut(inv_u), cut(g, d)
    lb_c = cut((g * o).sum(dim=-1) * inv_u)
    flags = (torch.zeros((r, n), dtype=torch.bool, device=s.device)
             if segment_ends is None else segment_ends.bool())
    f_c = torch.nn.functional.pad(flags, (0, pad)).view(r, n_chunks, chunk)
    live = (torch.arange(n_chunks * chunk, device=s.device) < n).view(
        n_chunks, chunk)

    # The aggregates: tokens with no end before them, under their max.
    ended_before = (torch.cumsum(f_c.int(), dim=-1) - f_c.int()) > 0
    inside = live & ~ended_before
    neg = torch.full((), NEG_INF, device=s.device)
    agg_n = torch.maximum(torch.where(inside, ln_c, neg).amax(dim=-1), neg)
    w = torch.where(inside, torch.exp(ln_c - agg_n[..., None]), 0.0)
    agg_g = ((w * iu_c)[..., None] * g_c).sum(dim=2)
    agg_b = (w * lb_c).sum(dim=-1)
    agg_f = f_c.any(dim=-1).float()

    carry = (n0[:, 0].float(), b0[:, 0].float(), g0.float(),
             torch.zeros((r,), device=s.device))
    carries = [None] * n_chunks
    for j in reversed(range(n_chunks)):
        carries[j] = carry[:3]
        carry = combine_segmented(carry, (agg_n[:, j], agg_b[:, j],
                                          agg_g[:, j], agg_f[:, j]))
    nr, br, gr = (torch.stack(x, dim=1) for x in zip(*carries))

    # The recurrence over every chunk at once, from its last token to its
    # first.
    trace = []
    for t in reversed(range(chunk)):
        li, fi, ok = ln_c[..., t], f_c[..., t], live[:, t]
        nn = torch.where(fi, li, torch.maximum(nr, li))
        a = torch.where(fi, 0.0, torch.exp(nr - nn))
        bl = torch.exp(li - nn)
        nr = torch.where(ok, nn, nr)
        br = torch.where(ok, br * a + lb_c[..., t] * bl, br)
        gr = torch.where(ok[:, None], gr * a[..., None]
                         + g_c[..., t, :] * (iu_c[..., t] * bl)[..., None],
                         gr)
        trace.append((nr, gr, br))
    n_all, g_all, b_all = (torch.stack(x[::-1], dim=2).flatten(1, 2)[:, :n]
                           for x in zip(*trace))
    e = torch.exp(s + n_all)
    ds = e * ((v * g_all).sum(dim=-1) - b_all)
    dv = e[..., None] * g_all
    return ds, dv, nr[:, :1], gr[:, 0], br[:, :1]


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
                    q_lens=None, kv_lens=None, q_segment_ids=None,
                    kv_segment_ids=None):
    """Row-wise softmax attention under causal / window / length / segment
    masks: the plain version of B3 (``flash_attention_plain``, dense torch).

    q: (B, H, Nq, d); k/v: (B, G, Nk, d), GQA-aware.  Queries at or beyond
    ``q_lens``, padding queries (segment id 0) and rows with no live key
    output 0; a pair is live only within one segment.  Returns
    (B, H, Nq, d) in q's dtype.
    """
    b, _, n_q, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    return fa.flash_attention_plain(
        q, k, v, fa._lens(q_lens, b, n_q, q.device),
        fa._lens(kv_lens, b, k.shape[2], q.device), causal=causal,
        window=window, scale=scale, q_seg=q_segment_ids,
        kv_seg=kv_segment_ids)[0]


def flash_vjp_reference(q, k, v, do, *, causal=True, window=None, scale=None,
                        q_lens=None, kv_lens=None, q_segment_ids=None,
                        kv_segment_ids=None):
    """Analytic flash-attention cotangents: the plain versions of B3, B4
    and B5 in sequence.  With ``p = softmax(mask(q kᵀ scale))`` and
    ``D_i = do_i · o_i``: ``dS = p ⊙ (do vᵀ − D)``, ``dq = dS k · scale``,
    ``dk = dSᵀ q · scale``, ``dv = pᵀ do``, group-summed for GQA.  Returns
    (dq, dk, dv) in the input dtypes.
    """
    b, _, n_q, d = q.shape
    kw = dict(causal=causal, window=window,
              scale=1.0 / math.sqrt(d) if scale is None else scale,
              q_seg=q_segment_ids, kv_seg=kv_segment_ids)
    ql = fa._lens(q_lens, b, n_q, q.device)
    kl = fa._lens(kv_lens, b, k.shape[2], q.device)
    o, lse = fa.flash_attention_plain(q, k, v, ql, kl, **kw)
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, ql, kl)
    return (fa.flash_bwd_dq_plain(*args, **kw),
            *fa.flash_bwd_dkv_plain(*args, **kw))


# The kv tile of the bf16 tensor-core forward (csrc/flash_fwd.cu, FWD_TC_BK):
# its running row max moves once per tile, and p is rounded against it.
TC_KV_TILE = 64


def flash_attention_tc_oracle(q, k, v, q_lens, kv_lens, *, causal, window,
                              scale, q_seg=None, kv_seg=None,
                              kv_tile=TC_KV_TILE):
    """B3 with the bf16 tensor-core kernel's rounding points.

    As :func:`~repro_torch.kernels.flash_attention.flash_attention_plain`,
    arguments included, except that for bf16 inputs each ``p`` is rounded
    to bf16 where the kernel rounds it: against the running row max of
    the kernel's online softmax, which takes the maximum over the kv tiles
    ``[0, kv_tile)``, ``[kv_tile, 2 kv_tile)``, ... walked so far, then
    carried to the final max in f32.  ``l`` sums the unrounded ``p``.
    Returns (o in q's dtype, lse f32)."""
    h, g = q.shape[1], k.shape[1]
    s, mask = fa._scores(q, k, q_lens, kv_lens, causal, window, scale,
                         q_seg, kv_seg)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    l_sum = e.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_sum == 0.0, 1.0, l_sum)
    if q.dtype == torch.bfloat16:
        n_k = s.shape[-1]
        tiles = -(-n_k // kv_tile)
        padded = torch.nn.functional.pad(s, (0, tiles * kv_tile - n_k),
                                         value=NEG_INF)
        tile_max = padded.unflatten(-1, (tiles, kv_tile)).amax(dim=-1)
        run = torch.cummax(tile_max, dim=-1).values
        run = run.repeat_interleave(kv_tile, dim=-1)[..., :n_k]
        e = torch.where(mask, torch.exp(s - run).to(torch.bfloat16).float()
                        * torch.exp(run - m), 0.0)
    ve = torch.repeat_interleave(v, h // g, dim=1).float()
    o = torch.einsum("bhqk,bhkd->bhqd", e / l_safe, ve)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_bwd_dq_tc_oracle(q, k, v, do, lse, delta, q_lens, kv_lens, *,
                           causal, window, scale, q_seg=None, kv_seg=None,
                           sums=torch.float32):
    """B4 with the bf16 tensor-core kernel's rounding points: as
    :func:`~repro_torch.kernels.flash_attention.flash_bwd_dq_plain`, except
    that for bf16 inputs ``dS`` is rounded to bf16 before ``dq = scale ·
    dS k``.  ``sums`` is the dtype of every sum and product: f32 (then,
    on f32 inputs, this is the plain version bit for bit) or f64, which
    leaves the rounding points alone, so that a kernel's f32 sums are all
    of its difference.  Returns dq in q's dtype."""
    h, g = q.shape[1], k.shape[1]
    if sums == torch.float32:
        _, ds = fa._p_ds(q, k, v, do, lse, delta, q_lens, kv_lens, causal,
                         window, scale, q_seg, kv_seg)
    else:
        _, mask = fa._scores(q, k, q_lens, kv_lens, causal, window, scale,
                             q_seg, kv_seg)
        ke, ve = (torch.repeat_interleave(t, h // g, dim=1).to(sums)
                  for t in (k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(sums), ke) * scale
        p = torch.where(mask, torch.exp(s - lse.to(sums)[..., None]), 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", do.to(sums), ve)
        ds = p * (dp - delta.to(sums)[..., None])
    if q.dtype == torch.bfloat16:
        ds = ds.to(torch.bfloat16).to(sums)
    ke = torch.repeat_interleave(k, h // g, dim=1).to(sums)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, ke) * scale).to(q.dtype)


def flash_bwd_dkv_tc_oracle(q, k, v, do, lse, delta, q_lens, kv_lens, *,
                            causal, window, scale, q_seg=None, kv_seg=None):
    """B5 with the bf16 tensor-core kernel's rounding points: as
    :func:`~repro_torch.kernels.flash_attention.flash_bwd_dkv_plain`,
    except that for bf16 inputs ``p`` and ``dS`` are rounded to bf16 before
    ``dv = pᵀ do`` and ``dk = scale · dSᵀ q`` (f32 sums).  Returns (dk, dv)
    in k's and v's dtypes."""
    b, h, _, d = q.shape
    g, n_k = k.shape[1], k.shape[2]
    p, ds = fa._p_ds(q, k, v, do, lse, delta, q_lens, kv_lens, causal,
                     window, scale, q_seg, kv_seg)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    dk_h = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv_h = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = dk_h.reshape(b, g, h // g, n_k, d).sum(dim=2)
    dv = dv_h.reshape(b, g, h // g, n_k, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)
