"""Dense oracle for the Aaren prefix scan — the port of
``repro.kernels.ref.aaren_scan_reference``, written with the simplest
correct torch (no scan tricks) so it doubles as the readable spec."""

from __future__ import annotations

import torch

from repro_torch.core.scan_attention import NEG_INF


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
