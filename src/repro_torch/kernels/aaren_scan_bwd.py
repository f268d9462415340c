"""Aaren prefix-scan attention, backward: the CUDA kernel, its plain version
and the wrapper that picks between them by device.

Port of the Pallas TPU kernel ``repro.kernels.aaren_scan_bwd.aaren_scan_bwd``,
plain and segmented.  From the forward's residuals ``(o, m_i, u_i)`` and the
output cotangent ``g`` it computes, per row of ``R = B·H``,

    ds_j = e^{s_j - M_j} (v_j · G_j - B_j),   dv_j = e^{s_j - M_j} G_j
    G_j  = Σ_{i>=j} g_i / U_i,                B_j  = Σ_{i>=j} (g_i · o_i) / U_i

as a right-to-left scan of the paper's ⊕ on ``(n = -M, Ĝ, B̂)`` seeded with
the reverse carry ``(n0, g0, b0) = (-m_f, g_{w_f}, -g_{u_f})``, and returns
the full-suffix state ``(n1, g1, b1)`` that ``ops.aaren_bwd_epilogue`` turns
into the incoming-carry cotangents.  Packed rows pass ``segment_ends``
(R, N) bool, the forward's start flags shifted left one: the suffix then
stops at every end flag, so the seed reaches only the last segment and
``(n1, g1, b1)`` covers only the first.

* :func:`aaren_scan_bwd_plain` — the suffix scan in plain torch: the leaves
  reversed, ``prefix_scan``, reversed back, the seed folded in.
* The kernel — ``csrc/aaren_scan_bwd.cu``, a chunked parallel suffix scan
  (design and bound in its header; ``ref.aaren_scan_bwd_chunked_reference``
  is its algebra in plain torch), built by ``kernels/build.py`` at first
  launch.
* :func:`aaren_scan_bwd` — the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises.  Nothing falls back.
  ``aaren_scan_bwd.n_launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.scan_attention import (
    ScanState,
    combine,
    combine_segmented,
    prefix_scan,
    prefix_scan_segmented,
)
from repro_torch.kernels import build


def aaren_scan_bwd_plain(s, v, o, m, u, g, n0, g0, b0, *, segment_ends=None):
    """(ds (R,N), dv (R,N,d), n1 (R,1), g1 (R,d), b1 (R,1)) in plain torch."""
    # u == 0 only at empty-state positions (padding before any real token,
    # whose g is 0): zeroing 1/u there keeps them inert, as in the JAX kernel.
    zero = u == 0.0
    inv_u = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, u))
    leaves = ScanState(m=-m, u=(g * o).sum(dim=-1) * inv_u,
                       w=g * inv_u[..., None])
    flipped = ScanState(*(t.flip(1) for t in leaves))
    if segment_ends is None:
        suffix = ScanState(*(t.flip(1) for t in prefix_scan(flipped)))
    else:  # reversed, the end flags start the reversed segments
        suffix, seen = prefix_scan_segmented(flipped, segment_ends.flip(1))
        suffix = ScanState(*(t.flip(1) for t in suffix))
        seen = seen.flip(1)
    seed = ScanState(m=n0.expand_as(suffix.m), u=b0.expand_as(suffix.u),
                     w=g0[:, None, :].expand_as(suffix.w))
    if segment_ends is None:
        total = combine(seed, suffix)
    else:  # the seed folds only into positions after the last end flag
        total = ScanState(*combine_segmented(
            (*seed, torch.zeros_like(seen)), (*suffix, seen))[:3])
    # total.m is -M_j (M is non-decreasing), so e = exp(s_j - M_j) <= 1.
    e = torch.exp(s + total.m)
    ds = e * ((v * total.w).sum(dim=-1) - total.u)
    dv = e[..., None] * total.w
    return (ds, dv, total.m[:, :1].contiguous(), total.w[:, 0, :].contiguous(),
            total.u[:, :1].contiguous())


def _check(s, v, o, m, u, g, n0, g0, b0, segment_ends):
    if s.ndim != 2 or v.ndim != 3:
        raise ValueError(f"aaren_scan_bwd wants s (R, N) and v (R, N, d); got "
                         f"{tuple(s.shape)} and {tuple(v.shape)}")
    r, n = s.shape
    d = v.shape[-1]
    want = {"s": (r, n), "v": (r, n, d), "o": (r, n, d), "m": (r, n),
            "u": (r, n), "g": (r, n, d), "n0": (r, 1), "g0": (r, d),
            "b0": (r, 1)}
    for name, t in zip(want, (s, v, o, m, u, g, n0, g0, b0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"aaren_scan_bwd: {name} has shape "
                             f"{tuple(t.shape)}, want {want[name]}")
        if t.dtype != torch.float32:
            raise ValueError(f"aaren_scan_bwd: {name} is {t.dtype}, want "
                             "float32")
        if t.device != s.device:
            raise ValueError(f"aaren_scan_bwd: {name} is on {t.device}, s on "
                             f"{s.device}")
        if not t.is_contiguous():
            raise ValueError(f"aaren_scan_bwd: {name} is not contiguous")
    if r == 0 or n == 0 or d == 0:
        raise ValueError(f"aaren_scan_bwd: empty shape R={r}, N={n}, d={d}")
    f = segment_ends
    if f is not None and (tuple(f.shape) != (r, n) or f.dtype != torch.bool
                          or f.device != s.device or not f.is_contiguous()):
        raise ValueError(f"aaren_scan_bwd: segment_ends must be a contiguous "
                         f"bool ({r}, {n}) tensor on {s.device}; got "
                         f"{f.dtype} {tuple(f.shape)} on {f.device}")


@functools.cache
def _library():
    lib = build.load("aaren_scan_bwd")
    lib.aaren_scan_bwd.argtypes = ([ctypes.c_void_p] * 15
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.aaren_scan_bwd.restype = ctypes.c_int
    lib.aaren_scan_bwd_max_d.argtypes = []
    lib.aaren_scan_bwd_max_d.restype = ctypes.c_int
    lib.aaren_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.aaren_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch(s, v, o, m, u, g, n0, g0, b0, segment_ends):
    lib = _library()
    r, n = s.shape
    d = v.shape[-1]
    if d > lib.aaren_scan_bwd_max_d():
        raise ValueError(f"aaren_scan_bwd kernel takes d <= "
                         f"{lib.aaren_scan_bwd_max_d()}, got {d}")
    ds, dv = torch.empty_like(s), torch.empty_like(v)
    n1, g1, b1 = (torch.empty_like(n0), torch.empty_like(g0),
                  torch.empty_like(b0))
    # A bool tensor's bytes are the kernel's uint8 flags (0 or 1).
    ends_ptr = None if segment_ends is None else segment_ends.data_ptr()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.aaren_scan_bwd(
            *(t.data_ptr() for t in (s, v, o, m, u, g, n0, g0, b0)),
            ends_ptr, *(t.data_ptr() for t in (ds, dv, n1, g1, b1)), r, n,
            d, stream)
    if err:
        raise RuntimeError("aaren_scan_bwd kernel launch failed: "
                           + lib.aaren_scan_bwd_error_string(err).decode())
    build.count_launch(aaren_scan_bwd)
    return ds, dv, n1, g1, b1


def aaren_scan_bwd(s, v, o, m, u, g, n0, g0, b0, *, segment_ends=None):
    """Fused reverse scan: per-token cotangents + final reverse carry.

    s: (R, N); v/o/g: (R, N, d); m/u: (R, N) forward residuals; the seed
    n0/b0: (R, 1), g0: (R, d) — ``(-m_f, g_{w_f}, -g_{u_f})`` — all
    float32, contiguous, on one device.  ``segment_ends``: optional (R, N)
    contiguous bool flags, True at the last token of each packed segment
    that has a successor.  Returns (ds: (R, N), dv: (R, N, d), n1: (R, 1),
    g1: (R, d), b1: (R, 1)).
    """
    _check(s, v, o, m, u, g, n0, g0, b0, segment_ends)
    if s.device.type == "cpu":
        return aaren_scan_bwd_plain(s, v, o, m, u, g, n0, g0, b0,
                                    segment_ends=segment_ends)
    if s.device.type == "cuda":
        return _launch(s, v, o, m, u, g, n0, g0, b0, segment_ends)
    raise ValueError(f"aaren_scan_bwd runs on cpu or cuda, not {s.device}")


aaren_scan_bwd.n_launches = 0
