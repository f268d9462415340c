"""Aaren prefix-scan attention, forward: the CUDA kernel, its plain version
and the wrapper that picks between them by device.

Port of the Pallas TPU kernel ``repro.kernels.aaren_scan.aaren_scan``,
with carry, plain and segmented.  Per row of ``R = B·H`` it computes every
causal prefix-softmax output

    o_i = Σ_{j<=i} exp(s_j - m_i) v_j / Σ_{j<=i} exp(s_j - m_i)

with the carry ``(m0, u0, w0)`` folded in first, and returns the final
carry so chunked prefill and streaming decode continue where it stopped.
With ``return_residuals`` it also returns the running max and denominator
``(m_i, u_i)`` after every token, which the backward
(``kernels/aaren_scan_bwd.py``) consumes; serving leaves the flag off and
writes nothing extra.  Packed rows pass ``segment_starts`` (R, N) bool: the
scan resets to the ⊕ identity at every flagged token, so the carry-in
reaches only the positions before a row's first flag and the final carry
is the last segment's state.

* :func:`aaren_scan_plain` — prefix scan + carry fold + guarded readout in
  plain torch, the counterpart of the JAX package's ``ops._aaren_jnp``.
* The kernel — ``csrc/aaren_scan.cu`` (design and bound in its header),
  built by ``kernels/build.py`` at first launch.
* :func:`aaren_scan` — the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises.  Nothing falls back.
  ``aaren_scan.n_launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.scan_attention import (
    ScanState,
    combine,
    combine_segmented,
    prefix_scan_states,
    prefix_scan_states_segmented,
    readout,
)
from repro_torch.kernels import build


def aaren_scan_plain(s, v, m0, u0, w0, *, segment_starts=None,
                     return_residuals=False):
    """(o (R,N,d), m_f (R,1), u_f (R,1), w_f (R,d)) in plain torch; with
    ``return_residuals`` also (m (R,N), u (R,N))."""
    if segment_starts is None:
        states = prefix_scan_states(s, v)         # m,u: (R, N); w: (R, N, d)
        seen = None
    else:
        states, seen = prefix_scan_states_segmented(s, v, segment_starts)
    carry = ScanState(m=m0.expand_as(states.m), u=u0.expand_as(states.u),
                      w=w0[:, None, :].expand_as(states.w))
    if seen is None:
        total = combine(carry, states)
    else:  # the carry folds only into positions before the first reset
        total = ScanState(*combine_segmented(
            (*carry, torch.zeros_like(seen)), (*states, seen))[:3])
    out = (readout(total), total.m[:, -1:].contiguous(),
           total.u[:, -1:].contiguous(), total.w[:, -1, :].contiguous())
    if return_residuals:
        out += (total.m, total.u)
    return out


def _check(s, v, m0, u0, w0, segment_starts):
    if s.ndim != 2 or v.ndim != 3:
        raise ValueError(f"aaren_scan wants s (R, N) and v (R, N, d); got "
                         f"{tuple(s.shape)} and {tuple(v.shape)}")
    r, n = s.shape
    d = v.shape[-1]
    want = {"v": (r, n, d), "m0": (r, 1), "u0": (r, 1), "w0": (r, d)}
    for name, t in (("s", s), ("v", v), ("m0", m0), ("u0", u0), ("w0", w0)):
        if name != "s" and tuple(t.shape) != want[name]:
            raise ValueError(f"aaren_scan: {name} has shape "
                             f"{tuple(t.shape)}, want {want[name]}")
        if t.dtype != torch.float32:
            raise ValueError(f"aaren_scan: {name} is {t.dtype}, want float32")
        if t.device != s.device:
            raise ValueError(f"aaren_scan: {name} is on {t.device}, s on "
                             f"{s.device}")
        if not t.is_contiguous():
            raise ValueError(f"aaren_scan: {name} is not contiguous")
    if r == 0 or n == 0 or d == 0:
        raise ValueError(f"aaren_scan: empty shape R={r}, N={n}, d={d}")
    f = segment_starts
    if f is not None and (tuple(f.shape) != (r, n) or f.dtype != torch.bool
                          or f.device != s.device or not f.is_contiguous()):
        raise ValueError(f"aaren_scan: segment_starts must be a contiguous "
                         f"bool ({r}, {n}) tensor on {s.device}; got "
                         f"{f.dtype} {tuple(f.shape)} on {f.device}")


@functools.cache
def _library():
    lib = build.load("aaren_scan")
    lib.aaren_scan_fwd.argtypes = ([ctypes.c_void_p] * 12
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.aaren_scan_fwd.restype = ctypes.c_int
    lib.aaren_scan_max_d.argtypes = []
    lib.aaren_scan_max_d.restype = ctypes.c_int
    lib.aaren_scan_error_string.argtypes = [ctypes.c_int]
    lib.aaren_scan_error_string.restype = ctypes.c_char_p
    return lib


def _launch(s, v, m0, u0, w0, segment_starts, return_residuals):
    lib = _library()
    r, n = s.shape
    d = v.shape[-1]
    if d > lib.aaren_scan_max_d():
        raise ValueError(f"aaren_scan kernel takes d <= "
                         f"{lib.aaren_scan_max_d()}, got {d}")
    o = torch.empty_like(v)
    m_f, u_f, w_f = (torch.empty_like(m0), torch.empty_like(u0),
                     torch.empty_like(w0))
    res = ((torch.empty_like(s), torch.empty_like(s)) if return_residuals
           else ())
    res_ptrs = [t.data_ptr() for t in res] or [None, None]
    # A bool tensor's bytes are the kernel's uint8 flags (0 or 1).
    starts_ptr = (None if segment_starts is None
                  else segment_starts.data_ptr())
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.aaren_scan_fwd(
            s.data_ptr(), v.data_ptr(), m0.data_ptr(), u0.data_ptr(),
            w0.data_ptr(), starts_ptr, o.data_ptr(), m_f.data_ptr(),
            u_f.data_ptr(), w_f.data_ptr(), *res_ptrs, r, n, d, stream)
    if err:
        raise RuntimeError("aaren_scan kernel launch failed: "
                           + lib.aaren_scan_error_string(err).decode())
    build.count_launch(aaren_scan)
    return (o, m_f, u_f, w_f) + res


def aaren_scan(s, v, m0, u0, w0, *, segment_starts=None,
               return_residuals=False):
    """All-prefix Aaren attention outputs + final carry (+ bwd residuals).

    s: (R, N); v: (R, N, d); m0/u0: (R, 1); w0: (R, d) — all float32,
    contiguous, on one device (``NEG_INF``/0/0 carry for a fresh sequence).
    ``segment_starts``: optional (R, N) contiguous bool flags, True at the
    first token of each packed segment (never at padding).
    Returns (o: (R, N, d), m_f: (R, 1), u_f: (R, 1), w_f: (R, d)); with
    ``return_residuals`` also (m: (R, N), u: (R, N)), the running max and
    softmax denominator after every token.
    """
    _check(s, v, m0, u0, w0, segment_starts)
    if s.device.type == "cpu":
        return aaren_scan_plain(s, v, m0, u0, w0,
                                segment_starts=segment_starts,
                                return_residuals=return_residuals)
    if s.device.type == "cuda":
        return _launch(s, v, m0, u0, w0, segment_starts, return_residuals)
    raise ValueError(f"aaren_scan runs on cpu or cuda, not {s.device}")


aaren_scan.n_launches = 0
