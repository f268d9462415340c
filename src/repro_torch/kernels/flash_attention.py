"""Flash attention, forward and backward: the CUDA kernels, their plain
versions and the wrappers that pick between them by device.

Port of the Pallas TPU kernels ``repro.kernels.flash_attention``
(``flash_attention`` and ``flash_attention_bwd``).  q: (B, H, Nq, d); k/v:
(B, G, Nk, d), G | H, query head ``h`` reading kv head ``h // (H/G)``.
Causal and sliding-window masks compare local positions;
``q_lens``/``kv_lens`` (B,) mask each row's tail and are clamped to
``[0, N]`` as the JAX wrapper's ``_as_lens`` does.  Packed rows:
``q_segment_ids``/``kv_segment_ids`` (B, Nq)/(B, Nk) int32 keep a pair
live only when both carry the same nonzero id (0 is padding), and the
kernels skip a tile whose id ranges are disjoint or that is all padding.
A query with no live key reads ``o = 0`` with ``lse = NEG_INF`` and gets
``dq = 0``; a masked key gets ``dk = dv = 0``.

Three kernels, three wrappers (each counts its launches in
``n_launches``):

* :func:`flash_attention` — B3, ``csrc/flash_fwd.cu``: ``o`` and, with
  ``return_residuals``, ``lse = m + log l``.
* :func:`flash_bwd_dq` — B4, ``csrc/flash_bwd.cu``: ``dq`` from
  ``(q, k, v, do, lse, delta)``.
* :func:`flash_bwd_dkv` — B5, ``csrc/flash_bwd.cu``: ``dk, dv``, summed
  over each kv head's query group.

:func:`flash_attention_bwd` validates, computes ``delta = Σ do·o`` in f32
and runs the two backward wrappers.  A CPU tensor goes to the plain
versions (dense torch, the ``ref.flash_reference`` semantics, recomputing
``p = exp(s - lse)`` under the mask as the kernels do); a CUDA tensor
launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.scan_attention import NEG_INF
from repro_torch.core.softmax_attention import attention_mask
from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain versions (dense torch)
# ---------------------------------------------------------------------------


def _scores(q, k, q_lens, kv_lens, causal, window, scale, q_seg, kv_seg):
    """f32 scores (B, H, Nq, Nk) with NEG_INF off the mask, and the mask."""
    h, g = q.shape[1], k.shape[1]
    ke = torch.repeat_interleave(k, h // g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), ke) * scale
    mask = attention_mask(q.shape[2], k.shape[2], causal=causal,
                          window=window, q_lens=q_lens, kv_lens=kv_lens,
                          q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                          device=q.device)
    return torch.where(mask, s, NEG_INF), mask


def flash_attention_plain(q, k, v, q_lens, kv_lens, *, causal, window,
                          scale, q_seg=None, kv_seg=None):
    """(o in q's dtype, lse (B, H, Nq) f32), densely.  ``q_seg``/``kv_seg``:
    optional (B, Nq)/(B, Nk) segment ids."""
    h, g = q.shape[1], k.shape[1]
    s, mask = _scores(q, k, q_lens, kv_lens, causal, window, scale, q_seg,
                      kv_seg)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    l_sum = e.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_sum == 0.0, 1.0, l_sum)
    ve = torch.repeat_interleave(v, h // g, dim=1).float()
    o = torch.einsum("bhqk,bhkd->bhqd", e / l_safe, ve)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, q_lens, kv_lens, causal, window, scale,
          q_seg, kv_seg):
    """The probability and dS tiles, densely, from the residuals."""
    h, g = q.shape[1], k.shape[1]
    s, mask = _scores(q, k, q_lens, kv_lens, causal, window, scale, q_seg,
                      kv_seg)
    # Empty rows carry lse == NEG_INF, where exp(s - lse) is 1 on masked
    # entries: the mask pins them to 0.
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ve = torch.repeat_interleave(v, h // g, dim=1).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), ve)
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta, q_lens, kv_lens, *, causal,
                       window, scale, q_seg=None, kv_seg=None):
    """dq = scale · dS k, in q's dtype."""
    h, g = q.shape[1], k.shape[1]
    _, ds = _p_ds(q, k, v, do, lse, delta, q_lens, kv_lens, causal, window,
                  scale, q_seg, kv_seg)
    ke = torch.repeat_interleave(k, h // g, dim=1).float()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, ke) * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_lens, kv_lens, *, causal,
                        window, scale, q_seg=None, kv_seg=None):
    """dk = scale · dSᵀ q and dv = pᵀ do, per query head, group-summed to
    kv heads, in k's and v's dtypes."""
    b, h, _, d = q.shape
    g, n_k = k.shape[1], k.shape[2]
    p, ds = _p_ds(q, k, v, do, lse, delta, q_lens, kv_lens, causal, window,
                  scale, q_seg, kv_seg)
    dk_h = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv_h = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = dk_h.reshape(b, g, h // g, n_k, d).sum(dim=2)
    dv = dv_h.reshape(b, g, h // g, n_k, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Checks shared by the wrappers
# ---------------------------------------------------------------------------


def _check(name, q, k, v, extra=(), q_seg=None, kv_seg=None):
    """q (B, H, Nq, d); k, v (B, G, Nk, d); ``extra`` are (label, tensor)
    pairs of q's dtype.  One dtype (f32 or bf16), one device, contiguous.
    Segment ids: both or neither, (B, Nq) and (B, Nk) contiguous int32 on
    q's device."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name} wants q (B, H, Nq, d) and k, v (B, G, Nk, "
                         f"d); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    g = k.shape[1]
    if 0 in q.shape or 0 in k.shape:
        raise ValueError(f"{name}: empty shape q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if k.shape[0] != b or k.shape[3] != d or h % g:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need the same B and d, G | H)")
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: q is {q.dtype}, want one of {DTYPES}")
    for label, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {label} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {label} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("segment ids must be given for both q and kv")
    if q_seg is not None:
        for label, t, n in (("q_segment_ids", q_seg, q.shape[2]),
                            ("kv_segment_ids", kv_seg, k.shape[2])):
            _check_small(name, label, t, (b, n), torch.int32, q.device)


def _check_small(name, label, t, shape, dtype, device):
    """An index or statistics tensor: exactly ``shape`` and ``dtype``,
    contiguous, on ``device``."""
    if (tuple(t.shape) != shape or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {label} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, want contiguous {dtype} {shape} on "
                         f"{device}")


def _check_bwd(name, q, k, v, do, lse, delta, q_lens, kv_lens, q_seg,
               kv_seg):
    """The backward kernels' inputs: :func:`_check`'s, plus lse and delta
    (B, H, Nq) f32 and clamped (B,) int32 lengths, contiguous, on q's
    device."""
    _check(name, q, k, v, (("do", do),), q_seg, kv_seg)
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{name}: do {tuple(do.shape)} must be shaped like "
                         f"q {tuple(q.shape)}")
    b, h, n_q, _ = q.shape
    for label, t, shape, dtype in (
            ("lse", lse, (b, h, n_q), torch.float32),
            ("delta", delta, (b, h, n_q), torch.float32),
            ("q_lens", q_lens, (b,), torch.int32),
            ("kv_lens", kv_lens, (b,), torch.int32)):
        _check_small(name, label, t, shape, dtype, q.device)


def _lens(lens, b: int, n: int, device) -> torch.Tensor:
    """Optional (B,) lengths -> (B,) int32 on ``device``, clamped to [0, n]
    (an oversized length would unmask nothing past n)."""
    if lens is None:
        return torch.full((b,), n, dtype=torch.int32, device=device)
    lens = torch.as_tensor(lens, device=device)
    if tuple(lens.shape) != (b,):
        raise ValueError(f"lengths have shape {tuple(lens.shape)}, want "
                         f"({b},)")
    return lens.to(torch.int32).clamp(0, n).contiguous()


def _window_arg(window) -> int:
    if window is None:
        return -1
    if window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    return int(window)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_ARG_FWD = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_ARG_DQ = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float]
           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_ARG_DKV = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.cache
def _library(name: str):
    lib = build.load(name)
    fns = {"flash_fwd": {"flash_fwd": _ARG_FWD},
           "flash_bwd": {"flash_bwd_dq": _ARG_DQ,
                         "flash_bwd_dkv": _ARG_DKV}}[name]
    for fn, argtypes in fns.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, f"{name}_max_d").argtypes = []
    getattr(lib, f"{name}_max_d").restype = ctypes.c_int
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib


def _call(lib_name: str, fn: str, q, k, tensors, scale, causal, window):
    """Launch ``fn`` of ``csrc/<lib_name>.cu`` on the current stream."""
    lib = _library(lib_name)
    b, h, n_q, d = q.shape
    g, n_k = k.shape[1], k.shape[2]
    if d > getattr(lib, f"{lib_name}_max_d")():
        raise ValueError(f"{fn} kernel takes d <= "
                         f"{getattr(lib, f'{lib_name}_max_d')()}, got {d}")
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn)(*ptrs, b, h, g, n_q, n_k, d, float(scale),
                               int(causal), window,
                               int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + getattr(lib, f"{lib_name}_error_string")(
                               err).decode())


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None, q_lens=None, kv_lens=None,
                    q_segment_ids=None, kv_segment_ids=None,
                    return_residuals: bool = False):
    """Flash attention (B3).  q: (B, H, Nq, d); k/v: (B, G, Nk, d);
    optional segment ids (B, Nq)/(B, Nk) int32, both or neither.

    Returns ``o`` (B, H, Nq, d) in q's dtype; with ``return_residuals``
    also ``lse`` (B, H, Nq) f32, which the backward consumes.
    """
    _check("flash_attention", q, k, v, (), q_segment_ids, kv_segment_ids)
    b, _, n_q, d = q.shape
    n_k = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    ql = _lens(q_lens, b, n_q, q.device)
    kl = _lens(kv_lens, b, n_k, q.device)
    win = _window_arg(window)
    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, ql, kl, causal=causal,
                                       window=window, scale=scale,
                                       q_seg=q_segment_ids,
                                       kv_seg=kv_segment_ids)
        return (o, lse) if return_residuals else o
    o = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_residuals else None)
    _call("flash_fwd", "flash_fwd", q, k,
          (q, k, v, ql, kl, q_segment_ids, kv_segment_ids, o, lse), scale,
          causal, win)
    build.count_launch(flash_attention)
    return (o, lse) if return_residuals else o


flash_attention.n_launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, q_lens, kv_lens, *, causal, window,
                 scale, q_seg=None, kv_seg=None):
    """The dq pass (B4).  ``q_lens``/``kv_lens``: (B,) int32, clamped;
    ``lse``/``delta``: (B, H, Nq) f32; ``q_seg``/``kv_seg``: the forward's
    segment ids or None.  Returns dq in q's dtype."""
    _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta, q_lens, kv_lens,
               q_seg, kv_seg)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, q_lens, kv_lens,
                                  causal=causal, window=window, scale=scale,
                                  q_seg=q_seg, kv_seg=kv_seg)
    dq = torch.empty_like(q)
    _call("flash_bwd", "flash_bwd_dq", q, k,
          (q, k, v, do, lse, delta, q_lens, kv_lens, q_seg, kv_seg, dq),
          scale, causal, _window_arg(window))
    build.count_launch(flash_bwd_dq)
    return dq


flash_bwd_dq.n_launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, q_lens, kv_lens, *, causal,
                  window, scale, q_seg=None, kv_seg=None):
    """The dk/dv pass (B5), arguments as :func:`flash_bwd_dq`.  Returns
    (dk, dv) in k's and v's dtypes, summed over each kv head's group."""
    _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, q_lens, kv_lens,
               q_seg, kv_seg)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_lens, kv_lens,
                                   causal=causal, window=window, scale=scale,
                                   q_seg=q_seg, kv_seg=kv_seg)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("flash_bwd", "flash_bwd_dkv", q, k,
          (q, k, v, do, lse, delta, q_lens, kv_lens, q_seg, kv_seg, dk, dv),
          scale, causal, _window_arg(window))
    build.count_launch(flash_bwd_dkv)
    return dk, dv


flash_bwd_dkv.n_launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None, q_lens=None,
                        kv_lens=None, q_segment_ids=None,
                        kv_segment_ids=None):
    """Analytic flash backward from the forward's residuals ``(o, lse)``.

    q/o/do: (B, H, Nq, d); k/v: (B, G, Nk, d); lse: (B, H, Nq) f32.  The
    masks, segment ids included, must match the forward call's.  Returns
    (dq, dk, dv) in the input dtypes.
    """
    _check("flash_attention_bwd", q, k, v, (("o", o), ("do", do)),
           q_segment_ids, kv_segment_ids)
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    if tuple(o.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} must be "
                         f"shaped like q {tuple(q.shape)}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    _window_arg(window)
    ql = _lens(q_lens, b, n_q, q.device)
    kl = _lens(kv_lens, b, n_k, q.device)
    # D_i = Σ_d do·o — one f32 pass shared by both kernels.
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    kw = dict(causal=causal, window=window, scale=scale, q_seg=q_segment_ids,
              kv_seg=kv_segment_ids)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, ql, kl, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ql, kl, **kw)
    return dq, dk, dv
