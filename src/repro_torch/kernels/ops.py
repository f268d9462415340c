"""The kernel boundary of the Aaren mixer: ``aaren_prefix_attention``.

Port of the forward of ``repro.kernels.ops.aaren_prefix_attention``.  Every
Aaren prefill, chunk and sequence pass reaches the prefix-scan kernel
through here.  Dispatch is by device, inside ``kernels/aaren_scan.py``: a
CPU tensor takes the plain torch version, a CUDA tensor the CUDA kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.scan_attention import NEG_INF, ScanState
from repro_torch.kernels.aaren_scan import aaren_scan


def aaren_prefix_attention(s, v, carry: ScanState | None = None, *,
                           segment_ids=None, segment_starts=None):
    """All-prefix Aaren attention over arbitrary leading batch dims.

    s: (..., N) scores; v: (..., N, d) values; carry leaves: m,u (...,),
    w (..., d).  Returns (o: (..., N, d) in v's dtype, final carry
    ScanState in f32).
    """
    if segment_ids is not None or segment_starts is not None:
        raise NotImplementedError(
            "packed sequences (segment_ids/segment_starts) come with the "
            "packing slice of the port")
    tensors = (s, v) + (tuple(carry) if carry is not None else ())
    if (s.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        raise NotImplementedError(
            "gradients through the CUDA prefix scan need its backward kernel "
            "and torch.autograd.Function, which come with the training slice")
    batch_shape = tuple(s.shape[:-1])
    n = s.shape[-1]
    d = v.shape[-1]
    r = math.prod(batch_shape)
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
    o, m_f, u_f, w_f = aaren_scan(s2, v2, m0, u0, w0)
    final = ScanState(m=m_f.reshape(batch_shape), u=u_f.reshape(batch_shape),
                      w=w_f.reshape(batch_shape + (d,)))
    return o.reshape(batch_shape + (n, d)).to(v.dtype), final
