"""Gradient compression + microbatch accumulation — port of
``repro.distributed.grad``.

Compression
-----------
Emulated as in the JAX package, around the point where a data-parallel
all-reduce would run:

* ``"bf16"``  — round gradients through bfloat16 (half the all-reduce bytes);
* ``"int8"``  — per-tensor-scaled int8 with **stochastic rounding**
  (unbiased: E[q] = g, so momentum accumulates no quantization bias),
  quantized and dequantized; the noise comes from a ``torch.Generator``, so
  its bits differ from the JAX package's;
* ``"none"``  — gradients as they are.

Microbatching
-------------
:func:`microbatch_grads` evaluates the loss and its gradients over ``k``
sequential microbatches, accumulating in f32, so peak activation memory
drops by about ``k``.  Microbatch ``i`` takes the batch rows ``i, i+k,
i+2k, ...``, the JAX package's strided split.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def quantize_int8_stochastic(g: torch.Tensor, generator=None):
    """Unbiased per-tensor int8 quantization of f32 ``g``.  Returns
    (q, scale)."""
    scale = torch.clamp(g.abs().max(), min=1e-30) / 127.0
    noise = torch.rand(g.shape, generator=generator, device=g.device) - 0.5
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_gradients(grads, mode: str, generator=None):
    """Apply the selected compression to a gradient tree."""
    if mode == "none":
        return grads
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).float(), grads)
    if mode == "int8":
        def one(g):
            q, scale = quantize_int8_stochastic(g.float(), generator)
            return dequantize_int8(q, scale).to(g.dtype)

        return tree_map(one, grads)
    raise ValueError(f"unknown compression mode {mode!r}")


def _microbatch(batch: dict, i: int, k: int) -> dict:
    """Rows ``i, i+k, ...`` of every batched leaf; 0-d leaves repeat."""
    out = {}
    for name, x in batch.items():
        if x.ndim == 0:
            out[name] = x
            continue
        if x.shape[0] % k:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"microbatches {k}")
        out[name] = x[i::k]
    return out


def microbatch_grads(loss_fn, params, batch: dict, n_microbatches: int, *,
                     compression: str = "none", generator=None):
    """Mean loss/grads over ``n_microbatches`` sequential slices.

    loss_fn: (params, microbatch) -> (loss, metrics).  Every parameter
    tensor is made to require grad.  Returns (grads, loss, metrics) — all
    microbatch means, with f32 accumulation when ``n_microbatches > 1``
    (with one microbatch the grads keep the parameters' dtype, as in JAX).
    """
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grad_fn(mb):
        with torch.enable_grad():
            loss, metrics = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, list(grads)

    if n_microbatches <= 1:
        loss, metrics, grads = grad_fn(batch)
    else:
        k = n_microbatches
        loss, metrics, grads = grad_fn(_microbatch(batch, 0, k))
        grads = [g.float() for g in grads]
        metrics = dict(metrics)
        for i in range(1, k):
            loss_i, metrics_i, grads_i = grad_fn(_microbatch(batch, i, k))
            for acc, g in zip(grads, grads_i):
                acc.add_(g)
            loss = loss + loss_i
            metrics = {name: metrics[name] + metrics_i[name]
                       for name in metrics}
        inv = 1.0 / k
        for g in grads:
            g.mul_(inv)
        loss = loss * inv
        metrics = {name: m * inv for name, m in metrics.items()}
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    return compress_gradients(grads, compression, generator), loss, metrics
