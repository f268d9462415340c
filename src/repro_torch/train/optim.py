"""Optimizers on parameter trees: AdamW and Adafactor — port of
``repro.train.optim``.

The same math and dtypes as the JAX package: AdamW keeps its moments in
``moment_dtype`` (f32 for ``adamw``, bf16 for ``adamw_bf16``) and runs the
update in f32, casting the new parameters back to their own dtype;
Adafactor keeps the Shazeer–Stern factored second moment (a row and a column
vector over the last two dims of every parameter with >= 2 dims).

Unlike the JAX package, ``update`` writes the new parameters and optimizer
state into the existing tensors, in place under ``torch.no_grad()``, so a
step holds no second copy of the model or of its moments; it returns the
same trees it was given.  Schedules return Python floats.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, step, *, lr_scale=1.0) -> (params, state)
    # lr_scale is the guarded-numerics backoff hook: a multiplier on the
    # scheduled LR, 1.0 in normal operation.
    update: Callable[..., tuple]


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``."""
    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = min(max(frac, 0.0), 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi
                                                                  * frac))
        return peak_lr * cos

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.

    Returns (grads, gnorm), gnorm an f32 0-d tensor of the norm before
    clipping.  The gradients are scaled in place, in their own dtype (the
    JAX package returns f32 copies; for f32 gradients the two agree).
    """
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, gnorm


def adamw(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          moment_dtype=torch.float32) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step, *, lr_scale=1.0):
        lr = schedule(step) * lr_scale
        t = step + 1
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g = g.float()
            m32 = m.float() * b1 + (1 - b1) * g
            v32 = v.float() * b2 + (1 - b2) * g * g
            p32 = p.float()
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps) + (
                weight_decay * p32)
            p.copy_(p32 - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
        return params, state

    return Optimizer(init, update)


def _is_second_moment(x) -> bool:
    return isinstance(x, dict) and set(x) in ({"v"}, {"vr", "vc"})


def adafactor(schedule, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0, min_dim_factored=2) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018)."""

    def init(params):
        def per_param(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)

            if p.ndim >= min_dim_factored:
                return {"vr": zeros(p.shape[:-1]),                    # row
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}     # col
            return {"v": zeros(p.shape)}

        return {"v": tree_map(per_param, params)}

    @torch.no_grad()
    def update(grads, state, params, step, *, lr_scale=1.0):
        lr = schedule(step) * lr_scale
        t = float(step + 1)
        beta = 1.0 - t ** (-decay)  # increasing-decay schedule
        moments = tree_leaves(state["v"], is_leaf=_is_second_moment)
        for g, vs, p in zip(tree_leaves(grads), moments, tree_leaves(params)):
            g = g.float()
            g2 = g * g + eps
            if p.ndim >= min_dim_factored:
                vr = beta * vs["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * vs["vc"] + (1 - beta) * g2.mean(dim=-2)
                row_mean = torch.clamp(
                    vr.mean(dim=-1, keepdim=True)[..., None], min=eps)
                rms = torch.sqrt(vr[..., None] * vc[..., None, :] / row_mean)
                u = g / torch.clamp(rms, min=eps)
                vs["vr"].copy_(vr)
                vs["vc"].copy_(vc)
            else:
                v = beta * vs["v"] + (1 - beta) * g2
                u = g / torch.sqrt(v + eps)
                vs["v"].copy_(v)
            # update clipping (RMS of the update <= clip_threshold)
            urms = torch.sqrt(u.square().mean())
            u = u / torch.clamp(urms / clip_threshold, min=1.0)
            p32 = p.float()
            p.copy_(p32 - lr * (u + weight_decay * p32))
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, schedule) -> Optimizer:
    if name == "adamw":
        return adamw(schedule)
    if name == "adamw_bf16":
        return adamw(schedule, moment_dtype=torch.bfloat16)
    if name == "adafactor":
        return adafactor(schedule)
    raise ValueError(f"unknown optimizer {name!r}")
