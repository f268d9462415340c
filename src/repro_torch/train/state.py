"""TrainState + the train step builder — port of ``repro.train.state``.

``make_train_step`` composes: microbatch grad accumulation → gradient
compression → global-norm clipping → optimizer update, into one function
``(state, batch, generator) -> (state, metrics)``.  PyTorch runs it eagerly;
the optimizer updates parameters and moments in place (``train/optim.py``).

With ``guard=`` (``train/guard.py``) the step decides before the update:
the all-finite check of the loss and gradients and the guard carry's
update run on the device, the host reads the one ``apply`` bool, and only
then is the optimizer called (with ``lr_scale``) or skipped.  An in-place
update cannot be undone, and a masked copy of the parameters and moments
would not fit beside a full-width step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed.grad import microbatch_grads
from repro_torch.train.guard import (
    GuardConfig,
    all_finite,
    guard_update,
    init_guard_state,
)
from repro_torch.train.optim import Optimizer, clip_by_global_norm
from repro_torch.tree import tree_leaves


class TrainState(NamedTuple):
    step: int                # optimizer steps taken
    params: Any
    opt_state: Any
    guard: Any = None        # GuardState when built with guard=, else None


def init_train_state(params, optimizer: Optimizer,
                     guard: GuardConfig | None = None) -> TrainState:
    device = tree_leaves(params)[0].device
    return TrainState(
        step=0, params=params, opt_state=optimizer.init(params),
        guard=(init_guard_state(guard, device) if guard is not None
               else None))


def _to_device(batch: dict, device: torch.device) -> dict:
    """Numpy or torch batch leaves -> tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(loss_fn, optimizer: Optimizer, *,
                    n_microbatches: int = 1,
                    grad_compression: str = "none",
                    max_grad_norm: float = 1.0,
                    guard: GuardConfig | None = None):
    """loss_fn: (params, batch) -> (loss, metrics dict).

    The step moves the batch (numpy or tensors) to the parameters' device,
    and reports ``grad_norm`` (before clipping) beside the loss metrics, all
    as 0-d tensors on that device.  ``generator`` feeds the int8
    compression's stochastic rounding.

    ``guard``: guarded numerics.  The step then expects ``state.guard`` to
    hold a :class:`~repro_torch.train.guard.GuardState` (use
    ``init_train_state(..., guard=cfg)``), skips the update on non-finite
    loss/grads (parameters and optimizer state untouched; the step counter
    still advances), applies the backoff LR scale through the optimizer's
    ``lr_scale`` hook, and emits ``guard_skipped`` / ``guard_spike`` /
    ``guard_lr_scale`` metrics every step.
    """

    def train_step(state: TrainState, batch, generator=None):
        device = tree_leaves(state.params)[0].device
        grads, loss, metrics = microbatch_grads(
            loss_fn, state.params, _to_device(batch, device), n_microbatches,
            compression=grad_compression, generator=generator)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm

        if guard is None:
            params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params, state.step)
            return TrainState(state.step + 1, params, opt_state,
                              state.guard), metrics

        if state.guard is None:
            raise ValueError(
                "make_train_step(guard=...) needs a guarded TrainState; "
                "build it with init_train_state(params, opt, guard=cfg)")
        finite = all_finite(loss, grads)
        g, apply, spike = guard_update(guard, state.guard, finite, gnorm)
        params, opt_state = state.params, state.opt_state
        if bool(apply):      # the step's one host read of the guard
            params, opt_state = optimizer.update(
                grads, opt_state, params, state.step,
                lr_scale=state.guard.lr_scale)
        metrics["guard_skipped"] = 1.0 - apply.float()
        metrics["guard_spike"] = spike.float()
        metrics["guard_lr_scale"] = g.lr_scale
        return TrainState(state.step + 1, params, opt_state, g), metrics

    return train_step
