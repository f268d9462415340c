"""TrainState + the train step builder — port of ``repro.train.state``.

``make_train_step`` composes: microbatch grad accumulation → gradient
compression → global-norm clipping → optimizer update, into one function
``(state, batch, generator) -> (state, metrics)``.  PyTorch runs it eagerly;
the optimizer updates parameters and moments in place (``train/optim.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed.grad import microbatch_grads
from repro_torch.train.optim import Optimizer, clip_by_global_norm
from repro_torch.tree import tree_leaves

GUARD_LATER = ("guarded numerics (train/guard.py) come with the port's "
               "training harness (ROADMAP queue A item 8)")


class TrainState(NamedTuple):
    step: int                # optimizer steps taken
    params: Any
    opt_state: Any


def init_train_state(params, optimizer: Optimizer, guard=None) -> TrainState:
    if guard is not None:
        raise NotImplementedError(GUARD_LATER)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def _to_device(batch: dict, device: torch.device) -> dict:
    """Numpy or torch batch leaves -> tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(loss_fn, optimizer: Optimizer, *,
                    n_microbatches: int = 1,
                    grad_compression: str = "none",
                    max_grad_norm: float = 1.0,
                    guard=None):
    """loss_fn: (params, batch) -> (loss, metrics dict).

    The step moves the batch (numpy or tensors) to the parameters' device,
    and reports ``grad_norm`` (before clipping) beside the loss metrics, all
    as 0-d tensors on that device.  ``generator`` feeds the int8
    compression's stochastic rounding.
    """
    if guard is not None:
        raise NotImplementedError(GUARD_LATER)

    def train_step(state: TrainState, batch, generator=None):
        device = tree_leaves(state.params)[0].device
        grads, _, metrics = microbatch_grads(
            loss_fn, state.params, _to_device(batch, device), n_microbatches,
            compression=grad_compression, generator=generator)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, state.step)
        return TrainState(state.step + 1, params, opt_state), metrics

    return train_step
