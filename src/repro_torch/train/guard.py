"""Guarded numerics for the train step — port of ``repro.train.guard``.

A single NaN loss — one bad batch, one overflowed bf16 reduction — must not
kill a multi-day run or, worse, silently write NaN into the parameters and
every checkpoint after.  The policy is the JAX package's:

* **All-finite check** — loss + every gradient leaf reduced to one 0-d
  bool (:func:`all_finite`, the JAX package's predicate: ``sum(0 * x)``
  is NaN iff ``x`` holds a NaN or ±inf, and a sum of zeros never
  overflows).  It is not read off the gradient norm: the f32 squares of
  finite bf16 gradients above ~1.8e19 overflow to inf.
* **Skip-and-backoff** — a non-finite step applies *no* update (the step
  counter still advances so the data stream and LR schedule stay aligned
  with an uninterrupted run) and multiplies the LR scale by ``backoff``,
  down to ``min_lr_scale``.  After ``recover_every`` consecutive finite
  steps one level is undone.
* **Grad-norm spike window** — a ring of the last ``spike_window`` finite
  grad norms; a step whose norm exceeds ``spike_factor ×`` the window mean
  is flagged, and optionally skipped (``skip_on_spike``) without touching
  the LR scale.

The port's optimizer writes parameters and moments in place, so an update
cannot be undone: ``make_train_step`` reads :func:`guard_update`'s
``apply`` on the host and calls the optimizer only when it is true.  The
guard carry is a NamedTuple of 0-d and ``(W,)`` tensors on the parameters'
device (f32 and int32, the JAX dtypes); it lives in ``TrainState`` and
checkpoints with it, so a resumed run continues the backoff schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves

#: per-step metric keys a guarded train step emits (train/state.py)
GUARD_METRIC_KEYS = ("guard_skipped", "guard_spike", "guard_lr_scale")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Policy knobs for the guarded train step (the JAX package's)."""

    backoff: float = 0.5          # LR-scale multiplier per non-finite step
    recover_every: int = 50       # consecutive finite steps to undo one level
    min_lr_scale: float = 1.0 / 64.0
    spike_window: int = 32        # rolling grad-norm window length
    spike_factor: float = 10.0    # flag gnorm > factor * window mean
    spike_min_history: int = 8    # window entries required before flagging
    skip_on_spike: bool = False   # also skip flagged steps (no LR backoff)


class GuardState(NamedTuple):
    """Per-run guard carry (checkpointed inside TrainState)."""

    lr_scale: torch.Tensor      # () f32 current LR multiplier (<= 1)
    skipped: torch.Tensor       # () i32 non-finite steps skipped so far
    spikes: torch.Tensor        # () i32 grad-norm spikes flagged so far
    good_streak: torch.Tensor   # () i32 finite steps since last skip/recovery
    gnorm_window: torch.Tensor  # (W,) f32 ring of recent finite grad norms
    window_ptr: torch.Tensor    # () i32 next ring slot
    window_count: torch.Tensor  # () i32 valid entries (saturates at W)


def init_guard_state(cfg: GuardConfig, device="cpu") -> GuardState:
    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return GuardState(
        lr_scale=torch.ones((), dtype=torch.float32, device=device),
        skipped=i32(), spikes=i32(), good_streak=i32(),
        gnorm_window=torch.zeros((cfg.spike_window,), dtype=torch.float32,
                                 device=device),
        window_ptr=i32(), window_count=i32())


@torch.no_grad()
def all_finite(*trees: Any) -> torch.Tensor:
    """One 0-d bool: every floating leaf of every tree is free of NaN/±inf.

    Per leaf ``isfinite(sum(0 * x))``: two passes in the leaf's own dtype
    (``0 * x`` is exact), where ``isfinite(x).all()`` takes five (abs, two
    compares, their product, the reduction).  Integer leaves count as
    finite.  Returns a tensor on the first leaf's device; reading it is the
    caller's one host sync.
    """
    leaves = [x for t in trees for x in tree_leaves(t)
              if torch.is_tensor(x)]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    checks = [torch.isfinite((x * 0).sum()) for x in leaves
              if x.dtype.is_floating_point]
    if not checks:
        return torch.ones((), dtype=torch.bool, device=leaves[0].device)
    return torch.stack(checks).all()


@torch.no_grad()
def guard_update(cfg: GuardConfig, g: GuardState, finite: torch.Tensor,
                 gnorm: torch.Tensor
                 ) -> tuple[GuardState, torch.Tensor, torch.Tensor]:
    """Advance the guard carry for one step, in the JAX package's f32 and
    int32 arithmetic.

    Returns ``(new_state, apply, spike)``: ``apply`` (0-d bool) is True iff
    the optimizer update should be applied this step; ``spike`` is the
    anomaly flag.  The LR scale consumed by *this* step is ``g.lr_scale``
    (backoff takes effect from the next step on).
    """
    gnorm = gnorm.float()
    finite = finite.to(torch.bool)
    w = g.gnorm_window.shape[0]

    # -- spike window (finite norms only; a NaN norm must not poison it) ----
    mean = g.gnorm_window.sum() / torch.clamp(g.window_count, min=1)
    spike = (finite & (g.window_count >= cfg.spike_min_history)
             & (gnorm > cfg.spike_factor * mean))
    slot = torch.remainder(g.window_ptr, w).long()
    written = g.gnorm_window.clone()
    written[slot] = gnorm
    new_window = torch.where(finite, written, g.gnorm_window)
    new_ptr = torch.where(finite, torch.remainder(g.window_ptr + 1, w),
                          g.window_ptr)
    new_count = torch.where(finite, torch.clamp(g.window_count + 1, max=w),
                            g.window_count)

    # -- skip / LR backoff --------------------------------------------------
    apply = finite & ~spike if cfg.skip_on_spike else finite
    backed_off = torch.clamp(g.lr_scale * cfg.backoff, min=cfg.min_lr_scale)
    streak = torch.where(finite, g.good_streak + 1, 0)
    recover = finite & (streak >= cfg.recover_every) & (g.lr_scale < 1.0)
    recovered = torch.clamp(g.lr_scale / cfg.backoff, max=1.0)
    new_scale = torch.where(finite,
                            torch.where(recover, recovered, g.lr_scale),
                            backed_off)
    streak = torch.where(recover, 0, streak)

    new_g = GuardState(
        lr_scale=new_scale.float(),
        skipped=(g.skipped + (~finite).to(torch.int32)).to(torch.int32),
        spikes=(g.spikes + spike.to(torch.int32)).to(torch.int32),
        good_streak=streak.to(torch.int32),
        gnorm_window=new_window,
        window_ptr=new_ptr.to(torch.int32),
        window_count=new_count.to(torch.int32))
    return new_g, apply, spike
