"""The training loop — the core of ``repro.train.loop.run_train_loop``.

What the port runs: the step loop over a data iterator, with the device
synchronised before each step's wall time is read; ``history`` and
``on_log`` every ``log_every`` steps; and straggler detection — per-step
wall time feeds an EWMA + variance estimate, and a step slower than
``mu + straggler_k * sigma`` is recorded (after ``straggler_warmup``
samples, with sigma floored at 5 % of the mean; the first step, which pays
for warm-up, never feeds the estimate).

Not ported yet, and refused when asked for rather than ignored:
checkpoint/restart, guarded numerics, the event and metrics sinks and
packed-batch accounting (the training harness, ROADMAP queue A items 7–8),
and the mesh knobs (multi-device layers, item 11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.train.state import TrainState
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 10
    straggler_k: float = 3.0
    straggler_warmup: int = 10
    seed: int = 0
    # Later slices of the port; each raises NotImplementedError when set.
    ckpt_dir: str | None = None            # item 8
    events: str | None = None              # item 8
    metrics_out: str | None = None         # item 8
    guard: bool = False                    # item 8
    pack_sequences: bool = False           # item 7
    context_parallel: int = 1              # item 11
    model_parallel: int = 1                # item 11
    fsdp: int = 0                          # item 11 (0 = auto, 1 = off)


def check_ported(cfg: LoopConfig) -> None:
    """Raise for every knob of a later slice that is set."""
    later = [("ckpt_dir", cfg.ckpt_dir is not None, 8),
             ("events", cfg.events is not None, 8),
             ("metrics_out", cfg.metrics_out is not None, 8),
             ("guard", cfg.guard, 8),
             ("pack_sequences", cfg.pack_sequences, 7),
             ("context_parallel", cfg.context_parallel != 1, 11),
             ("model_parallel", cfg.model_parallel != 1, 11),
             ("fsdp", cfg.fsdp > 1, 11)]
    for name, asked, item in later:
        if asked:
            raise NotImplementedError(
                f"LoopConfig.{name}={getattr(cfg, name)!r} comes with a "
                f"later slice of the port (ROADMAP queue A item {item})")


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    history: list        # (step, metrics dict) tuples
    stragglers: list     # (step, seconds, threshold) tuples


def _generator(device: torch.device, seed: int, step: int):
    """The step's random stream (int8 gradient compression), a pure
    function of ``(seed, step)`` as the JAX loop's ``fold_in`` key is."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) + step)
    return gen


def run_train_loop(
    train_step: Callable,    # (state, batch, generator) -> (state, metrics)
    state: TrainState,
    data_iter,               # yields batches
    cfg: LoopConfig,
    *,
    on_log: Callable[[int, dict], None] | None = None,
) -> LoopResult:
    check_ported(cfg)
    device = tree_leaves(state.params)[0].device
    history: list = []
    stragglers: list = []
    ewma_t, ewma_var = None, 0.0
    n_obs = 0
    while state.step < cfg.total_steps:
        step = state.step
        batch = next(data_iter)
        gen = _generator(device, cfg.seed, step)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0

        # straggler EWMA (skip the warm-up step)
        if step > 0:
            if ewma_t is None:
                ewma_t = dt
            else:
                n_obs += 1
                sigma = max(float(np.sqrt(ewma_var)), 0.05 * ewma_t)
                thresh = ewma_t + cfg.straggler_k * sigma
                if dt > thresh and n_obs >= cfg.straggler_warmup:
                    stragglers.append((step, dt, float(thresh)))
                delta = dt - ewma_t
                ewma_t += 0.1 * delta
                ewma_var = 0.9 * (ewma_var + 0.1 * delta * delta)

        if step % cfg.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step_time_s"] = dt
            history.append((step, m))
            if on_log:
                on_log(step, m)
    return LoopResult(state=state, history=history, stragglers=stragglers)
