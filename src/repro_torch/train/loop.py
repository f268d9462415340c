"""Fault-tolerant training loop — port of ``repro.train.loop``.

* **Checkpoint/restart** — async checkpoints every ``save_every`` steps
  (the tree, the data iterator's ``state()`` and the step) with an atomic
  LATEST pointer, in the JAX package's manifest format; on start the loop
  auto-resumes from the newest valid checkpoint, restoring into the given
  state's own tensors.
* **Preemption** — SIGTERM/SIGINT set a flag; the loop finishes the current
  step, writes a synchronous checkpoint, and exits cleanly.  A second
  signal cuts the drain short.
* **Straggler mitigation** — per-step wall time (the device synchronised
  before it is read) feeds an EWMA + variance estimate; a step slower than
  ``mu + straggler_k * sigma`` is recorded (after ``straggler_warmup``
  samples, with sigma floored at 5 % of the mean; the first step, which
  pays for warm-up, never feeds the estimate).
* **Crash-equivalence** — the loop is a pure function of (checkpoint state,
  data stream): a run stopped and resumed lands on the same parameters bit
  for bit.
* **Guarded numerics** — with a guarded train step (``train/guard.py``)
  the loop accumulates skipped-step / spike counters and the final
  LR-backoff scale into :class:`LoopResult`; ``LoopConfig.guard=True``
  also checks that the step really is guarded.
* **Observability** — per-step instruments into the ambient metrics
  registry, ``train_step``/``straggler``/``run_end`` events into the
  ambient JSONL sink (``train_step`` records carry the ``on_log`` dict
  verbatim), a ``train.step`` span around each step, and a metrics
  snapshot at loop exit (``LoopConfig.metrics_out``).  ``LoopConfig.events``
  and ``metrics_out`` open a sink or registry for the run only when none is
  ambient.
* **Packing** — with ``pack_sequences`` the packed-batch check and each
  step's ``token_util`` (real tokens / row slots) beside the loss.

Not ported yet, and refused when asked for: the mesh knobs (multi-device
layers, ROADMAP queue A item 11).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import (
    Checkpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import write_snapshot
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    save_every: int = 100
    log_every: int = 10
    straggler_k: float = 3.0
    straggler_warmup: int = 10
    seed: int = 0
    # Observability (repro_torch.obs): path of a JSONL event log to open for
    # this run (skipped when a sink is already ambient — the launcher owns
    # it then), and path to dump the metrics-registry snapshot at loop exit.
    events: str | None = None
    metrics_out: str | None = None
    install_signal_handlers: bool = True
    # Packed batches (data/packing.py): each must carry ``segment_ids``;
    # ``token_util`` joins the logged metrics.  The model keys off the
    # batch arrays and needs no switch.
    pack_sequences: bool = False
    # Expect a guarded train step (make_train_step(guard=GuardConfig())):
    # the loop raises when its metrics carry no guard keys.
    guard: bool = False
    # The multi-device layers (ROADMAP queue A item 11); each raises
    # NotImplementedError when set.
    context_parallel: int = 1
    model_parallel: int = 1
    fsdp: int = 0                          # 0 = auto, 1 = off


def check_ported(cfg: LoopConfig) -> None:
    """Raise for every mesh knob that is set."""
    later = [("context_parallel", cfg.context_parallel != 1),
             ("model_parallel", cfg.model_parallel != 1),
             ("fsdp", cfg.fsdp > 1)]
    for name, asked in later:
        if asked:
            raise NotImplementedError(
                f"LoopConfig.{name}={getattr(cfg, name)!r} comes with a "
                "later slice of the port (ROADMAP queue A item 11)")


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    history: list        # (step, metrics dict) tuples
    stragglers: list     # (step, seconds, threshold) tuples
    preempted: bool = False
    resumed_from: int | None = None
    # guarded-numerics counters (0 / 1.0 when the step is unguarded)
    skipped_steps: int = 0       # non-finite steps whose update was skipped
    spike_steps: int = 0         # grad-norm spike anomalies flagged
    final_lr_scale: float = 1.0  # backoff LR multiplier at exit
    preempt_signal: int | None = None  # signal that triggered preemption


def _generator(device: torch.device, seed: int, step: int):
    """The step's random stream (int8 gradient compression), a pure
    function of ``(seed, step)`` as the JAX loop's ``fold_in`` key is."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) + step)
    return gen


def run_train_loop(
    train_step: Callable,    # (state, batch, generator) -> (state, metrics)
    state: TrainState,
    data_iter,               # yields batches; .state()/.restore()
    cfg: LoopConfig,
    *,
    on_log: Callable[[int, dict], None] | None = None,
    _test_hooks: dict | None = None,
) -> LoopResult:
    check_ported(cfg)
    device = tree_leaves(state.params)[0].device
    ckpt = Checkpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
    resumed_from = None

    # ---- auto-resume ------------------------------------------------------
    if ckpt is not None and latest_step(cfg.ckpt_dir) is not None:
        state, step_at_save, extra = restore_checkpoint(cfg.ckpt_dir, state)
        if hasattr(data_iter, "restore") and "data" in extra:
            data_iter.restore(extra["data"])
        resumed_from = step_at_save

    # ---- preemption flag --------------------------------------------------
    # First SIGTERM/SIGINT: finish the current step, write a synchronous
    # final checkpoint, exit cleanly.  A second signal means the grace
    # period is being cut short — stop immediately (the finally block still
    # flushes the async writer; the previous checkpoint stays intact by
    # save atomicity).
    preempt: dict = {"flag": False, "signum": None}

    def _handler(signum, frame):
        if preempt["flag"]:
            raise KeyboardInterrupt(f"second signal {signum} during "
                                    "preemption drain")
        preempt["flag"] = True
        preempt["signum"] = signum

    prev_handlers = {}
    if cfg.install_signal_handlers:
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _handler)
            except ValueError:   # non-main thread (tests)
                pass

    history: list = []
    stragglers: list = []
    ewma_t, ewma_var = None, 0.0
    n_obs = 0
    hooks = _test_hooks or {}
    skipped_steps, spike_steps, lr_scale = 0, 0, 1.0

    own_log = None
    own_reg = None
    try:
        # A launcher-installed sink or registry wins: one log per run, not
        # one per loop call.
        if cfg.events is not None and obs_events.current() is None:
            own_log = obs_events.install(obs_events.EventLog(cfg.events))
        if cfg.metrics_out is not None and obs_metrics.current() is None:
            own_reg = obs_metrics.install(obs_metrics.MetricsRegistry())
        while state.step < cfg.total_steps and not preempt["flag"]:
            step = state.step
            batch = next(data_iter)
            token_util = None
            if cfg.pack_sequences:
                if "segment_ids" not in batch:
                    raise ValueError(
                        "pack_sequences=True but the batch has no "
                        "segment_ids; use a packing iterator "
                        "(repro_torch.data.packing.PackedLMIterator)")
                seg = torch.as_tensor(batch["segment_ids"])
                token_util = float((seg != 0).float().mean())
            gen = _generator(device, cfg.seed, step)
            t0 = time.perf_counter()
            with obs_trace.span("train.step"):
                state, metrics = train_step(state, batch, gen)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if "sleep" in hooks and step in hooks["sleep"]:
                dt += hooks["sleep"][step]  # injected straggler (tests)
            if "preempt_at" in hooks and step >= hooks["preempt_at"]:
                preempt["flag"] = True      # injected preemption (tests)

            # per-step instruments (no-ops without an ambient registry)
            n_tokens = 0
            if isinstance(batch, dict) and "tokens" in batch:
                n_tokens = int(np.prod(np.shape(batch["tokens"])))
            obs_metrics.observe("train_step_time_s", dt)
            if n_tokens:
                obs_metrics.inc("train_tokens_total", n_tokens)
                obs_metrics.set_gauge("train_tokens_per_s",
                                      n_tokens / max(dt, 1e-9))
            if token_util is not None:
                obs_metrics.set_gauge("train_token_util", token_util)
            if "grad_norm" in metrics:
                obs_metrics.set_gauge("train_grad_norm",
                                      float(metrics["grad_norm"]))

            # guarded-numerics counters (train/guard.py metrics)
            if "guard_skipped" in metrics:
                d_skip = int(float(metrics["guard_skipped"]))
                d_spike = int(float(metrics["guard_spike"]))
                skipped_steps += d_skip
                spike_steps += d_spike
                lr_scale = float(metrics["guard_lr_scale"])
                if d_skip:
                    obs_metrics.inc("train_guard_skipped_total", d_skip)
                if d_spike:
                    obs_metrics.inc("train_guard_spike_total", d_spike)
                obs_metrics.set_gauge("train_guard_lr_scale", lr_scale)
            elif cfg.guard:
                raise ValueError(
                    "LoopConfig.guard=True but the train step emits no "
                    "guard metrics — build it with "
                    "make_train_step(..., guard=GuardConfig()) and "
                    "init_train_state(..., guard=cfg)")

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
                        obs_metrics.inc("train_straggler_total")
                        obs_events.emit("straggler", step=step, dt_s=dt,
                                        threshold_s=float(thresh))
                    delta = dt - ewma_t
                    ewma_t += 0.1 * delta
                    ewma_var = 0.9 * (ewma_var + 0.1 * delta * delta)

            if step % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step_time_s"] = dt
                if token_util is not None:
                    m["token_util"] = token_util
                history.append((step, m))
                # the event record carries the on_log dict verbatim
                obs_events.emit("train_step", step=step, **m)
                if on_log:
                    on_log(step, m)

            new_step = state.step
            if ckpt is not None and new_step % cfg.save_every == 0:
                extra = {"data": data_iter.state()} if hasattr(
                    data_iter, "state") else {}
                ckpt.save_async(new_step, state, extra=extra)
            if "crash_at" in hooks and new_step >= hooks["crash_at"]:
                raise KeyboardInterrupt("injected crash")

        # ---- final / preemption checkpoint --------------------------------
        if ckpt is not None:
            extra = {"data": data_iter.state()} if hasattr(
                data_iter, "state") else {}
            ckpt.save_sync(state.step, state, extra=extra)
    finally:
        if ckpt is not None:
            ckpt.wait()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        obs_events.emit("run_end", step=state.step,
                        preempted=bool(preempt["flag"]),
                        skipped_steps=skipped_steps, spike_steps=spike_steps,
                        lr_scale=lr_scale, n_stragglers=len(stragglers))
        if cfg.metrics_out is not None:
            write_snapshot(cfg.metrics_out)
        if own_reg is not None:
            obs_metrics.uninstall()
        if own_log is not None:
            obs_events.uninstall()
            own_log.close()

    return LoopResult(state=state, history=history, stragglers=stragglers,
                      preempted=preempt["flag"], resumed_from=resumed_from,
                      skipped_steps=skipped_steps, spike_steps=spike_steps,
                      final_lr_scale=lr_scale,
                      preempt_signal=preempt["signum"])
