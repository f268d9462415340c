"""Training launcher: one device, random weights from ``--seed``, the
synthetic token stream — port of ``repro.launch.train``.

The same flags and the same log lines as the JAX launcher.  Runs on the
card unless ``--device cpu`` is given; ``--attn-mode softmax`` trains the
softmax baseline through the flash kernels.  ``--ckpt-dir`` checkpoints
every ``--save-every`` steps and at the end, and resumes from the newest
intact checkpoint there (the JAX package's format: either package reads
the other's); ``--guard`` skips non-finite steps with an LR backoff;
``--events`` writes the JSONL event log and ``--metrics-out`` the metrics
snapshot at exit.  The mesh flags are accepted and refused with the
ROADMAP item that brings them (queue A item 11).

Example::

    python -m repro_torch.launch.train --arch phi3-mini-3.8b --smoke \
        --steps 100 --batch 8 --seq-len 64 --guard --ckpt-dir ckpt \
        --events events.jsonl --metrics-out metrics.json
    python -m repro_torch.launch.train --arch recurrentgemma-9b --smoke \
        --steps 3 --device cpu
    python -m repro_torch.launch.train --arch dbrx-132b --smoke \
        --steps 3 --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.synthetic import SyntheticLMIterator
from repro_torch.models.factory import build
from repro_torch.models.param import count_params
from repro_torch.train.guard import GuardConfig
from repro_torch.train.loop import LoopConfig, run_train_loop
from repro_torch.train.optim import make_optimizer, warmup_cosine
from repro_torch.train.state import init_train_state, make_train_step


def _refuse_later_flags(args) -> None:
    later = [
        ("--context-parallel", args.context_parallel != 1),
        ("--model-parallel", args.model_parallel != 1),
        ("--fsdp", args.fsdp > 1),
    ]
    for flag, asked in later:
        if asked:
            raise NotImplementedError(
                f"{flag} comes with a later slice of the port (ROADMAP "
                "queue A item 11)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--attn-mode", default="aaren",
                    choices=["aaren", "softmax"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--context-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--fsdp", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--guard", action="store_true",
                    help="guarded numerics: skip non-finite steps, back off "
                         "the LR, flag grad-norm spikes")
    ap.add_argument("--guard-backoff", type=float, default=0.5,
                    help="LR multiplier applied per non-finite step")
    ap.add_argument("--guard-recover-every", type=int, default=50,
                    help="finite steps before one backoff level is restored")
    ap.add_argument("--guard-spike-window", type=int, default=32,
                    help="rolling grad-norm window for spike detection")
    ap.add_argument("--events", default=None,
                    help="path of the JSONL event log to write "
                         "(repro_torch.obs.events; off when omitted)")
    ap.add_argument("--metrics-out", default=None,
                    help="path of the metrics-snapshot JSON dumped at loop "
                         "exit (installs a metrics registry for the run)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch kernels)")
    args = ap.parse_args(argv)
    _refuse_later_flags(args)

    cfg = (smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    cfg = cfg.replace(attn_mode=args.attn_mode)
    api = build(cfg)
    print(f"arch={cfg.name} attn_mode={cfg.attn_mode} "
          f"pattern={cfg.effective_pattern()[:6]}")

    params = api.init(args.seed, device=args.device)
    print(f"params: {count_params(api.specs())/1e6:.2f}M")

    guard = None
    if args.guard:
        guard = GuardConfig(backoff=args.guard_backoff,
                            recover_every=args.guard_recover_every,
                            spike_window=args.guard_spike_window)
    opt = make_optimizer(cfg.optimizer,
                         warmup_cosine(args.lr, args.steps // 10, args.steps))
    state = init_train_state(params, opt, guard=guard)
    step_fn = make_train_step(
        api.loss, opt, n_microbatches=args.microbatches,
        grad_compression=args.grad_compression, guard=guard)

    data = SyntheticLMIterator(
        vocab=cfg.vocab, seq_len=args.seq_len, batch=args.batch,
        seed=args.seed)
    loop_cfg = LoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        save_every=args.save_every, log_every=max(args.steps // 20, 1),
        seed=args.seed, guard=args.guard, events=args.events,
        metrics_out=args.metrics_out)

    def on_log(step, m):
        guard_s = (f" lr_scale={m['guard_lr_scale']:.3f}"
                   if "guard_lr_scale" in m else "")
        print(f"step {step:6d} loss={m['loss']:.4f} "
              f"gnorm={m.get('grad_norm', 0):.3f}"
              f"{guard_s} {m['step_time_s']*1e3:.0f}ms")

    result = run_train_loop(step_fn, state, data, loop_cfg, on_log=on_log)
    print(f"done at step {result.state.step}; "
          f"stragglers observed: {len(result.stragglers)}")
    if args.events:
        print(f"event log: {args.events}")
    if args.metrics_out:
        print(f"metrics snapshot: {args.metrics_out}")
    if args.guard:
        print(f"guard: skipped {result.skipped_steps} non-finite steps, "
              f"{result.spike_steps} grad-norm spikes, final lr_scale "
              f"{result.final_lr_scale:.3f}")


if __name__ == "__main__":
    main()
