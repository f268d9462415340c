"""Time the serving tier's tick with its replicas stepped on threads or one
after the other, in turns, on one card.

The load is phase 4k's of ``chip_smoke.py``: a ``ReplicatedRouter`` of 2
replicas x 8 slots (chunk 16, greedy) on the model's random parameters
(seed 0), 32 requests of one shared 256-token prefix (seed 1) and a unique
16-128-token suffix, 32 new tokens each.  Three ways to step the
replicas:

* ``threads`` — ``parallel_step=True``: one worker thread a replica
  (the router's default only for replicas on distinct devices);
* ``threads-0.5ms`` — the same with the interpreter's thread switch
  interval at 0.5 ms instead of 5 ms (how long a thread that wants the GIL
  waits for the one that holds it);
* ``serial`` — ``parallel_step=False``: one replica after the other on the
  calling thread (the default for replicas on one device).

For each run: the tier-tick median (host clock around ``router.step()``,
which ends in each replica's host read), the median of the replicas' own
``engine.step()`` calls inside it, tokens/s over the run, and the tokens,
which must be equal across every run.  Runs go in turns (threads, serial,
threads-0.5ms, threads-0.5ms, serial, threads, ...).  Prints the card's
name and power limit.

Run from the root of the repository on a machine with a card:

    PYTHONPATH=src python3 -m benchmarks.torch.tier_step_ab \\
        [--arch phi3-mini-3.8b] [--rounds 2]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.factory import build
from repro_torch.serving import ReplicatedRouter

MODES = ("threads", "serial", "threads-0.5ms")


def _busy(router) -> bool:
    return bool(router.front) or any(
        router.alive[i] and (e.queue or any(s is not None for s in e.active))
        for i, e in enumerate(router.engines))


def run(api, params, prompts, mode: str, max_new: int) -> dict:
    router = ReplicatedRouter(api, params, n_replicas=2, n_slots=8,
                              chunk=16, parallel_step=mode != "serial")
    router.warmup()
    engine_s = []
    for eng in router.engines:
        def timed(step=eng.step):
            t = time.perf_counter()
            out = step()
            engine_s.append(time.perf_counter() - t)
            return out
        eng.step = timed
    rids = [router.submit(p, max_new) for p in prompts]
    old = sys.getswitchinterval()
    if mode == "threads-0.5ms":
        sys.setswitchinterval(0.0005)
    tick_s = []
    try:
        t0 = time.perf_counter()
        while _busy(router):
            t = time.perf_counter()
            router.step()
            tick_s.append(time.perf_counter() - t)
        wall = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(old)
        router.close()
    if router.stats()["failed_over"] or sum(router.alive) != 2:
        raise RuntimeError(f"{mode}: a replica failed over: "
                           f"{router.stats()}")
    tokens = [router.finished[r] for r in rids]
    return {"tick_ms": statistics.median(tick_s) * 1e3,
            "engine_ms": statistics.median(engine_s) * 1e3,
            "ticks": len(tick_s), "wall": wall,
            "tok_s": sum(map(len, tokens)) / wall, "tokens": tokens}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    api = build(cfg)
    params = api.init(0, device="cuda")
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab, 256)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab, n)])
               for n in rng.integers(16, 129, args.requests)]
    order = []
    for r in range(args.rounds):
        order += list(MODES) if r % 2 == 0 else list(reversed(MODES))
    results = {m: [] for m in MODES}
    ref = None
    for mode in order:
        res = run(api, params, prompts, mode, args.max_new)
        if ref is None:
            ref = res["tokens"]
        if res["tokens"] != ref:
            print(f"{mode}: tokens differ from the first run's")
            return 1
        results[mode].append(res)
        print(f"{mode:14s} {res['ticks']} tier ticks, tick median "
              f"{res['tick_ms']:.3f} ms (engine step median "
              f"{res['engine_ms']:.3f} ms), {res['wall']:.3f} s, "
              f"{res['tok_s']:.1f} tok/s  [{card}]", flush=True)
    for mode in MODES:
        rs = results[mode]
        print(f"{mode:14s} tick median over runs "
              f"{statistics.median(r['tick_ms'] for r in rs):.3f} ms, "
              f"engine step {statistics.median(r['engine_ms'] for r in rs):.3f}"
              f" ms, {statistics.median(r['tok_s'] for r in rs):.1f} tok/s"
              f"  [{card}]")
    print("tokens equal across all runs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
