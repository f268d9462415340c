#!/usr/bin/env python3
"""A/B of the full-width streaming engine's tick of two trees of the port,
on one card.

Each side runs in its own process from its own root, with its own ``src/``
on the path, and serves phase 4's load of ``chip_smoke.py`` on one
``StreamingEngine`` with the default (greedy) sampler: phi3-mini-3.8b at
full width on random parameters (seed 0), 8 slots, chunk 16, 16 requests
of 32-256 prompt tokens (seed 0), 32 new tokens each, three passes after
the engine's warm-up.  The tick is timed on the host clock around
``engine.step()``, which ends in the tick's host read.  The sides run in
turns — A, B, B, A, repeated ``--rounds`` times — because the tick's host
time varies from run to run; the tokens must be equal on every run.  The
script prints each run's tick median, the card's name and power limit,
and B's tick against A's.

Then, in this one process, the engine module alone: tree B's model,
kernels and sampler, served through A's ``serving/engine.py`` (with A's
``request_seed`` and greedy sampler) and B's in turns, A, B, B, A
repeated ``2 * --rounds`` times, one pass of the load each — which
removes the drift between processes from the comparison.

    git archive <parent> | tar -x -C build/parent
    python3 benchmarks/torch/serve_tick_ab.py --a build/parent --b . \
        [--rounds 2]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

SIDE = r'''
import json, statistics, time
import numpy as np, torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.models.factory import build
from repro_torch.serving.engine import StreamingEngine

cfg = get_config(cs.ARCH)
api = build(cfg)
params = api.init(0, device="cuda")
rng = np.random.default_rng(0)
lens = rng.integers(32, 257, cs.REQUESTS)
reqs = [rng.integers(0, cfg.vocab, n) for n in lens]
eng = StreamingEngine(api, params, n_slots=cs.SLOTS, chunk=cs.CHUNK)
eng.warmup()
tick_s, tokens = [], None
for _ in range(3):
    rids = [eng.submit(p, cs.MAX_NEW) for p in reqs]
    while eng.queue or any(s is not None for s in eng.active):
        t = time.perf_counter()
        eng.step()
        tick_s.append(time.perf_counter() - t)
    got = [eng.finished.pop(r) for r in rids]
    assert tokens is None or got == tokens, "tokens differ between passes"
    tokens = got
print("RESULT", json.dumps({
    "tick_ms": statistics.median(tick_s) * 1e3, "ticks": len(tick_s),
    "tokens": tokens}))
'''


def run_side(tree: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", SIDE], capture_output=True, text=True,
        cwd=tree, env={**os.environ, "PYTHONPATH": f"{tree}:{tree / 'src'}"})
    line = next((x for x in proc.stdout.splitlines()
                 if x.startswith("RESULT ")), None)
    if proc.returncode or line is None:
        raise RuntimeError(f"side {tree} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return json.loads(line[len("RESULT "):])


def engine_ab(a_tree: Path, b_tree: Path, blocks: int, card: str,
              device: str = "cuda") -> float:
    """A's and B's engine modules over B's model in this process, in turns;
    returns B's mean pass tick over A's."""
    import importlib.util
    import time

    import numpy as np

    sys.path[:0] = [str(b_tree), str(b_tree / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build
    from repro_torch.serving import engine as b_engine

    def load(name: str, path: Path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod          # dataclasses look their module up
        spec.loader.exec_module(mod)
        return mod

    serving = a_tree / "src" / "repro_torch" / "serving"
    a_sampler = load("serve_tick_ab_sampler_a", serving / "sampler.py")
    a_engine = load("serve_tick_ab_engine_a", serving / "engine.py")
    a_engine.request_seed = a_sampler.request_seed
    engines = {"A": (a_engine.StreamingEngine, a_sampler.greedy_sampler),
               "B": (b_engine.StreamingEngine, b_engine.greedy_sampler)}
    cfg = get_config(cs.ARCH)
    api = build(cfg)
    params = api.init(0, device=device)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 257, cs.REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, n) for n in lens]
    ticks = {"A": [], "B": []}
    tokens = None
    for side in "ABBA" * blocks:
        cls, sampler = engines[side]
        eng = cls(api, params, n_slots=cs.SLOTS, chunk=cs.CHUNK,
                  sampler=sampler)
        eng.warmup()
        rids = [eng.submit(p, cs.MAX_NEW) for p in reqs]
        tick_s = []
        while eng.queue or any(s is not None for s in eng.active):
            t = time.perf_counter()
            eng.step()
            tick_s.append(time.perf_counter() - t)
        got = [eng.finished[r] for r in rids]
        if tokens is not None and got != tokens:
            raise RuntimeError(f"engine {side}: the tokens differ")
        tokens = got
        ticks[side].append(statistics.median(tick_s) * 1e3)
        print(f"engine module {side}: tick median {ticks[side][-1]:.3f} ms "
              f"over {len(tick_s)} ticks  [{card}]", flush=True)
    a, b = ticks["A"], ticks["B"]
    ratio = statistics.mean(b) / statistics.mean(a)
    print(f"engine module tick ms: A {statistics.mean(a):.3f}, B "
          f"{statistics.mean(b):.3f} (mean of {len(a)} passes each; medians "
          f"{statistics.median(a):.3f}, {statistics.median(b):.3f}); B / A = "
          f"{ratio:.4f}; tokens equal on every pass  [{card}]")
    return ratio


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--a", type=Path, required=True, help="tree A (parent)")
    ap.add_argument("--b", type=Path, required=True, help="tree B (change)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_tick_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}
    runs = [(side, run_side(trees[side])) for side in "ABBA" * args.rounds]
    for side, got in runs:
        print(f"{side} tick median {got['tick_ms']:.3f} ms over "
              f"{got['ticks']} ticks  [{card}]")
    if any(got["tokens"] != runs[0][1]["tokens"] for _, got in runs):
        print("serve_tick_ab: the tokens differ between runs")
        return 1
    a = [got["tick_ms"] for side, got in runs if side == "A"]
    b = [got["tick_ms"] for side, got in runs if side == "B"]
    print(f"tick ms: A {statistics.mean(a):.3f}, B {statistics.mean(b):.3f}"
          f" (mean of {len(a)} runs each; medians {statistics.median(a):.3f},"
          f" {statistics.median(b):.3f}); B / A = "
          f"{statistics.mean(b) / statistics.mean(a):.4f}; tokens equal "
          f"on every run  [{card}]", flush=True)
    engine_ab(trees["A"], trees["B"], 2 * args.rounds, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
