#!/usr/bin/env python3
"""A/B of the Aaren scan kernels (B1, B2) of two trees of the port, on one card.

Each side runs in its own process with its own ``src/`` on the path, so it
builds and calls its own CUDA sources through its own wrappers, on the same
numpy inputs (the unflagged call every version of the wrappers takes).  The
sides run in turns — A, B, B, A — and the script prints each run's device
time (one launch inside a replayed CUDA graph) and whether the two trees'
outputs are bit-identical.

    git archive <parent> | tar -x -C build/parent
    python3 benchmarks/torch/scan_ab.py --a build/parent --b .
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

# label, R, N, d, with residuals: the serving tick and the training shape of
# phi3-mini-3.8b
SHAPES = [("serving tick", 256, 16, 96, False),
          ("training", 128, 1024, 96, True)]

SIDE = r'''
import statistics, sys
import numpy as np, torch
from repro_torch.core.scan_attention import NEG_INF
from repro_torch.kernels.aaren_scan import aaren_scan
from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd

def graph_ms(fn, n_iter):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_iter):
            fn()
    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n_iter)
    return statistics.median(times)

out = {}
for label, r, n, d, residuals in SHAPES:
    rng = np.random.default_rng(0)
    s, v, g = (torch.from_numpy((rng.standard_normal(shape) * k)
                                .astype(np.float32)).cuda()
               for shape, k in (((r, n), 3.0), ((r, n, d), 1.0),
                                ((r, n, d), 1.0)))
    m0 = torch.full((r, 1), NEG_INF, device="cuda")
    u0 = torch.zeros((r, 1), device="cuda")
    w0 = torch.zeros((r, d), device="cuda")
    fwd = lambda: aaren_scan(s, v, m0, u0, w0, return_residuals=residuals)
    res = fwd()
    out[label + " B1"] = [t.cpu() for t in res]
    times = {"B1": graph_ms(fwd, 20)}
    if residuals:
        o, m_f, u_f, w_f, m_all, u_all = res
        args = (s, v, o, m_all, u_all, g, -m_f, torch.ones_like(w_f),
                -torch.ones_like(u_f))
        out[label + " B2"] = [t.cpu() for t in aaren_scan_bwd(*args)]
        times["B2"] = graph_ms(lambda: aaren_scan_bwd(*args), 20)
    for k, ms in times.items():
        print(f"TIME {label} {k} {ms * 1e3:.2f}")
torch.save(out, sys.argv[1])
'''


def run_side(tree: Path, dump: Path) -> dict[str, float]:
    code = f"SHAPES = {SHAPES!r}\n" + SIDE
    proc = subprocess.run(
        [sys.executable, "-c", code, str(dump)], capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": str(tree / "src")},
        cwd=tree)
    if proc.returncode:
        raise RuntimeError(f"side {tree} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    times = {}
    for line in proc.stdout.splitlines():
        if line.startswith("TIME "):
            *key, us = line[5:].split()
            times[" ".join(key)] = float(us)
    return times


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--a", type=Path, required=True, help="tree A (parent)")
    ap.add_argument("--b", type=Path, required=True, help="tree B (change)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device is available", file=sys.stderr)
        return 1
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}
    with tempfile.TemporaryDirectory() as tmp:
        dumps = {side: Path(tmp) / f"{side}.pt" for side in trees}
        runs = []
        for side in "ABBA":
            runs.append((side, run_side(trees[side], dumps[side])))
        outs = {side: torch.load(dumps[side]) for side in trees}
    for side, times in runs:
        print(side, "  ".join(f"{k} {us:.2f} us" for k, us in times.items()))
    for key in outs["A"]:
        same = all(torch.equal(a, b)
                   for a, b in zip(outs["A"][key], outs["B"][key]))
        print(f"{key}: outputs of A and B bit-identical: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
