#!/usr/bin/env python3
"""A/B of the full-width Aaren training step of two trees of the port, on
one card.

Each side runs in its own process from its own root, with its own ``src/``
on the path, and calls its own ``chip_smoke.py::phase4b_training`` at the
full width of phi3-mini-3.8b: plain batches (phase 4b) and packed ones
(phase 4e), 1 warm-up and 4 measured steps each, with that phase's checks.
The sides run in turns — A, B, B, A — because the step's host time varies
from run to run by more than a kernel's gain.  The script prints each run's
step medians and peak memory and B's step time against A's.

    git archive <parent> | tar -x -C build/parent
    python3 benchmarks/torch/train_step_ab.py --a build/parent --b .
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

SIDE = r'''
import numpy as np, torch
import chip_smoke as cs
from repro_torch.configs import get_config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs._card_line()
cfg = get_config(cs.ARCH)
for packed in (False, True):
    cs.phase4b_training(torch, np, card, cfg, packed=packed)
'''

# What phase4b_training prints, in its order: plain, then packed.
STEP = re.compile(r"step median ([0-9.]+) ms")
PEAK = re.compile(r"peak memory allocated ([0-9.]+) GiB")


def run_side(tree: Path) -> dict[str, float]:
    proc = subprocess.run(
        [sys.executable, "-c", SIDE], capture_output=True, text=True,
        cwd=tree, env={**os.environ, "PYTHONPATH": f"{tree}:{tree / 'src'}"})
    if proc.returncode:
        raise RuntimeError(f"side {tree} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    steps = [float(x) for x in STEP.findall(proc.stdout)]
    peaks = [float(x) for x in PEAK.findall(proc.stdout)]
    if len(steps) != 2 or len(peaks) != 2:
        raise RuntimeError(f"side {tree}: unexpected output\n{proc.stdout}")
    return {"step ms": steps[0], "packed step ms": steps[1],
            "peak GiB": peaks[0], "packed peak GiB": peaks[1]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--a", type=Path, required=True, help="tree A (parent)")
    ap.add_argument("--b", type=Path, required=True, help="tree B (change)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step_ab: no CUDA device is available", file=sys.stderr)
        return 1
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}
    runs = [(side, run_side(trees[side])) for side in "ABBA"]
    for side, got in runs:
        print(side, "  ".join(f"{k} {v:.3f}" for k, v in got.items()))
    for key in ("step ms", "packed step ms"):
        a = [got[key] for side, got in runs if side == "A"]
        b = [got[key] for side, got in runs if side == "B"]
        print(f"{key}: A {statistics.mean(a):.3f}, B {statistics.mean(b):.3f}"
              f" (mean of two runs each); B / A = "
              f"{statistics.mean(b) / statistics.mean(a):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
