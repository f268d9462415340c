#!/usr/bin/env python3
"""A/B of the kernels B1–B5 of two trees of the port, on one card.

Each side runs in its own process with its own ``src/`` on the path, so it
builds and calls its own CUDA sources through its own wrappers, on the same
numpy inputs.  The sides run in turns — A, B, B, A — and the script prints
each run's device time (one launch inside a replayed CUDA graph) and B's
speed-up over A.  Shapes are phi3-mini-3.8b's: the Aaren scans at the
serving tick and the training shape, the flash kernels at the training
shape, bf16 and f32, without and with segment ids (packed documents).

Outputs: every call must give bit-identical outputs on both sides, except
the calls of the kernels in ``CHANGED`` (the ones tree B redesigned: B2,
a chunked parallel suffix scan, plain and segmented).  For those it prints
max |A - B|, whether the maxima (B1's ``m``, B2's ``n1``) are
bit-identical, and each side's max |error| against the plain version
computed in f32 on the same inputs.  The backward kernels of both sides
read the same residuals (from the plain forwards: B2 the plain scan's
``o``, ``m``, ``u``; B4 and B5 the plain flash forward's ``lse`` and
``delta``), so a changed forward does not change a backward's inputs.
Exits 1 when an output that must be bit-identical is not.

    git archive <parent> | tar -x -C build/parent
    python3 benchmarks/torch/kernels_ab.py --a build/parent --b .
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

# B, H = G, N, d of the flash kernels (causal)
FLASH_SHAPE = (4, 32, 1024, 96)

# Kernels whose outputs tree B changed, with the dtype of the changed calls
# (None: every call): compared by error against the plain version, not by
# bits.
CHANGED = {"B2": None}

SIDE = r'''
import math, statistics, sys
import numpy as np, torch
from repro_torch.core.scan_attention import NEG_INF
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.aaren_scan import aaren_scan, aaren_scan_plain
from repro_torch.kernels.aaren_scan_bwd import (aaren_scan_bwd,
                                                aaren_scan_bwd_plain)

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

def as_list(res):
    return [t.cpu() for t in (res if isinstance(res, tuple) else (res,))]

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
    out[label + " B1"] = as_list(fwd())
    plain = aaren_scan_plain(s, v, m0, u0, w0, return_residuals=residuals)
    out["plain " + label + " B1"] = as_list(plain)
    times = {"B1": graph_ms(fwd, 20)}
    if residuals:
        # B2 reads the plain scan's residuals on both sides.
        o, m_f, u_f, w_f, m_all, u_all = plain
        args = (s, v, o, m_all, u_all, g, -m_f, torch.ones_like(w_f),
                -torch.ones_like(u_f))
        out[label + " B2"] = as_list(aaren_scan_bwd(*args))
        out["plain " + label + " B2"] = as_list(aaren_scan_bwd_plain(*args))
        times["B2"] = graph_ms(lambda: aaren_scan_bwd(*args), 20)
        # Packed rows: documents end at ~1 % of the tokens.
        ends = torch.from_numpy(rng.random((r, n)) < 0.01).cuda()
        out[label + " segmented B2"] = as_list(
            aaren_scan_bwd(*args, segment_ends=ends))
        out["plain " + label + " segmented B2"] = as_list(
            aaren_scan_bwd_plain(*args, segment_ends=ends))
        times["segmented B2"] = graph_ms(
            lambda: aaren_scan_bwd(*args, segment_ends=ends), 20)
    for k, ms in times.items():
        print(f"TIME {label} {k} {ms * 1e3:.2f}")

def doc_ids(b, n, seed):
    """Packed rows: documents of 8 + 1016 u^3 tokens, ids from 1, the
    last one cut at n and a padding tail of up to 100 tokens."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, n), np.int32)
    for r in range(b):
        a, sid, stop = 0, 1, n - int(rng.integers(0, 101))
        while a < stop:
            c = min(stop, a + 8 + int(1016 * rng.random() ** 3))
            ids[r, a:c] = sid
            a, sid = c, sid + 1
    return torch.from_numpy(ids).cuda()

b, h, n, d = FLASH_SHAPE
rng = np.random.default_rng(1)
base = [torch.from_numpy(rng.standard_normal((b, h, n, d))
                         .astype(np.float32)).cuda() for _ in range(4)]
lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
ids = doc_ids(b, n, 2)
for dtype in ("bf16", "f32"):
    q, k, v, do = (t.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
                   for t in base)
    for form, seg in (("", None), ("segmented ", ids)):
        kw = dict(causal=True, window=None, scale=1.0 / math.sqrt(d))
        fwd_kw = dict(kw, q_segment_ids=seg, kv_segment_ids=seg)
        bwd_kw = dict(kw, q_seg=seg, kv_seg=seg)
        # lse and delta from the plain forward: both sides' backward
        # kernels read the same residuals.
        o_p, lse = fa.flash_attention_plain(q, k, v, lens, lens, **bwd_kw)
        delta = (do.float() * o_p.float()).sum(dim=-1).contiguous()
        args = (q, k, v, do, lse, delta, lens, lens)
        calls = {"B3": lambda: fa.flash_attention(q, k, v,
                                                  return_residuals=True,
                                                  **fwd_kw),
                 "B4": lambda: fa.flash_bwd_dq(*args, **bwd_kw),
                 "B5": lambda: fa.flash_bwd_dkv(*args, **bwd_kw)}
        if dtype == "bf16":
            f = [t.float() for t in (q, k, v, do)]
            out[f"plain flash {form}bf16 B4"] = as_list(
                fa.flash_bwd_dq_plain(*f, lse, delta, lens, lens, **bwd_kw))
        for key, fn in calls.items():
            out[f"flash {form}{dtype} {key}"] = as_list(fn())
            print(f"TIME flash {form}{dtype} {key} "
                  f"{graph_ms(fn, 10) * 1e3:.2f}")
        del o_p, lse, delta, args, calls
        torch.cuda.empty_cache()
torch.save(out, sys.argv[1])
'''


def run_side(tree: Path, dump: Path) -> dict[str, float]:
    code = f"SHAPES = {SHAPES!r}\nFLASH_SHAPE = {FLASH_SHAPE!r}\n" + SIDE
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
        print("kernels_ab: no CUDA device is available", file=sys.stderr)
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
    for key in runs[0][1]:
        a = [t[key] for s, t in runs if s == "A"]
        b = [t[key] for s, t in runs if s == "B"]
        print(f"{key}: B is {a[0] / b[0]:.2f}x and {a[1] / b[1]:.2f}x as "
              "fast as A (run 1 over run 2, run 4 over run 3)")
    broken = []
    for key in outs["A"]:
        if key.startswith("plain "):
            continue
        pa, pb = outs["A"][key], outs["B"][key]
        kernel = key.split()[-1]
        if kernel in CHANGED and (CHANGED[kernel] is None
                                  or f" {CHANGED[kernel]} " in key):
            plain = outs["B"]["plain " + key]
            diff = max((x.float() - y.float()).abs().max().item()
                       for x, y in zip(pa, pb))
            err = {side: max((x.float() - y.float()).abs().max().item()
                             for x, y in zip(outs[side][key], plain))
                   for side in "AB"}
            # B1: m_f and, with residuals, m_all; B2: n1
            at = range(1, len(pa), 3) if kernel == "B1" else (2,)
            same = all(torch.equal(pa[i], pb[i]) for i in at)
            maxima = (f"; {'m' if kernel == 'B1' else 'n1'} bit-identical: "
                      f"{same}")
            if not same:
                broken.append(key)
            print(f"{key}: max |A - B| {diff:.3e}{maxima}; max |side - plain "
                  f"f32| A {err['A']:.3e}, B {err['B']:.3e}")
            continue
        same = all(torch.equal(x, y) for x, y in zip(pa, pb))
        print(f"{key}: outputs of A and B bit-identical: {same}")
        if not same:
            broken.append(key)
    if broken:
        print("NOT bit-identical: " + ", ".join(broken))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
