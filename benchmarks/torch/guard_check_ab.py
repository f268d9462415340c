"""Time the guard's all-finite check on the card, two predicates in turns.

``train/guard.py::all_finite`` takes the JAX package's predicate,
``isfinite(sum(0 * x))`` per leaf (two full passes: the product and the
sum); the alternative is ``isfinite(x).all()`` (in eager torch ``isfinite``
is an abs, two compares and their product, then the reduction).  Both run
over the loss and a tree of the model's shapes and dtypes (its parameters
stand in for the gradients, which share them).

For each predicate and pair: the device time of one check from a replayed
CUDA graph (no host in it), and the host-clock time of one eager check
ending in its host read (what a guarded step pays).  Pairs alternate which
predicate runs first.  Prints the medians and the quartile spread, the
card's name and power limit.

Run from the root of the repository on a machine with a card:

    PYTHONPATH=src python3 -m benchmarks.torch.guard_check_ab \\
        [--arch phi3-mini-3.8b] [--pairs 10]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.factory import build
from repro_torch.train.guard import all_finite
from repro_torch.tree import tree_leaves


def isfinite_all(*trees) -> torch.Tensor:
    """The alternative predicate: ``isfinite(x).all()`` per floating leaf."""
    return torch.stack([torch.isfinite(x).all()
                        for t in trees for x in tree_leaves(t)
                        if x.dtype.is_floating_point]).all()


def graph_ms(fn, n_iter: int = 5) -> float:
    """Device ms of one ``fn()``, from ``n_iter`` calls in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_iter):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def host_ms(fn) -> float:
    """Host-clock ms of one eager ``fn()`` ending in its host read."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    ok = bool(fn())
    ms = (time.perf_counter() - t) * 1e3
    if not ok:
        raise AssertionError("a finite tree was read as not finite")
    return ms


def _spread(xs) -> str:
    q = statistics.quantiles(xs, n=4)
    return (f"median {statistics.median(xs):.3f} ms, quartiles "
            f"{q[0]:.3f}-{q[2]:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("guard_check_ab: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    params = build(cfg).init(0, device="cuda")
    loss = torch.zeros((), device="cuda")
    leaves = tree_leaves(params)
    print(f"{cfg.name}: {len(leaves)} leaves, "
          f"{sum(t.numel() for t in leaves)} elements of "
          f"{sorted({str(t.dtype) for t in leaves})}  [{card}]")
    preds = {"isfinite(sum(0*x))": lambda: all_finite(loss, params),
             "isfinite(x).all()": lambda: isfinite_all(loss, params)}

    # Both predicates see a NaN and an inf in one leaf.
    probe = leaves[-1].view(-1)
    saved = probe[0].clone()
    with torch.no_grad():
        for bad in (float("nan"), float("inf")):
            probe[0] = bad
            for name, fn in preds.items():
                if bool(fn()):
                    raise AssertionError(f"{name} missed {bad}")
        probe[0] = saved

    host = {name: [] for name in preds}
    device = {name: [] for name in preds}
    for fn in preds.values():
        host_ms(fn)
    for i in range(args.pairs):
        order = list(preds) if i % 2 == 0 else list(reversed(preds))
        for name in order:
            host[name].append(host_ms(preds[name]))
        for name in order:
            device[name].append(graph_ms(preds[name]))
    for name in preds:
        print(f"{name:20s} device {_spread(device[name])}; host with the "
              f"read {_spread(host[name])}  [{card}]")


if __name__ == "__main__":
    main()
