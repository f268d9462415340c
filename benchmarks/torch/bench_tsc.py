"""Paper Table 4 proxy — time series classification (accuracy), Aaren vs
Transformer on synthetic frequency-band labelling; the port's twin of
``benchmarks/bench_tsc.py``.

Run:  PYTHONPATH=.:src python -m benchmarks.torch.bench_tsc [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.torch.common import (
    backbone_apply,
    bench_cfg,
    compare_modes,
    train_model,
)
from repro_torch.data.synthetic import TimeSeriesGenerator

L, C = 64, 4
STEPS, BATCH, TEST_BATCH, TEST_KEY = 200, 16, 128, 20_001


def _data(gen, batch, key):
    series, labels = gen.sample(batch, L, key=key)
    return {"x": np.ascontiguousarray(series[:, :, :C]),
            "y": labels.astype(np.int32)}


def loss_fn(pred, batch):
    logits = pred[:, -1, :]  # classify from the last position
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, batch["y"].long()[:, None]).mean()


def accuracy(pred, y) -> float:
    return float((pred[:, -1, :].argmax(-1) == y.long()).float().mean())


def metric(mode, *, device="cuda", steps=STEPS, params=None) -> dict:
    """Train and evaluate one mode: {"metric", "per_step", "losses"}."""
    gen = TimeSeriesGenerator(n_channels=C, seed=11)
    cfg = bench_cfg(mode)
    params, per_step, losses = train_model(
        cfg, C, 2, loss_fn, lambda i: _data(gen, BATCH, i), steps=steps,
        device=device, params=params)
    dev = params["proj_in"].device
    test = _data(gen, TEST_BATCH, TEST_KEY)
    with torch.no_grad():
        pred = backbone_apply(cfg, params, torch.as_tensor(test["x"],
                                                           device=dev))
    acc = accuracy(pred, torch.as_tensor(test["y"], device=dev))
    return {"metric": acc, "per_step": per_step, "losses": losses}


def run(device="cuda", steps=STEPS) -> dict:
    """Both modes; returns {mode: metric()'s dict}."""
    results = {}

    def one(mode):
        results[mode] = metric(mode, device=device, steps=steps)
        return results[mode]["metric"], results[mode]["per_step"]

    compare_modes("tsc_acc", one, lower_better=False)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
