"""Paper Table 3/5 proxy — time series forecasting (MSE/MAE), Aaren vs
Transformer at identical hyperparameters on synthetic multivariate series;
the port's twin of ``benchmarks/bench_tsf.py``.

Run:  PYTHONPATH=.:src python -m benchmarks.torch.bench_tsf [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from benchmarks.torch.common import (
    backbone_apply,
    bench_cfg,
    compare_modes,
    emit,
    train_model,
)
from repro_torch.data.synthetic import TimeSeriesGenerator

L_IN, HORIZON, C = 96, 24, 4
STEPS, BATCH, TEST_BATCH, TEST_KEY = 200, 16, 64, 10_001


def _data(gen, batch, key):
    series, _ = gen.sample(batch, L_IN + HORIZON, key=key)
    series = series[:, :, :C]
    mu = series[:, :L_IN].mean(1, keepdims=True)
    sd = series[:, :L_IN].std(1, keepdims=True) + 1e-6
    series = (series - mu) / sd  # input normalization (Liu et al., 2022)
    return {"x": np.ascontiguousarray(series[:, :L_IN]),
            "y": series[:, L_IN:].reshape(batch, -1)}


def loss_fn(pred, batch):
    # direct multi-horizon head at the last position
    return ((pred[:, -1, :] - batch["y"]) ** 2).mean()


def errors(pred, y) -> tuple[float, float]:
    """(MSE, MAE) of the last position's forecast."""
    diff = pred[:, -1, :] - y
    return float((diff ** 2).mean()), float(diff.abs().mean())


def metric(mode, *, device="cuda", steps=STEPS, params=None) -> dict:
    """Train and evaluate one mode: {"metric" (MSE), "mae", "per_step",
    "losses"}."""
    gen = TimeSeriesGenerator(n_channels=8, seed=3)
    cfg = bench_cfg(mode)
    params, per_step, losses = train_model(
        cfg, C, HORIZON * C, loss_fn, lambda i: _data(gen, BATCH, i),
        steps=steps, device=device, params=params)
    dev = params["proj_in"].device
    test = _data(gen, TEST_BATCH, TEST_KEY)
    with torch.no_grad():
        pred = backbone_apply(cfg, params, torch.as_tensor(test["x"],
                                                           device=dev))
    mse, mae = errors(pred, torch.as_tensor(test["y"], device=dev))
    return {"metric": mse, "mae": mae, "per_step": per_step,
            "losses": losses}


def run(device="cuda", steps=STEPS) -> dict:
    """Both modes; returns {mode: metric()'s dict}."""
    results = {}

    def one(mode):
        results[mode] = r = metric(mode, device=device, steps=steps)
        emit(f"tsf_mae_{mode}", 0.0, f"{r['mae']:.4f}")
        return r["metric"], r["per_step"]

    compare_modes("tsf_mse", one)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
