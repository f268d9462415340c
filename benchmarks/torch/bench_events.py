"""Paper Table 2 proxy — event forecasting (NLL / RMSE / mark accuracy) on
synthetic Hawkes-like marked streams, Aaren vs Transformer; the port's twin
of ``benchmarks/bench_events.py``.

Next-event-time density: a mixture of log-normals (Bae et al., 2023); mark
head: categorical — the THP+ setup the paper uses, on the offline Hawkes
generator.

Run:  PYTHONPATH=.:src python -m benchmarks.torch.bench_events [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.torch.common import (
    backbone_apply,
    bench_cfg,
    compare_modes,
    emit,
    train_model,
)
from repro_torch.data.synthetic import EventStreamGenerator

N_EVENTS, N_MARKS, N_MIX = 48, 8, 3
STEPS, BATCH, TEST_BATCH, TEST_KEY = 150, 8, 32, 30_001
OUT_DIM = 3 * N_MIX + N_MARKS


def _data(gen, batch, key):
    dt, marks = gen.sample(batch, N_EVENTS + 1, key=key)
    # inputs: (log dt, one-hot mark) per event; predict next dt + mark
    x = np.concatenate(
        [np.log1p(dt[:, :-1])[..., None],
         np.eye(N_MARKS, dtype=np.float32)[marks[:, :-1]]], axis=-1)
    return {"x": x,
            "dt_next": np.ascontiguousarray(dt[:, 1:]),
            "mark_next": marks[:, 1:].astype(np.int32)}


def lognormal_mix_nll(params, dt):
    """params: (..., 3*N_MIX) -> -log p(dt) under a log-normal mixture."""
    w, mu, log_sig = params.split(N_MIX, dim=-1)
    logw = F.log_softmax(w, dim=-1)
    sig = torch.exp(log_sig.clamp(-5, 3))
    x = torch.log(dt.clamp(min=1e-6))[..., None]
    comp = (-0.5 * ((x - mu) / sig) ** 2 - torch.log(sig)
            - 0.5 * math.log(2 * math.pi) - x)  # incl. d log(dt)/d dt
    return -torch.logsumexp(logw + comp, dim=-1)


def loss_fn(pred, batch):
    t_par, m_log = pred[..., :3 * N_MIX], pred[..., 3 * N_MIX:]
    nll_t = lognormal_mix_nll(t_par, batch["dt_next"])
    logp_m = F.log_softmax(m_log, dim=-1)
    nll_m = -logp_m.gather(-1, batch["mark_next"].long()[..., None])[..., 0]
    return (nll_t + nll_m).mean()


def scores(pred, dt_next, mark_next) -> dict:
    """Test NLL of the next time, RMSE of the mixture-median time, and the
    mark accuracy."""
    t_par, m_log = pred[..., :3 * N_MIX], pred[..., 3 * N_MIX:]
    nll = float(lognormal_mix_nll(t_par, dt_next).mean())
    w, mu, _ = t_par.split(N_MIX, dim=-1)
    med = torch.exp((torch.softmax(w, -1) * mu).sum(-1))
    rmse = float(torch.sqrt(((med - dt_next) ** 2).mean()))
    acc = float((m_log.argmax(-1) == mark_next.long()).float().mean())
    return {"nll": nll, "rmse": rmse, "markacc": acc}


def metric(mode, *, device="cuda", steps=STEPS, params=None) -> dict:
    """Train and evaluate one mode: {"metric" (NLL), "rmse", "markacc",
    "per_step", "losses"}."""
    gen = EventStreamGenerator(seed=5)
    cfg = bench_cfg(mode)
    params, per_step, losses = train_model(
        cfg, 1 + N_MARKS, OUT_DIM, loss_fn, lambda i: _data(gen, BATCH, i),
        steps=steps, device=device, params=params)
    dev = params["proj_in"].device
    test = {k: torch.as_tensor(v, device=dev)
            for k, v in _data(gen, TEST_BATCH, TEST_KEY).items()}
    with torch.no_grad():
        pred = backbone_apply(cfg, params, test["x"])
    got = scores(pred, test["dt_next"], test["mark_next"])
    return {"metric": got["nll"], "rmse": got["rmse"],
            "markacc": got["markacc"], "per_step": per_step,
            "losses": losses}


def run(device="cuda", steps=STEPS) -> dict:
    """Both modes; returns {mode: metric()'s dict}."""
    results = {}

    def one(mode):
        results[mode] = r = metric(mode, device=device, steps=steps)
        emit(f"events_rmse_{mode}", 0.0, f"{r['rmse']:.4f}")
        emit(f"events_markacc_{mode}", 0.0, f"{r['markacc']:.4f}")
        return r["metric"], r["per_step"]

    compare_modes("events_nll", one)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
