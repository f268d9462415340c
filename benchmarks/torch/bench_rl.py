"""Paper Table 1 proxy — offline RL with return-conditioned sequence
modelling (the Decision-Transformer protocol), Aaren vs Transformer; the
port's twin of ``benchmarks/bench_rl.py``.

Environment: a deterministic 1-D "key-door" grid (state = position, actions
= left/stay/right, reward at the goal).  The offline dataset mixes optimal
and random trajectories ("medium" style); the model learns to predict
actions from (return-to-go, state, previous action) streams, then is
evaluated by an online rollout conditioned on the expert return — the
metric is the achieved return (higher is better), like D4RL scores.  The
rollout runs one forward per token under ``torch.no_grad()``.

Run:  PYTHONPATH=.:src python -m benchmarks.torch.bench_rl [--device cpu]
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

GRID, T = 9, 16
GOAL = GRID - 1
N_ACT = 3  # left / stay / right
STEPS, BATCH = 150, 16


def _rollout_policy(rng, eps):
    """One trajectory with an eps-greedy-to-goal policy."""
    pos = rng.integers(0, GRID)
    states, actions, rewards = [], [], []
    for _ in range(T):
        opt = 2 if pos < GOAL else (1 if pos == GOAL else 0)
        a = rng.integers(0, N_ACT) if rng.random() < eps else opt
        states.append(pos)
        actions.append(a)
        pos = int(np.clip(pos + (a - 1), 0, GRID - 1))
        rewards.append(1.0 if pos == GOAL else 0.0)
    return np.array(states), np.array(actions), np.array(rewards,
                                                         np.float32)


def _batch(rng, batch):
    xs, ys = [], []
    for _ in range(batch):
        s, a, r = _rollout_policy(rng, eps=rng.uniform(0.1, 0.9))
        rtg = np.cumsum(r[::-1])[::-1]  # return-to-go
        feat = np.stack([rtg / T,
                         s / (GRID - 1),
                         np.roll(a, 1) / N_ACT], axis=-1)  # prev action
        feat[0, 2] = 0.0
        xs.append(feat)
        ys.append(a)
    return {"x": np.stack(xs).astype(np.float32),
            "y": np.stack(ys).astype(np.int32)}


def loss_fn(pred, batch):
    logp = F.log_softmax(pred, dim=-1)
    return -logp.gather(-1, batch["y"].long()[..., None]).mean()


@torch.no_grad()
def online_return(cfg, params, target_rtg=4.0, episodes=16) -> float:
    """Deploy the trained policy, conditioned on an expert-level return."""
    dev = params["proj_in"].device
    total = 0.0
    for ep in range(episodes):
        pos, rtg = ep % GRID, target_rtg
        feats = []
        prev_a = 0
        for _ in range(T):
            feats.append([rtg / T, pos / (GRID - 1), prev_a / N_ACT])
            x = torch.tensor(feats, dtype=torch.float32, device=dev)[None]
            a = int(backbone_apply(cfg, params, x)[0, -1].argmax())
            pos = int(np.clip(pos + (a - 1), 0, GRID - 1))
            r = 1.0 if pos == GOAL else 0.0
            rtg = max(rtg - r, 0.0)
            total += r
            prev_a = a
    return total / episodes


def metric(mode, *, device="cuda", steps=STEPS, params=None) -> dict:
    """Train and evaluate one mode: {"metric" (return), "per_step",
    "losses"}."""
    cfg = bench_cfg(mode)
    rng = np.random.default_rng(0)
    params, per_step, losses = train_model(
        cfg, 3, N_ACT, loss_fn, lambda i: _batch(rng, BATCH), steps=steps,
        device=device, params=params)
    return {"metric": online_return(cfg, params), "per_step": per_step,
            "losses": losses}


def run(device="cuda", steps=STEPS) -> dict:
    """Both modes; returns {mode: metric()'s dict}."""
    results = {}

    def one(mode):
        results[mode] = metric(mode, device=device, steps=steps)
        return results[mode]["metric"], results[mode]["per_step"]

    compare_modes("rl_return", one, lower_better=False)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
