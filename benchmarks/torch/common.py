"""Shared scaffolding of the paper-table proxies on the PyTorch port — the
twin of ``benchmarks/common.py``.

Each proxy builds the same backbone twice — ``attn_mode='aaren'`` (the
paper's module) and ``attn_mode='softmax'`` (the Transformer baseline) —
from the port's ``models.blocks``, trains both with identical
hyperparameters (the paper's protocol, §4), and reports the task metric of
each.  The data comes from the offline generators of
``repro_torch.data.synthetic``, which mirror the paper's tasks' structure.

Everything runs on ``device`` (the card unless the caller asks for the
CPU): the Aaren backbone through the prefix-scan kernels B1 and B2, the
softmax one through the flash kernels B3, B4 and B5, in f32 at head dim 16.

``write_bench`` writes a ``BENCH_<name>.json`` stamped with the port's
``obs/events.run_metadata``, for the port's benchmark (ROADMAP queue A
item 12); no proxy calls it, as no JAX proxy does.
"""

from __future__ import annotations

import json
import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.convert import tree_to_torch
from repro_torch.models.layers import apply_norm, norm_specs
from repro_torch.models.param import ParamSpec, init_params
from repro_torch.obs.events import run_metadata
from repro_torch.train.optim import adamw, warmup_cosine
from repro_torch.train.state import init_train_state, make_train_step

ROWS: list[tuple] = []


def emit(name: str, us_per_call: float, derived):
    """Collect and print one CSV row: name,us_per_call,derived."""
    row = (name, f"{us_per_call:.1f}", str(derived))
    ROWS.append(row)
    print(",".join(row), flush=True)


def write_bench(name: str, payload: dict) -> str:
    """Write ``BENCH_<name>.json`` stamped with run provenance.

    Every benchmark artifact goes through here so each one carries the same
    ``meta`` block (:func:`repro_torch.obs.events.run_metadata` — git sha,
    torch and card info, UTC timestamp) and a ``schema_version``.  Payload
    keys stay at the top level.  Returns the path written.
    """
    path = f"BENCH_{name}.json"
    doc = {**payload, "schema_version": 1, "meta": run_metadata()}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}", flush=True)
    return path


def bench_cfg(attn_mode: str, *, d_model=64, n_layers=2, n_heads=4,
              d_ff=128) -> ArchConfig:
    """Paper-scale-reduced backbone config (Appendix E shape, shrunk)."""
    return ArchConfig(
        name=f"bench-{attn_mode}", family="dense", n_layers=n_layers,
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads, d_ff=d_ff,
        vocab=2, pattern=("attn",), mlp_pattern=("gelu",),
        norm="layernorm", attn_mode=attn_mode, remat="none",
        param_dtype="float32", compute_dtype="float32",
    )


def _sig(cfg: ArchConfig):
    return (cfg.effective_pattern()[0], cfg.mlp_pattern[0])


def backbone_specs(cfg: ArchConfig, in_dim: int, out_dim: int) -> dict:
    return {
        "proj_in": ParamSpec((in_dim, cfg.d_model)),
        "blocks": [blocks.block_specs(_sig(cfg), cfg)
                   for _ in range(cfg.n_layers)],
        "norm": norm_specs(cfg.d_model, cfg.norm),
        "head": ParamSpec((cfg.d_model, out_dim)),
    }


def init_backbone(cfg: ArchConfig, in_dim: int, out_dim: int, seed: int,
                  device="cuda") -> dict:
    """Random backbone parameters from ``seed`` on ``device``."""
    return init_params(backbone_specs(cfg, in_dim, out_dim), seed,
                       getattr(torch, cfg.param_dtype),
                       resolve_device(device))


def backbone_params_from_jax(np_tree: dict, cfg: ArchConfig,
                             device) -> dict:
    """The JAX backbone's parameters (numpy leaves: ``proj_in``, a tuple of
    block dicts, ``norm``, ``head``) as the port's tree on ``device``."""
    if len(np_tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(np_tree['blocks'])} blocks for "
                         f"{cfg.n_layers} layers")
    return tree_to_torch({key: np_tree[key] for key in
                          ("proj_in", "blocks", "norm", "head")},
                         resolve_device(device))


def backbone_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, N, in_dim) -> (B, N, out_dim); a causal sequence model."""
    h = x @ p["proj_in"]
    for bp in p["blocks"]:
        h, _ = blocks.block_sequence(bp, h, _sig(cfg), cfg)
    h = apply_norm(p["norm"], h, cfg.norm)
    return h @ p["head"]


def train_model(cfg: ArchConfig, in_dim: int, out_dim: int, loss_fn,
                data_fn, *, steps: int = 150, lr: float = 2e-3,
                seed: int = 0, device="cuda", params: dict | None = None):
    """Generic trainer: AdamW on ``warmup_cosine(lr, steps // 10, steps)``,
    gradients clipped to global norm 1.

    loss_fn(pred, batch) -> scalar; data_fn(step) -> {"x": (B, N, in_dim),
    ...labels} of numpy arrays.  Starts from ``params`` when given (updated
    in place), else from :func:`init_backbone` with ``seed``.  Returns
    (params, seconds per step, per-step training losses).
    """
    if params is None:
        params = init_backbone(cfg, in_dim, out_dim, seed, device)
    dev = params["proj_in"].device

    def loss_and_metrics(p, batch):
        loss = loss_fn(backbone_apply(cfg, p, batch["x"]), batch)
        return loss, {"loss": loss.detach()}

    opt = adamw(warmup_cosine(lr, steps // 10, steps))
    state = init_train_state(params, opt)
    step = make_train_step(loss_and_metrics, opt, max_grad_norm=1.0)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = step(state, data_fn(i))
        losses.append(metrics["loss"])
    losses = torch.stack(losses).tolist()  # waits for the last step
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    per_step = (time.perf_counter() - t0) / steps
    return state.params, per_step, losses


def compare_modes(task: str, metric_fn, *, lower_better=True):
    """Run metric_fn(attn_mode) -> (metric, s/step) for both modes, emit a
    row for each and the parity row.  Returns {mode: metric}."""
    out = {}
    for mode in ("aaren", "softmax"):
        metric, per_step = metric_fn(mode)
        label = "aaren" if mode == "aaren" else "transformer"
        emit(f"{task}_{label}", per_step * 1e6, f"{metric:.4f}")
        out[mode] = metric
    a, s = out["aaren"], out["softmax"]
    rel = abs(a - s) / max(abs(s), 1e-9)
    emit(f"{task}_parity_relgap", 0.0, f"{rel:.3f}")
    return out
