"""Mixture-of-Experts MLP: top-k router + grouped dispatch — port of
``repro.models.moe``.

Each batch row dispatches independently with its own capacity
``C = ceil(N · k / E · capacity_factor)`` (GShard's groups): top-k on an
f32 router, the rank of each routed token within its (row, expert) group
by a stable sort, and a scatter into a ``(B, E·(C+1), d)`` buffer whose
per-expert slot ``C`` is the trash of the overflow tokens.  The trash is
dropped before the experts run and reads back as zeros, so the residual
path carries a dropped token (Switch semantics); several overflow tokens
may write one trash row in any order, and nothing reads it.  The expert
SwiGLUs are plain batched matrix products, as in the JAX package (which
runs them outside any Pallas kernel).

The JAX package's ``constrain`` calls are sharding hints that are the
identity on one device, so the port has none; they come back with the
multi-device layers (ROADMAP queue A item 11).  ``decode=`` only selects
those hints there, and here it changes nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.param import ParamSpec


def moe_specs(cfg: ArchConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    return {
        "router": ParamSpec((d, e)),
        "wi_gate": ParamSpec((e, d, f)),
        "wi_up": ParamSpec((e, d, f)),
        "wo": ParamSpec((e, f, d)),
    }


def expert_capacity(n_tokens_per_group: int, cfg: ArchConfig) -> int:
    ideal = n_tokens_per_group * cfg.n_experts_per_tok / cfg.n_experts
    return max(int(math.ceil(ideal * cfg.capacity_factor)), 1)


def apply_moe(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
              return_aux: bool = False, decode: bool = False):
    """x: (B, N, D) -> (B, N, D) [+ aux dict with the load-balancing loss
    and the fraction of routed tokens dropped]."""
    del decode  # selects sharding hints only (module docstring)
    b, n, d = x.shape
    k = cfg.n_experts_per_tok
    e = cfg.n_experts
    cap = expert_capacity(n, cfg)

    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (b, n, k)
    # dbrx/qwen renormalise the selected gates
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # --- rank of each routed token within (row, expert) --------------------
    nk = n * k
    flat_ids = expert_ids.reshape(b, nk)
    order = torch.argsort(flat_ids, dim=1, stable=True)
    sorted_ids = flat_ids.gather(1, order)
    idx = torch.arange(nk, device=x.device)[None, :]
    is_start = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=x.device),
         sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    rank_sorted = idx - seg_start
    pos = torch.zeros_like(flat_ids).scatter_(1, order, rank_sorted)
    keep = pos < cap
    # destination row in the (E, C+1) buffer; C is the trash slot
    dest = flat_ids * (cap + 1) + torch.where(keep, pos, cap)   # (b, nk)
    rows = (dest + torch.arange(b, device=x.device)[:, None]
            * (e * (cap + 1))).reshape(-1)

    # --- scatter into per-row expert buffers, trash dropped ----------------
    xrep = x.repeat_interleave(k, dim=1).reshape(b * nk, d)
    buf = x.new_zeros((b * e * (cap + 1), d)).index_copy(0, rows, xrep)
    buf = buf.reshape(b, e, cap + 1, d)[:, :, :cap, :]

    # --- expert MLPs (SwiGLU) ------------------------------------------------
    gate = torch.einsum("becd,edf->becf", buf, p["wi_gate"].to(buf.dtype))
    up = torch.einsum("becd,edf->becf", buf, p["wi_up"].to(buf.dtype))
    h = F.silu(gate.float()).to(buf.dtype) * up
    out = torch.einsum("becf,efd->becd", h, p["wo"].to(buf.dtype))

    # --- gather back + weighted combine -------------------------------------
    out_flat = F.pad(out, (0, 0, 0, 1)).reshape(b * e * (cap + 1), d)
    yrep = out_flat.index_select(0, rows).reshape(b, nk, d)
    w = (gate_vals.reshape(b, nk, 1).to(out.dtype)
         * keep[..., None].to(out.dtype))
    y = (yrep * w).reshape(b, n, k, d).sum(dim=2)

    if not return_aux:
        return y
    # Switch-style load-balancing auxiliary loss; expert densities by a
    # scatter-add into a (b, E) tensor.
    counts = torch.zeros((b, e), dtype=torch.float32,
                         device=x.device).scatter_add_(
        1, flat_ids, torch.ones_like(flat_ids, dtype=torch.float32))
    density = counts.sum(dim=0) / (b * n * k)
    router_mean = probs.mean(dim=(0, 1))
    aux = {"load_balance_loss": e * (density * router_mean).sum(),
           "dropped_frac": 1.0 - keep.float().mean()}
    return y, aux
