"""Carry parameters and decode states across from the JAX package's layout.

The JAX package stacks the parameters of every full period of layers along
a leading axis (``params["periods"][pos]``, one tree per pattern position)
and keeps the remainder layers in ``params["rest"]``; its decode states
follow the same layout (``ScanState`` carries or KV-cache dicts).  The port
keeps one flat list of layers.  :func:`params_from_jax` takes the JAX
parameter tree as numpy arrays and returns the port's parameters, so both
packages compute the same function (trees with or without Aaren's
``query`` leaf copy alike); :func:`states_to_jax_layout` turns a port
decode state into the JAX layout for comparison.  Only numpy crosses the
boundary: this module imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.scan_attention import ScanState
from repro_torch.tree import tree_map


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tree_to_torch(np_tree, device):
    """A tree of numpy arrays (dicts, lists, tuples) -> the same tree of
    tensors on ``device`` (tuples come back as lists)."""
    return tree_map(lambda a: _to_torch(a, device), np_tree)


def params_from_jax(np_tree: dict, cfg: ArchConfig, device) -> dict:
    """JAX ``lm_specs`` layout (numpy leaves) -> the port's parameter tree.

    Layer ``i·len(pattern) + pos`` is period ``i`` of ``periods[pos]``;
    the ``rest`` layers follow in order.
    """
    n_periods, n_rest = cfg.layer_plan()
    period = len(cfg.pattern)
    layers = []

    for i in range(n_periods):
        for pos in range(period):
            layers.append(tree_to_torch(
                tree_map(lambda a, i=i: np.asarray(a)[i],
                         np_tree["periods"][pos]), device))
    for r in range(n_rest):
        layers.append(tree_to_torch(np_tree["rest"][r], device))
    out = {"embed": tree_to_torch(np_tree["embed"], device),
           "final_norm": tree_to_torch(np_tree["final_norm"], device),
           "layers": layers}
    if "unembed" in np_tree:
        out["unembed"] = tree_to_torch(np_tree["unembed"], device)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: compare in f32
        t = t.float()
    return t.numpy()


def states_to_jax_layout(cfg: ArchConfig, states: list) -> dict:
    """Port decode state -> ``{"periods": (state stacked over periods, one
    per pattern position), "rest": (state, ...)}`` of numpy arrays, the
    layout of the JAX package's ``lm_state_init``.  A layer's state is a
    ``ScanState`` carry or a KV-cache dict (``k``, ``v``, ``index`` and, from
    a ragged prefill, ``prompt_lens``, ``prompt_pad``); bf16 leaves come
    back as f32."""
    n_periods, n_rest = cfg.layer_plan()
    period = len(cfg.pattern)
    host = [tree_map(_to_numpy, st) if isinstance(st, dict)
            else ScanState(*(_to_numpy(t) for t in st)) for st in states]

    def stack(layers):
        if isinstance(layers[0], dict):
            return {key: np.stack([x[key] for x in layers])
                    for key in layers[0]}
        return ScanState(*(np.stack([x[f] for x in layers])
                           for f in range(3)))

    out = {}
    if n_periods:
        out["periods"] = tuple(
            stack([host[i * period + pos] for i in range(n_periods)])
            for pos in range(period))
    if n_rest:
        out["rest"] = tuple(host[n_periods * period:])
    return out
