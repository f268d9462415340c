"""Carry parameters and decode states across from the JAX package's layout.

The JAX package stacks the parameters of every full period of layers along
a leading axis (``params["periods"][pos]``, one tree per pattern position)
and keeps the remainder layers in ``params["rest"]``; its decode states
follow the same layout with ``ScanState`` leaves.  The port keeps one flat
list of layers.  :func:`params_from_jax` takes the JAX parameter tree as
numpy arrays and returns the port's parameters, so both packages compute
the same function; :func:`states_to_jax_layout` turns a port decode state
into the JAX layout for comparison.  Only numpy crosses the boundary: this
module imports nothing of the JAX package.
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


def params_from_jax(np_tree: dict, cfg: ArchConfig, device) -> dict:
    """JAX ``lm_specs`` layout (numpy leaves) -> the port's parameter tree.

    Layer ``i·len(pattern) + pos`` is period ``i`` of ``periods[pos]``;
    the ``rest`` layers follow in order.
    """
    n_periods, n_rest = cfg.layer_plan()
    period = len(cfg.pattern)
    layers = []

    def to_torch(a):
        return _to_torch(a, device)

    for i in range(n_periods):
        for pos in range(period):
            layers.append(tree_map(lambda a, i=i: to_torch(np.asarray(a)[i]),
                                   np_tree["periods"][pos]))
    for r in range(n_rest):
        layers.append(tree_map(to_torch, np_tree["rest"][r]))
    out = {"embed": tree_map(to_torch, np_tree["embed"]),
           "final_norm": tree_map(to_torch, np_tree["final_norm"]),
           "layers": layers}
    if "unembed" in np_tree:
        out["unembed"] = tree_map(to_torch, np_tree["unembed"])
    return out


def states_to_jax_layout(cfg: ArchConfig, states: list) -> dict:
    """Port decode state -> ``{"periods": (ScanState stacked over periods,
    one per pattern position), "rest": (ScanState, ...)}`` of numpy arrays,
    the layout of the JAX package's ``lm_state_init``."""
    n_periods, n_rest = cfg.layer_plan()
    period = len(cfg.pattern)
    host = [ScanState(*(t.detach().cpu().numpy() for t in st))
            for st in states]
    out = {}
    if n_periods:
        out["periods"] = tuple(
            ScanState(*(np.stack([host[i * period + pos][f]
                                  for i in range(n_periods)])
                        for f in range(3)))
            for pos in range(period))
    if n_rest:
        out["rest"] = tuple(host[n_periods * period:])
    return out
