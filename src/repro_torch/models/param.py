"""Parameter specs and their initialisation on the target device.

Port of ``repro.models.param``: a model declares its parameters as a tree
(dicts and lists) of :class:`ParamSpec`, and :func:`init_params` draws
each tensor from one seeded ``torch.Generator`` on the target device.  The
rules match the JAX package — ``normal`` with std ``1/sqrt(fan_in)``,
``embed``/``query`` with std 0.02, ``ones``, ``zeros`` — but the bits do
not (``jax.random`` and torch's generators differ); tests that compare the
two packages carry the JAX parameters across with ``models/convert.py``.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | embed | query
    scale: float | None = None  # stddev override for normal init


def _fan_in(shape: tuple[int, ...]) -> int:
    # Projection tensors are (in_dims..., out_dim): all but the last axis.
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return math.prod(shape[:-1])


def _init(spec: ParamSpec, gen: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("normal", "embed", "query"):
        std = spec.scale
        if std is None:
            std = (0.02 if spec.init in ("embed", "query")
                   else 1.0 / math.sqrt(_fan_in(spec.shape)))
        # Drawn in f32 on the device, scaled, then cast: one tensor's f32
        # copy at a time, never the whole model in f32 on the host.
        x = torch.randn(spec.shape, generator=gen, device=device)
        return x.mul_(std).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def map_specs(fn, tree):
    """Apply ``fn`` to every ParamSpec of a dict/list tree."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree: {type(tree)}")


def init_params(specs, seed: int, dtype, device):
    """Materialise a ParamSpec tree on ``device``, deterministically."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return map_specs(lambda s: _init(s, gen, dtype, device), specs)


def count_params(specs) -> int:
    total = 0

    def add(spec):
        nonlocal total
        total += math.prod(spec.shape)

    map_specs(add, specs)
    return total
