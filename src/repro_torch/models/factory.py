"""Model factory: the LM's uniform API — port of ``repro.models.factory``.

``build(cfg)`` returns a :class:`ModelAPI` whose members are plain functions
closed over the config; the serving engine, the train step and the
launchers consume this interface.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.param import init_params


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    specs: Callable[[], Any]
    init: Callable[..., Any]              # (seed, device="cuda") -> params
    loss: Callable[..., tuple]            # (params, batch) -> (loss, metrics)
    forward: Callable[..., Any]           # (params, batch) -> logits
    prefill: Callable[..., tuple]         # (params, batch) -> (logits, states)
    decode_step: Callable[..., tuple]     # (params, step_batch) -> (logits, states)


FAMILIES = ("dense", "hybrid", "ssm", "moe")
# The ROADMAP queue A item that brings each family not yet ported.
LATER_FAMILIES = {"audio": "A10d", "vlm": "A10d"}


def build(cfg: ArchConfig) -> ModelAPI:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} comes with a later slice of the port "
            f"(ROADMAP queue A item {LATER_FAMILIES.get(cfg.family, '?')}); "
            f"the port builds the families {FAMILIES}")
    specs_fn = lambda: lm.lm_specs(cfg)  # noqa: E731

    def init(seed: int, device="cuda"):
        return init_params(specs_fn(), seed, getattr(torch, cfg.param_dtype),
                           resolve_device(device))

    def loss(params, batch):
        return lm.lm_loss(cfg, params, batch)

    def forward(params, batch):
        logits, _ = lm.lm_apply(cfg, params, batch["tokens"])
        return logits

    def prefill(params, batch):
        # "lengths": optional (B,) true prompt lengths of right-padded rows;
        # "cache_len": the KV-cache slots of softmax layers (default N).
        return lm.lm_apply(cfg, params, batch["tokens"], collect_state=True,
                           cache_len=batch.get("cache_len"),
                           lengths=batch.get("lengths"))

    def decode_step(params, step_batch):
        return lm.lm_decode_step(cfg, params, step_batch["token"],
                                 step_batch["states"])

    return ModelAPI(cfg=cfg, specs=specs_fn, init=init, loss=loss,
                    forward=forward, prefill=prefill, decode_step=decode_step)
