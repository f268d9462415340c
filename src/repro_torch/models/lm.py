"""Decoder-only language model — port of ``repro.models.lm``.

Parameters are a plain tree: ``{"embed", "final_norm", "unembed"?,
"layers": [block params, ...]}``.  ``layers`` is flat and in the JAX
package's order: period ``i``, pattern position ``pos`` is layer
``i·len(pattern) + pos``, then the remainder ("rest") layers; the JAX
package's stacked ``lax.scan`` over periods becomes a Python loop.  Decode
states are a list with one entry per layer — an Aaren ``ScanState`` carry,
an RG-LRU ``{"h", "conv"}`` or SSD ``{"s", "conv"}`` dict or a softmax
KV-cache dict — with the batch on axis 0 of every tensor but the cache's
scalar ``index``.

Entry points, as in the JAX package:

* :func:`lm_apply`         — tokens -> logits (+ per-layer decode states,
  + the MoE auxiliary metrics);
* :func:`lm_loss`          — next-token cross-entropy (+ the MoE
  load-balancing loss), the training loss;
* :func:`lm_decode_step`   — one token through every layer's carry;
* :func:`lm_prefill_chunk` — advance every carry by one fixed-shape chunk
  (the serving hot path);
* :func:`lm_state_init` / :func:`lm_state_select` — the empty state, and a
  per-slot masked select of position-free states (Aaren carries, RG-LRU
  and SSD states, which the streaming engine serves) used to reset or keep
  slots;
* :func:`lm_state_take_slot` / :func:`lm_state_put_slot` — copy one slot's
  carry out, and write a one-slot carry into masked slots (the prefix
  cache, request migration).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.layers import (
    apply_embed,
    apply_norm,
    apply_unembed,
    embed_specs,
    norm_specs,
    unembed_specs,
)
from repro_torch.tree import tree_map

# Weight of the MoE load-balance loss in ``lm_loss`` (the JAX package's
# ``lm_loss`` default, ``aux_weight=0.01``).
AUX_WEIGHT = 0.01


def layer_sigs(cfg: ArchConfig) -> list[tuple[str, str]]:
    """(mixer, mlp) signature of every layer, in layer order."""
    sigs = list(zip(cfg.effective_pattern(), cfg.mlp_pattern))
    return [sigs[i % len(sigs)] for i in range(cfg.n_layers)]


def lm_specs(cfg: ArchConfig) -> dict:
    """ParamSpec tree of the full LM."""
    specs = {
        "embed": embed_specs(cfg.vocab, cfg.d_model),
        "final_norm": norm_specs(cfg.d_model, cfg.norm),
        "layers": [blocks.block_specs(sig, cfg) for sig in layer_sigs(cfg)],
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = unembed_specs(cfg.vocab, cfg.d_model)
    return specs


def _group_size(n_periods: int) -> int:
    """Largest divisor of n_periods <= sqrt(n_periods) x ~1.3 (sqrt-remat)."""
    best = 1
    for g in range(2, int(math.sqrt(n_periods) * 1.3) + 1):
        if n_periods % g == 0:
            best = g
    return best


def _logits(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return apply_unembed(params.get("unembed"), params["embed"], x,
                         cfg.logit_softcap)


def lm_apply(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
             collect_state: bool = False, cache_len: int | None = None,
             return_aux: bool = False,
             segment_ids: torch.Tensor | None = None,
             positions: torch.Tensor | None = None,
             lengths: torch.Tensor | None = None):
    """tokens (B, N) -> (logits (B, N, vocab) f32, states or None), and
    with ``return_aux`` the MoE auxiliary metrics as a third value.

    Packed batches (DESIGN.md §Packing): ``segment_ids``/``positions``
    (B, N) keep the packed documents independent in every mixer: Aaren's
    scan restarts at each document; softmax layers mask every
    cross-document pair in the flash kernels and rotate by the
    within-document ``positions``.

    ``lengths`` (B,): true lengths of right-padded ragged rows — each row's
    padded tail is masked in the scan and the flash kernels, so the
    collected states are exactly the states at each row's true length
    (ragged prefill).  ``cache_len``: the slots of each softmax layer's KV
    cache when ``collect_state`` (default N); without ``collect_state`` no
    cache is built.

    The auxiliary metrics (``load_balance_loss``, ``dropped_frac``) are
    the blocks' summed and divided by the number of layers, dense layers
    included, as in the JAX package; they are computed only when
    ``return_aux`` asks for them.

    Remat (``torch.utils.checkpoint``, non-reentrant) covers the layers of
    the full periods, as the JAX package's ``jax.checkpoint`` covers the
    scanned periods.  ``cfg.remat == "block"`` checkpoints every layer: the
    backward keeps only each block's input and runs the block's forward
    again.  ``"group"`` is the sqrt-L two-level remat: with more than 3
    periods (and ``scan_layers``), each group of ``_group_size(n_periods)``
    consecutive periods is one checkpoint, so the backward keeps only the
    groups' inputs and holds one group's activations at a time; otherwise
    it checkpoints every layer, as ``"block"`` does.  The auxiliary
    metrics leave each checkpointed span as its outputs.
    """
    if cfg.remat not in ("none", "block", "group"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    n_periods, _ = cfg.layer_plan()
    period = len(cfg.pattern)
    use_group = cfg.remat == "group" and cfg.scan_layers and n_periods > 3
    # Layers [0, n_remat) are checkpointed in spans of `span` layers.
    n_remat = n_periods * period if cfg.remat != "none" else 0
    span = _group_size(n_periods) * period if use_group else 1
    x = apply_embed(params["embed"], tokens, getattr(torch, cfg.compute_dtype))
    if not collect_state:
        cache_len = None
    elif cache_len is None:
        cache_len = tokens.shape[1]
    kw = dict(cache_len=cache_len, want_aux=return_aux,
              segment_ids=segment_ids, positions=positions, lengths=lengths)
    layers = list(zip(params["layers"], layer_sigs(cfg)))

    def run(x, lo, hi):
        sts, aux = [], dict(blocks.ZERO_AUX)
        for p, sig in layers[lo:hi]:
            x, st, a = blocks.block_sequence(p, x, sig, cfg, **kw)
            sts.append(st)
            aux = {k: aux[k] + a[k] for k in aux}
        return x, sts, aux

    states = []
    aux = dict(blocks.ZERO_AUX)
    lo = 0
    while lo < len(layers):
        hi = lo + span if lo < n_remat else len(layers)
        if lo < n_remat and torch.is_grad_enabled():
            x, sts, a = checkpoint(run, x, lo, hi, use_reentrant=False)
        else:
            x, sts, a = run(x, lo, hi)
        states += sts
        aux = {k: aux[k] + a[k] for k in aux}
        lo = hi
    out = (_logits(cfg, params, x), states if collect_state else None)
    if return_aux:
        out += ({k: v / max(len(layers), 1) for k, v in aux.items()},)
    return out


def lm_loss(cfg: ArchConfig, params: dict, batch: dict):
    """Next-token CE loss.  batch: {"tokens": (B, N), "loss_mask": (B, N)?,
    "segment_ids": (B, N)?, "positions": (B, N)?}.

    Returns (loss, metrics): ``ce + AUX_WEIGHT · load_balance_loss`` with
    ``ce`` the masked mean of ``-log p(token_{t+1})`` in f32, and
    ``{"loss", "ce", "load_balance_loss", "dropped_frac"}``, all detached
    0-d tensors (the MoE metrics are 0 for a dense model).  Packed
    batches: position ``t`` scores its target ``t+1`` only when both
    belong to the same real document (``seg[t] == seg[t+1] != 0``), so no
    document is trained to predict the next one's first token and padding
    is never scored (a MoE MLP still routes the padding, and capacity
    counts it, as in the JAX package).  VLM ``prefix_embeds`` raise until
    their slice of the port lands.
    """
    if batch.get("prefix_embeds") is not None:
        raise NotImplementedError(
            "lm_loss: batch['prefix_embeds'] comes with a later slice of the "
            "port (ROADMAP queue A item 10)")
    tokens = batch["tokens"]
    seg = batch.get("segment_ids")
    logits, _, aux = lm_apply(cfg, params, tokens, segment_ids=seg,
                              positions=batch.get("positions"),
                              return_aux=True)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(nll) if mask is None
            else mask[:, 1:].to(nll.dtype))
    if seg is not None:  # cross-segment-safe: target must share the document
        same_doc = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
        mask = mask * same_doc.to(nll.dtype)
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    aux = {k: torch.as_tensor(v, dtype=torch.float32, device=ce.device)
           for k, v in aux.items()}
    loss = ce + AUX_WEIGHT * aux["load_balance_loss"]
    metrics = {"loss": loss, "ce": ce, **aux}
    return loss, {k: v.detach() for k, v in metrics.items()}


def lm_decode_step(cfg: ArchConfig, params: dict, token_t: torch.Tensor,
                   states: list):
    """One-token decode.  token_t: (B, 1) -> (logits (B, 1, V), states)."""
    x = apply_embed(params["embed"], token_t, getattr(torch, cfg.compute_dtype))
    new_states = []
    for p, st, sig in zip(params["layers"], states, layer_sigs(cfg)):
        x, st = blocks.block_step(p, x, st, sig, cfg)
        new_states.append(st)
    return _logits(cfg, params, x), new_states


def lm_prefill_chunk(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                     states: list, *,
                     length_mask: torch.Tensor | None = None):
    """Advance every layer's carry by one fixed-shape chunk of tokens.

    tokens: (B, C); length_mask: (B, C) bool, True at valid positions (a
    prefix per row).  Returns (logits (B, C, V) f32, new states).  Logits at
    padded positions are garbage by construction; callers read row i at its
    last valid position.
    """
    x = apply_embed(params["embed"], tokens, getattr(torch, cfg.compute_dtype))
    new_states = []
    for p, st, sig in zip(params["layers"], states, layer_sigs(cfg)):
        x, st = blocks.block_chunk(p, x, st, sig, cfg, mask=length_mask)
        new_states.append(st)
    return _logits(cfg, params, x), new_states


def lm_state_init(cfg: ArchConfig, batch: int, cache_len: int | None = None,
                  device="cuda") -> list:
    """The empty decode state of every layer: the ⊕-identity Aaren carry,
    a zero RG-LRU or SSD state, or an empty bf16 KV cache of ``cache_len``
    slots (softmax layers need one)."""
    dev = resolve_device(device)
    return [blocks.block_state_init(sig, cfg, batch, cache_len, dev)
            for sig in layer_sigs(cfg)]


def lm_state_select(mask: torch.Tensor, a: list, b: list) -> list:
    """Per slot: ``a``'s state where ``mask`` (B,) is True, else ``b``'s.

    ``a`` and ``b`` are per-layer states of one structure whose leaves all
    keep their batch on axis 0 (Aaren ``ScanState`` carries, RG-LRU or
    SSD dicts, or several kinds in one model), so the engine resets freed slots with
    ``lm_state_select(freed, init, states)`` and keeps idle slots with
    ``lm_state_select(live, new, old)``.
    """
    def leaf(x, y):
        return torch.where(mask.reshape((-1,) + (1,) * (x.ndim - 1)), x, y)

    return tree_map(leaf, a, b)


def lm_state_take_slot(states: list, idx: int) -> list:
    """A copy of slot ``idx``'s state (every layer's carry), each leaf
    keeping a size-1 batch axis, so that it round-trips through
    :func:`lm_state_put_slot` unchanged.  Every leaf has its batch on axis
    0, so no axis metadata is needed (the JAX package's
    ``lm_state_batch_axes``)."""
    return tree_map(lambda x: x[idx:idx + 1].clone(), states)


def lm_state_put_slot(states: list, carry: list, mask: torch.Tensor) -> list:
    """``carry`` (size-1 batch, as :func:`lm_state_take_slot` returns) in
    every slot where ``mask`` (B,) is True; the other slots as they are."""
    def leaf(batched, one):
        return torch.where(mask.reshape((-1,) + (1,) * (batched.ndim - 1)),
                           one, batched)

    return tree_map(leaf, states, carry)
