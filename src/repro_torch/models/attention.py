"""Attention mixers: softmax (global and sliding-window) and Aaren — port
of ``repro.models.attention``.

Entry points, as in the JAX package:

* :func:`attn_proj_specs`, :func:`softmax_state_init`,
  :func:`aaren_state_init`;
* :func:`softmax_sequence` — RoPE and flash attention over a full
  sequence, returning the KV cache for decode; :func:`softmax_step` — one
  token against the (ring) KV cache, O(cache_len) work;
* :func:`aaren_sequence` — full-sequence prefill (``lengths`` masks a
  ragged right-padded tail, ``segment_ids`` restarts the scan at every
  packed document), returning the final carry;
* :func:`aaren_step`     — the O(1) one-token decode update;
* :func:`aaren_chunk`    — fold a fixed-shape (B, C) chunk into the carry,
  the serving engine's hot path.

The softmax KV cache is a ring buffer: a sliding-window layer holds
``window`` positions, a global layer the whole context (the linear-memory
baseline the paper improves on).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import aaren as aaren_core
from repro_torch.core import softmax_attention as soft
from repro_torch.core.rope import rope_for_positions, segment_positions
from repro_torch.core.scan_attention import (
    NEG_INF,
    ScanState,
    mask_to_identity,
)
from repro_torch.kernels import ops as kops
from repro_torch.models.param import ParamSpec


def attn_proj_specs(cfg: ArchConfig, *,
                    with_query_token: bool = False) -> dict:
    d, h, g, k = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    specs = {
        "wq": ParamSpec((d, h, k)),
        "wk": ParamSpec((d, g, k)),
        "wv": ParamSpec((d, g, k)),
        "wo": ParamSpec((h, k, d)),
    }
    if with_query_token:
        # The learned query token q^(j) — the paper's ~0.016% param overhead.
        specs["query"] = ParamSpec((d,), init="query")
    return specs


def _proj_q(p, x):  # (B, N, D) -> (B, N, H, k)
    d, h, k = p["wq"].shape
    return (x @ p["wq"].to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _proj_kv(p, x):  # (B, N, D) -> 2 x (B, N, G, k)
    d, g, k = p["wk"].shape
    kk = (x @ p["wk"].to(x.dtype).reshape(d, g * k)).unflatten(-1, (g, k))
    vv = (x @ p["wv"].to(x.dtype).reshape(d, g * k)).unflatten(-1, (g, k))
    return kk, vv


def _proj_out(p, ctx):  # (B, N, H, k) -> (B, N, D)
    h, k, d = p["wo"].shape
    return ctx.flatten(-2) @ p["wo"].to(ctx.dtype).reshape(h * k, d)


# ---------------------------------------------------------------------------
# Softmax attention mixer (global and sliding window) — the baseline
# ---------------------------------------------------------------------------


def softmax_state_init(cfg: ArchConfig, batch: int, cache_len: int, device):
    """An empty bf16 KV cache of ``cache_len`` slots, as the JAX package's."""
    return soft.init_kv_cache(batch, cache_len, cfg.n_kv_heads,
                              cfg.resolved_head_dim, device=device)


def softmax_sequence(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                     window: int | None, cache_len: int | None = None,
                     pos_offset: int = 0,
                     lengths: torch.Tensor | None = None,
                     segment_ids: torch.Tensor | None = None,
                     positions: torch.Tensor | None = None):
    """Causal (optionally windowed) self-attention over a full sequence.

    ``lengths`` (B,): true lengths of right-padded ragged rows, masked
    inside the flash kernels (the padded tail reads 0); the cache then
    carries them (``prompt_lens``, ``prompt_pad``) so :func:`softmax_step`
    masks the padded gap.  ``cache_len``: the decode cache to return —
    ``>= N`` keeps every position, ``< N`` the trailing window as a full
    ring buffer in bf16, position ``j`` in slot ``j mod cache_len`` (ragged
    rows would need per-row ring indices, and raise), ``None`` no cache
    (training).  Packed rows: ``segment_ids``
    (B, N) go to the flash kernels' segment masks (attention never crosses
    a document, padding id 0 reads 0), and RoPE rotates by ``positions``
    (B, N), the within-document positions, derived from the ids when not
    given (:func:`segment_positions`).  A packed row has no single decode
    tail, so its cache serves no handoff.  Returns (y, cache or None).
    """
    b, n, _ = x.shape
    q = _proj_q(p, x)
    k, v = _proj_kv(p, x)
    if segment_ids is not None and positions is None:
        positions = segment_positions(segment_ids)
    if positions is None:
        positions = (torch.arange(n, device=x.device) + pos_offset)[None, :]
    q = rope_for_positions(q, positions, cfg.rope_theta)
    k = rope_for_positions(k, positions, cfg.rope_theta)
    ctx = kops.flash_mha(q, k, v, causal=True, window=window,
                         q_lens=lengths, kv_lens=lengths,
                         q_segment_ids=segment_ids,
                         kv_segment_ids=segment_ids)
    y = _proj_out(p, ctx)
    if cache_len is None:
        return y, None
    if cache_len >= n:
        cache = soft.init_kv_cache(b, cache_len, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, dtype=k.dtype,
                                   device=x.device)
        cache = soft.update_kv_cache(cache, k, v)
        if lengths is not None:
            # Ragged prefill: each row's true prompt length and the padded
            # prompt span, so decode masks the gap between them.
            cache["prompt_lens"] = lengths.to(torch.int32)
            cache["prompt_pad"] = torch.tensor(n, dtype=torch.int32,
                                               device=x.device)
        return y, cache
    if lengths is not None:
        raise NotImplementedError(
            "ragged lengths with a trailing-window ring cache needs per-row "
            "ring indices; use cache_len >= N")
    # The trailing window as the ring softmax_step reads and writes:
    # position j in slot j mod cache_len.  (The JAX package stores it
    # oldest first, so its next decode overwrites a slot that is still in
    # the window and keeps one that left it; ROADMAP queue C.)
    shift = n % cache_len
    return y, {"k": k[:, n - cache_len:].roll(shift, 1).to(torch.bfloat16),
               "v": v[:, n - cache_len:].roll(shift, 1).to(torch.bfloat16),
               "index": torch.tensor(n, dtype=torch.int32, device=x.device)}


def softmax_step(p: dict, x_t: torch.Tensor, cache: dict, cfg: ArchConfig, *,
                 window: int | None):
    """One-token decode against the (ring) KV cache.  O(cache_len) work.

    A cache with ``prompt_lens`` came from a ragged right-padded prefill:
    row ``i``'s real keys live in slots ``[0, prompt_lens[i])`` and
    ``[prompt_pad, index)``, and the gap between is masked.  RoPE and the
    window use the row's true absolute position ``prompt_lens[i] + (index -
    prompt_pad)``.  Returns (y (B, 1, D), new cache); the old cache is left
    as it was.
    """
    max_len = cache["k"].shape[1]
    idx = cache["index"]
    ragged = "prompt_lens" in cache
    if ragged:
        plens = cache["prompt_lens"]              # (B,) true prompt lengths
        pp = cache["prompt_pad"]                  # padded prompt span
        pos_row = (plens + (idx - pp))[:, None]   # (B, 1) true position
    else:
        pos_row = idx.reshape(1, 1)               # shared absolute position
    q = rope_for_positions(_proj_q(p, x_t), pos_row, cfg.rope_theta)
    k_new, v_new = _proj_kv(p, x_t)
    k_new = rope_for_positions(k_new, pos_row, cfg.rope_theta)

    slot = torch.remainder(idx, max_len).reshape(1).long()
    k = cache["k"].index_copy(1, slot, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy(1, slot, v_new.to(cache["v"].dtype))
    new_cache = dict(cache, k=k, v=v, index=idx + 1)

    # Slots written so far; with capacity == window for sliding-window
    # layers, slot validity is the window.
    n_written = torch.clamp(idx + 1, max=max_len)
    slots = torch.arange(max_len, device=x_t.device)
    if ragged:
        valid = ((slots[None, :] < plens[:, None])
                 | ((slots[None, :] >= pp) & (slots[None, :] < n_written)))
        k_pos = torch.where(slots[None, :] < pp, slots[None, :],
                            plens[:, None] + (slots[None, :] - pp))
        if window is not None:
            valid = valid & (k_pos > pos_row - window)
        valid = valid[:, None, None, :]           # (B, 1, 1, S)
    else:
        valid = (slots < n_written)[None, None, None, :]
    kf = soft._expand_kv(k, cfg.n_heads)
    vf = soft._expand_kv(v, cfg.n_heads)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * scale
    s = torch.where(valid, s, NEG_INF)
    attn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", attn, vf.to(attn.dtype))
    return _proj_out(p, ctx.to(x_t.dtype)), new_cache


# ---------------------------------------------------------------------------
# Aaren mixer — the paper's module
# ---------------------------------------------------------------------------


def _aaren_weights(p: dict) -> aaren_core.AarenWeights:
    return aaren_core.AarenWeights(query=p["query"], wq=p["wq"], wk=p["wk"],
                                   wv=p["wv"], wo=p["wo"])


def aaren_state_init(cfg: ArchConfig, batch: int, device) -> ScanState:
    return aaren_core.empty_carry(batch, cfg.n_heads, cfg.resolved_head_dim,
                                  device=device)


def _prefix_attention(q_heads, k, v, scale, *, carry=None, mask=None,
                      segment_ids=None):
    """Scores + per-head values, then the prefix-scan kernel boundary.

    ``mask`` (B, N): valid positions; the rest enter the scan as ⊕-identity
    leaves.  ``segment_ids`` (B, N): packed rows — the scan restarts at
    every document and padding (id 0) is inert.  Returns ((B, N, H, d) in
    v's dtype, final carry).
    """
    s = aaren_core._scores(q_heads, k, scale)                  # (B, H, N)
    vh = aaren_core._values_per_head(v, q_heads.shape[0]).float()
    if mask is not None:
        s, vh = mask_to_identity(s, vh, mask[:, None, :])
    o, final = kops.aaren_prefix_attention(                    # (B, H, N, d)
        s, vh, carry, segment_ids=segment_ids)
    return o.transpose(1, 2).to(v.dtype), final


def aaren_sequence(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   segment_ids: torch.Tensor | None = None,
                   lengths: torch.Tensor | None = None):
    """Full-sequence Aaren (prefix scan from the empty carry).  No RoPE.

    ``segment_ids`` (B, N): packed rows — the scan restarts at every
    document start and padding (id 0) reads 0 (DESIGN.md §Packing).
    ``lengths`` (B,): ragged right-padded rows — the padded tail enters as
    ⊕-identity leaves, so the final carry is the state at each row's true
    length.  Returns (y (B, N, D), final carry).
    """
    mask = None
    if lengths is not None:
        mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                < lengths[:, None])

    def attention_fn(q_heads, k, v, scale):
        return _prefix_attention(q_heads, k, v, scale, mask=mask,
                                 segment_ids=segment_ids)

    return aaren_core.aaren_layer_parallel(_aaren_weights(p), x, attention_fn)


def aaren_step(p: dict, x_t: torch.Tensor, state: ScanState, cfg: ArchConfig):
    """O(1) streaming update — the paper's constant-memory inference."""
    return aaren_core.aaren_layer_step(_aaren_weights(p), x_t, state)


def aaren_chunk(p: dict, x: torch.Tensor, state: ScanState, cfg: ArchConfig,
                *, mask: torch.Tensor | None = None):
    """Chunked prefill: fold a fixed-shape (B, C, D) chunk into the carry.

    ``mask`` (B, C) marks the real positions: some slots are mid-prefill (C
    prompt tokens), some decode (one valid token), free slots are all
    padding.  Masked positions enter the scan as ⊕-identity leaves.
    """
    w = _aaren_weights(p)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    q_heads = aaren_core.head_queries(w)
    k, v = aaren_core._project_kv(w, x)
    ctx, final = _prefix_attention(q_heads, k, v, scale, carry=state,
                                   mask=mask)
    return aaren_core._project_out(w, ctx), final
