"""Softmax attention, the paper's baseline, and its KV-cache decode — port
of ``repro.core.softmax_attention``, packed-segment ids included.

Activations are ``(B, N, H, d)``; GQA has ``G = kv_heads`` dividing ``H``,
query head ``h`` reading kv head ``h // (H/G)``.  These are the dense
torch versions: the shared mask builder :func:`attention_mask`, the guarded
:func:`masked_softmax` (a row with no live key reads 0, not the uniform
average a softmax over finite ``NEG_INF`` scores gives), and the KV cache
that the decode path reads.  The flash kernels in
``repro_torch.kernels.flash_attention`` compute the same attention tile by
tile.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.scan_attention import NEG_INF
from repro_torch.device import resolve_device


def _expand_kv(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, N, G, d) -> (B, N, H, d) by repeating each kv head H/G times."""
    g = x.shape[-2]
    if g == n_heads:
        return x
    return torch.repeat_interleave(x, n_heads // g, dim=-2)


def masked_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with fully-masked rows defined as 0.

    ``s`` holds ``NEG_INF`` at masked positions already; ``mask`` is the
    boolean validity map, broadcastable against ``s``.
    """
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    u = e.sum(dim=-1, keepdim=True)
    return e / torch.where(u == 0.0, 1.0, u)


def attention_mask(n_q: int, n_k: int, *, causal: bool = True,
                   window: int | None = None,
                   q_lens: torch.Tensor | None = None,
                   kv_lens: torch.Tensor | None = None,
                   q_segment_ids: torch.Tensor | None = None,
                   kv_segment_ids: torch.Tensor | None = None,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(B-or-1, 1, Nq, Nk) boolean validity mask — the one shared builder.

    Causal and window compare absolute positions (``q_offset`` is the
    absolute position of query row 0); ``q_lens`` (B,) counts the valid
    local query rows and ``kv_lens`` (B,) the valid keys.
    ``q_segment_ids``/``kv_segment_ids`` (B, Nq)/(B, Nk): packed-segment
    ids; a pair is live only when both carry the same nonzero id (0 is
    padding).  One side alone stands for both, as in the JAX package.
    """
    if device is None:
        device = next((t.device for t in (q_lens, kv_lens, q_segment_ids,
                                          kv_segment_ids) if t is not None),
                      torch.device("cpu"))
    q_pos = torch.arange(n_q, device=device)[:, None] + q_offset
    k_pos = torch.arange(n_k, device=device)[None, :]
    mask = torch.ones((n_q, n_k), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    mask = mask[None, None]                               # (1, 1, Nq, Nk)
    if q_lens is not None:
        row = torch.arange(n_q, device=device)[:, None]
        mask = mask & (row[None, None] < q_lens[:, None, None, None])
    if kv_lens is not None:
        mask = mask & (k_pos[None, None] < kv_lens[:, None, None, None])
    if q_segment_ids is not None or kv_segment_ids is not None:
        seg_q = q_segment_ids if q_segment_ids is not None else kv_segment_ids
        seg_k = kv_segment_ids if kv_segment_ids is not None else q_segment_ids
        sq = seg_q.to(device)[:, None, :, None]          # (B, 1, Nq, 1)
        sk = seg_k.to(device)[:, None, None, :]          # (B, 1, 1, Nk)
        mask = mask & (sq == sk) & (sq != 0)
    return mask


def causal_mask_bias(n_q: int, n_k: int, *, window: int | None = None,
                     q_offset: int = 0, device=None) -> torch.Tensor:
    """(n_q, n_k) f32 additive bias: 0 where attendable, NEG_INF elsewhere.

    ``q_offset`` is the absolute position of query row 0 (with caches);
    ``window`` keeps the last ``window`` positions, self included.
    """
    ok = attention_mask(n_q, n_k, window=window, q_offset=q_offset,
                        device=device)[0, 0]
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def multihead_attention(q, k, v, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        lengths: torch.Tensor | None = None,
                        q_lens: torch.Tensor | None = None,
                        segment_ids: torch.Tensor | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T) v under causal / window / length / segment masks.

    q: (B, Nq, H, d); k, v: (B, Nk, G, d).  ``lengths`` (B,): valid keys;
    ``q_lens`` (B,): valid query rows (the rest read 0).  ``segment_ids``
    (B, N): packed-segment ids for self-attention (Nq == Nk); attention
    never crosses a segment and padding (id 0) reads 0.  The window applies
    only with ``causal``, as in the JAX package.  Returns (B, Nq, H, d).
    """
    _, n_q, h, d = q.shape
    n_k = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(n_q, n_k, causal=causal,
                          window=window if causal else None,
                          q_lens=q_lens, kv_lens=lengths,
                          q_segment_ids=segment_ids,
                          kv_segment_ids=segment_ids, q_offset=q_offset,
                          device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = masked_softmax(s, mask)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache — the linear-memory inference path the paper contrasts against.
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, max_len: int, kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device="cuda") -> dict:
    """Pre-allocated cache: {k, v: (B, S, G, d), index: () int32}, on the
    card unless ``device`` says otherwise."""
    device = resolve_device(device)
    return {
        "k": torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                         device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def update_kv_cache(cache: dict, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> dict:
    """Insert (B, n, G, d) keys/values at the current index; returns a new
    cache (the old one is left as it was)."""
    idx = int(cache["index"])
    n = k_new.shape[1]
    k = cache["k"].clone()
    v = cache["v"].clone()
    k[:, idx:idx + n] = k_new.to(k.dtype)
    v[:, idx:idx + n] = v_new.to(v.dtype)
    return {"k": k, "v": v, "index": cache["index"] + n}


def decode_attention(q: torch.Tensor, cache: dict, *,
                     window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """One-token decode against a KV cache that already holds the current
    token (its ``index`` counts every written token).

    q: (B, 1, H, d); cache k/v: (B, S, G, d).  Unwritten slots, and with a
    window the positions outside it, are masked.  O(S) work per token —
    the baseline the paper's O(1) Aaren state replaces.
    """
    _, _, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k = _expand_kv(cache["k"], h)
    v = _expand_kv(cache["v"], h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    valid = pos < cache["index"]
    if window is not None:
        valid = valid & (pos > cache["index"] - 1 - window)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype))
    return out.to(q.dtype)
