"""Rotary position embeddings for the softmax-attention baseline — port of
``repro.core.rope`` (split-halves convention, tables in f32).

Aaren layers do not use RoPE (their query is a learned constant token); the
baseline transformers keep their archs' standard RoPE.
:func:`segment_positions` restarts the positions at every document of a
packed row.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_freqs(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """cos/sin tables for ``positions`` (any shape) -> (..., dim/2), f32."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    inv = torch.from_numpy(inv.astype(np.float32)).to(positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., d) with tables broadcastable to (..., d/2).

    Split halves: ``x1 = x[..., :d/2]``, ``x2 = x[..., d/2:]``; the rotation
    runs in f32 (the tables' type) and returns ``x``'s dtype.
    """
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def rope_for_positions(x: torch.Tensor, positions: torch.Tensor,
                       theta: float = 10000.0) -> torch.Tensor:
    """RoPE on ``x`` (..., N, H, d) at ``positions`` (..., N)."""
    cos, sin = rope_freqs(positions, x.shape[-1], theta)
    return apply_rope(x, cos[..., None, :], sin[..., None, :])


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Within-segment positions of packed rows: the RoPE restart array.

    segment_ids: (..., N) int with contiguous same-id runs (0 = padding).
    Each run's positions restart at 0, so a packed document is rotated by
    the phases its unpacked twin sees.  Padding reads 0.  Returns int32,
    the JAX package's result bit for bit: a start is an id that differs
    from the previous one (the row's first position always starts), and
    each position counts from the latest start at or before it.
    """
    n = segment_ids.shape[-1]
    idx = torch.arange(n, device=segment_ids.device)
    first = torch.full(segment_ids.shape[:-1] + (1,), -1,
                       dtype=segment_ids.dtype, device=segment_ids.device)
    prev = torch.cat([first, segment_ids[..., :-1]], dim=-1)
    starts = segment_ids != prev
    last_start = torch.cummax(torch.where(starts, idx, 0), dim=-1).values
    pos = torch.where(segment_ids != 0, idx - last_start, 0)
    return pos.to(torch.int32)
