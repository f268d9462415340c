"""Rotary position embeddings for the softmax-attention baseline — port of
``repro.core.rope`` (split-halves convention, tables in f32).

Aaren layers do not use RoPE (their query is a learned constant token); the
baseline transformers keep their archs' standard RoPE.  ``segment_positions``
(the per-document restart of packed rows) comes with the packing slice
(ROADMAP queue A item 7).
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
