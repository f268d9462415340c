"""Token samplers — port of ``repro.serving.sampler``.

A sampler maps last-position logits ``(B, 1, V)`` and one integer seed per
row to tokens ``(B, 1)`` int64.  Seeds come from :func:`request_seed`,
keyed on ``(request_id, step)`` only — never on engine scheduling — so the
streaming engine and wave generation draw the same sample for the same
submission order, whatever the slot, refill timing or chunk size.  torch's
generators cannot reproduce ``jax.random``'s bits, so seeded sampling
matches the JAX package in distribution, not token for token; greedy
decoding matches exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def request_seed(base_seed: int, request_id: int, step: int) -> int:
    """Sampling seed for generated token ``step`` of request ``request_id``."""
    seq = np.random.SeedSequence([base_seed, request_id, step])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def greedy_sampler(logits: torch.Tensor, seeds=None) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) argmax (first index on ties)."""
    return torch.argmax(logits, dim=-1)


def temperature_sampler(temperature: float = 1.0, top_k: int | None = None):
    def sample(logits: torch.Tensor, seeds) -> torch.Tensor:
        x = logits.float() / max(temperature, 1e-6)
        if top_k is not None:
            kth = torch.sort(x, dim=-1).values[..., -top_k][..., None]
            x = torch.where(x < kth, torch.full_like(x, -torch.inf), x)
        probs = torch.softmax(x[:, 0], dim=-1)           # (B, V)
        rows = []
        for i, seed in enumerate(seeds):
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(seed)
            rows.append(torch.multinomial(probs[i], 1, generator=gen))
        return torch.stack(rows)                         # (B, 1)

    return sample
