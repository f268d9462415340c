"""Token samplers — port of ``repro.serving.sampler``.

A sampler maps last-position logits ``(B, 1, V)`` and a ``(B,)`` int64
tensor of per-row seeds, on the logits' device, to tokens ``(B, 1)`` int64.
Seeds come from :func:`request_seeds`, keyed on ``(request_id, step)`` only
— never on engine scheduling — so the streaming engine and wave generation
draw the same sample for the same submission order, whatever the slot,
refill timing or chunk size.

The built-in samplers carry ``batched = True`` (the JAX package's
``jit_safe``): an engine samples all of a tick's rows in one fixed-shape
call.  Their randomness is a counter-based integer hash of ``(row seed,
vocabulary index)`` in int64 torch ops — no generator, no host round trip,
the same bits on the CPU and the card — turned into Gumbel noise, and
``argmax(logits / T + g)`` is a draw from ``softmax(logits / T)``.  A custom
sampler without the attribute is called once per row with that row's seed,
as the JAX package calls its other samplers.  Greedy also carries
``uses_seeds = False``: the engines pass it ``None`` and derive no seeds.
Greedy decoding matches the JAX package token for token; seeded sampling
cannot reproduce ``jax.random``'s bits, so it matches in distribution.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mix32(x):
    """Avalanche of 32-bit values held in int64 tensors or Python ints
    (lowbias32's shifts; both multipliers are below 2^31, so no product
    of a 32-bit value overflows int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _fold(h, v):
    """Fold the 32-bit values ``v`` into the 32-bit hash ``h``."""
    return _mix32(h ^ ((v + 0x9E3779B9 + (h << 6) + (h >> 2)) & _M32))


def _seed_hash(base_seed: int):
    return _fold(_mix32(base_seed & _M32), (base_seed >> 32) & _M32)


def request_seeds(base_seed: int, rids: torch.Tensor,
                  steps: torch.Tensor) -> torch.Tensor:
    """(B,) int64 seeds of generated token ``steps[i]`` of request
    ``rids[i]``, computed on ``rids``' device."""
    h = _fold(_seed_hash(base_seed), rids & _M32)
    return _fold(h, steps & _M32)


def request_seed(base_seed: int, request_id: int, step: int) -> int:
    """One row of :func:`request_seeds` as a Python int (the same bits)."""
    return _fold(_fold(_seed_hash(base_seed), request_id & _M32), step & _M32)


def gumbel_noise(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) f32 standard Gumbel noise, entry ``(i, j)`` a function of
    ``(seeds[i], j)`` alone."""
    idx = torch.arange(n, dtype=torch.int64, device=seeds.device)
    bits = _fold(seeds[:, None], idx[None, :])
    # 23 bits, so that every u is an f32 strictly inside (0, 1).
    u = ((bits >> 9).to(torch.float32) + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


def greedy_sampler(logits: torch.Tensor, seeds=None) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) argmax (first index on ties)."""
    return torch.argmax(logits, dim=-1)


greedy_sampler.batched = True
greedy_sampler.uses_seeds = False


def temperature_sampler(temperature: float = 1.0, top_k: int | None = None):
    def sample(logits: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
        x = logits.float() / max(temperature, 1e-6)
        if top_k is not None:
            kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
            x = torch.where(x < kth, torch.full_like(x, -torch.inf), x)
        g = gumbel_noise(seeds, x.shape[-1])               # (B, V)
        return torch.argmax(x + g[:, None, :], dim=-1)     # (B, 1)

    sample.batched = True
    return sample
