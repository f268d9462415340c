"""The serving tier on the card against the CPU, at a small f32 size: the
router with a shared prefix cache and a drain, on B1, gives the CPU's
greedy tokens, with every B1 launch accounted for.  Skips without a card
(the kernels have no CPU mode); imports nothing of the JAX package.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.aaren_scan import aaren_scan
from repro_torch.models.factory import build
from repro_torch.serving import PrefixCache, ReplicatedRouter, StreamingEngine

SMALL = dict(n_layers=2, d_model=64, d_ff=128, n_heads=4, n_kv_heads=4,
             head_dim=16, vocab=128, param_dtype="float32",
             compute_dtype="float32")


@pytest.mark.cuda
def test_tier_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    api = build(get_config("phi3-mini-3.8b", **SMALL))
    params = api.init(0, device="cpu")
    card = _to(params, "cuda")
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 128, 32)
    prompts = [np.concatenate([prefix, rng.integers(0, 128, n)])
               for n in rng.integers(3, 20, 12)]

    cpu = StreamingEngine(api, params, n_slots=4, chunk=8)
    rids = [cpu.submit(p, 6) for p in prompts]
    want = [cpu.run()[r] for r in rids]

    router = ReplicatedRouter(api, card, n_replicas=2, n_slots=4, chunk=8,
                              prefix_cache=PrefixCache(1 << 20, min_hits=1))
    router.warmup()
    ticks = {"n": 0}
    lock = threading.Lock()
    for eng in router.engines:
        def counted(tokens, lengths, advance=eng._advance):
            with lock:
                ticks["n"] += 1
            return advance(tokens, lengths)
        eng._advance = counted
    aaren_scan.n_launches = 0
    got_rids = [router.submit(p, 6) for p in prompts]
    for _ in range(3):
        router.step()
    assert router.drain(1) > 0
    out = router.run()
    router.close()
    torch.cuda.synchronize()
    assert [out[r] for r in got_rids] == want
    assert aaren_scan.n_launches == api.cfg.n_layers * ticks["n"]
    # A replica's exception would become a silent failover.
    assert router.stats()["failed_over"] == 0
    assert sum(router.alive) == 1 and not router.errors


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
