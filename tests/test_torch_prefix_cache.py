"""The port's prefix-carry cache (``repro_torch.serving.prefix_cache``)
against the JAX package's: equal keys, equal bookkeeping under the same
operations, equal engine behaviour with a cache, equal saved ``extra`` and
carries within 1e-5 — and, within the port, cache hits byte-identical to
cold prefill, persistence past a corrupt step, and the softmax bypass.
"""

import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import read_checkpoint_extra as jax_read_extra
from repro.configs import smoke_config as jax_smoke_config
from repro.models.factory import build as jax_build
from repro.serving import PrefixCache as JaxPrefixCache
from repro.serving import StreamingEngine as JaxStreamingEngine
from repro.serving.prefix_cache import _roll as jax_roll
from repro.serving.prefix_cache import grid_hashes as jax_grid_hashes
from repro_torch.checkpoint import (
    CheckpointCorruptionError,
    read_checkpoint_extra,
)
from repro_torch.configs import smoke_config
from repro_torch.core.scan_attention import ScanState
from repro_torch.models.convert import params_from_jax, states_to_jax_layout
from repro_torch.models.factory import build
from repro_torch.obs.metrics import MetricsRegistry, use_metrics
from repro_torch.serving import PrefixCache, StreamingEngine
from repro_torch.serving.prefix_cache import _roll, grid_hashes
from repro_torch.testing import corrupt_checkpoint

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=64)


@pytest.fixture(scope="module")
def models():
    japi = jax_build(jax_smoke_config("phi3-mini-3.8b", **SMALL))
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build(smoke_config("phi3-mini-3.8b", **SMALL))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), api.cfg,
                             "cpu")
    return japi, jparams, api, params


def _shared_prefix_traffic(rng_seed=0, shared_len=32, n=3, suffix_len=5):
    rng = np.random.default_rng(rng_seed)
    shared = rng.integers(0, 64, shared_len).astype(np.int32)
    return shared, [
        np.concatenate([shared, rng.integers(0, 64, suffix_len)
                        .astype(np.int32)])
        for _ in range(n)
    ]


# ---------------------------------------------------------------------------
# Unit level: keying and bookkeeping against the JAX cache
# ---------------------------------------------------------------------------


def test_grid_hashes_equal_jax():
    rng = np.random.default_rng(1)
    for n, chunk in ((10, 4), (64, 16), (33, 8), (3, 4), (97, 1)):
        toks = rng.integers(0, 32064, n).astype(np.int32)
        assert grid_hashes(toks, chunk) == jax_grid_hashes(toks, chunk)
        assert _roll(0, toks) == jax_roll(0, toks)
    toks = np.arange(10, dtype=np.int32)
    hs = grid_hashes(toks, 4)
    assert set(hs) == {4, 8}
    # prefix property: extending the prompt never changes earlier hashes
    hs2 = grid_hashes(np.concatenate([toks, toks]), 4)
    assert hs2[4] == hs[4] and hs2[8] == hs[8]


def _port_carry(fill):
    return [ScanState(np.full((1, 2), fill, np.float32),
                      np.full((1, 2), fill, np.float32),
                      np.full((1, 2, 3), fill, np.float32))]


def _jax_carry(fill):
    return {"m": np.full((1, 2), fill, np.float32),
            "u": np.full((1, 2), fill, np.float32),
            "w": np.full((1, 2, 3), fill, np.float32)}


ENTRY_BYTES = 4 * (2 + 2 + 6) + 4 * 4     # carry + 4 int32 key tokens


def _script(name):
    """(constructor kwargs, ops) of one scripted cache scenario (the
    JAX suite's unit tests)."""
    toks = np.arange(12, dtype=np.int32)
    ins = [("insert", toks[:4], 1.0), ("insert", toks[:8], 2.0)]
    if name == "longest":
        return {}, ins + [
            ("lookup", toks), ("lookup", toks[:8]),
            ("lookup", np.concatenate([toks[:8], [50, 51]]).astype(np.int32))]
    if name == "min_hits":
        hs = grid_hashes(toks[:8], 4)
        return {"min_hits": 2}, [
            ("lookup", toks[:8]), ("wants", 4, hs[4]),
            ("lookup", toks[:8]), ("wants", 4, hs[4]), ("wants", 8, hs[8]),
            ("insert", toks[:4], 1.0), ("wants", 4, hs[4])]
    if name == "pin":
        hs = grid_hashes(toks[:9], 4)
        return {"min_hits": 100}, [
            ("pin", toks[:9]), ("wants", 8, hs[8]), ("wants", 4, hs[4])]
    if name == "evict":
        pinned = np.full(4, 7, np.int32)
        ops = [("pin", pinned), ("insert", pinned, 0.0)]
        ops += [("insert", np.full(4, i, np.int32), float(i))
                for i in range(1, 5)]
        return {"max_bytes": 3 * ENTRY_BYTES}, ops + [
            ("lookup", np.asarray([4, 4, 4, 4, 0], np.int32)),
            ("lookup", np.asarray([1, 1, 1, 1, 0], np.int32))]
    assert name == "collision"
    a, b = np.asarray([1, 2, 3, 4], np.int32), np.full(4, 9, np.int32)
    return {}, [("insert", a, 1.0), ("graft", a, b),
                ("lookup", np.concatenate([b, b]))]


def _replay(cache_cls, carry, name):
    kw, ops = _script(name)
    kw = {"max_bytes": 1 << 20, "min_hits": 1, **kw}
    cache = cache_cls(kw.pop("max_bytes"), **kw)
    cache.bind(4, carry(0.0))
    seen = []
    for op, *args in ops:
        if op == "insert":
            toks, fill = args
            cache.insert(toks, jax_roll(0, toks), carry(fill))
        elif op == "lookup":
            n, got, hashes = cache.lookup(args[0])
            fill = None if got is None else float(
                np.asarray(got[0].m if isinstance(got, list)
                           else got["m"])[0, 0])
            seen.append(("lookup", n, fill, sorted(hashes.items())))
        elif op == "wants":
            seen.append(("wants", cache.wants(*args)))
        elif op == "pin":
            cache.pin(args[0])
        else:      # white box: a forced 61-bit collision
            a, b = args
            cache._entries[(4, jax_roll(0, b))] = \
                cache._entries[(4, jax_roll(0, a))]
    return seen, cache.stats(), sorted(cache._entries)


@pytest.mark.parametrize("name", ["longest", "min_hits", "pin", "evict",
                                  "collision"])
def test_same_ops_give_jax_stats(name):
    """The same operations on both caches: equal lookups (length, carry,
    grid hashes), ``wants``, ``stats()`` and surviving keys."""
    got = _replay(PrefixCache, _port_carry, name)
    want = _replay(JaxPrefixCache, _jax_carry, name)
    assert got == want
    if name == "evict":       # pinned survived; the two oldest did not
        assert got[1]["entries"] == 3 and got[1]["evictions"] == 2
        assert got[0][0][1:3] == (4, 4.0) and got[0][1][1] == 0
    if name == "collision":   # token verification demotes it to a miss
        assert got[0][0][1] == 0
    if name == "longest":     # >= 1 token must remain to sample from
        assert [s[1] for s in got[0]] == [8, 4, 8]


def test_pin_rejects_sub_chunk_prefix():
    cache = PrefixCache(1 << 20)
    cache.bind(4, _port_carry(0.0))
    with pytest.raises(ValueError, match="shorter than one chunk"):
        cache.pin(np.asarray([1, 2], np.int32))


def test_unbound_cache_and_chunk_mismatch_rejected(models):
    _, _, api, params = models
    cache = PrefixCache(1 << 20)
    with pytest.raises(ValueError, match="unbound"):
        cache.lookup(np.arange(8, dtype=np.int32))
    cache.bind(16, _port_carry(0.0))
    with pytest.raises(ValueError, match="chunk"):
        StreamingEngine(api, params, n_slots=2, chunk=8, prefix_cache=cache)


# ---------------------------------------------------------------------------
# Engine level, against the JAX engine with a cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def with_cache(models):
    """Two waves of shared-prefix traffic through each package's engine
    with a cache (wave 2 all hits), then each cache saved."""
    japi, jparams, api, params = models
    _, prompts = _shared_prefix_traffic()
    out = {}
    for tag, eng_cls, cache_cls, p, a in (
            ("jax", JaxStreamingEngine, JaxPrefixCache, jparams, japi),
            ("port", StreamingEngine, PrefixCache, params, api)):
        cache = cache_cls(1 << 20, min_hits=1)
        eng = eng_cls(a, p, n_slots=2, chunk=16, prefix_cache=cache)
        tokens = []
        for _ in range(2):
            rids = [eng.submit(q, 6) for q in prompts]
            res = eng.run()
            tokens += [list(map(int, res[r])) for r in rids]
        with tempfile.TemporaryDirectory() as d:
            cache.save(d, 1)
            extra = (jax_read_extra if tag == "jax"
                     else read_checkpoint_extra)(d, 1)
        out[tag] = {"tokens": tokens, "stats": cache.stats(),
                    "extra": extra, "cache": cache}
    return out


def test_engine_with_cache_tokens_and_counts_equal_jax(with_cache):
    got, want = with_cache["port"], with_cache["jax"]
    assert got["tokens"] == want["tokens"]
    assert got["stats"] == want["stats"]
    st = got["stats"]
    assert st["hits"] >= 3 and st["prefill_tokens_saved"] >= 3 * 32


def test_saved_extra_equals_jax(with_cache):
    got = with_cache["port"]["extra"]
    assert got["prefix_cache"]["schema"] == 1
    assert got == with_cache["jax"]["extra"]


def test_cached_carries_equal_jax(with_cache, models):
    _, _, api, _ = models
    port = with_cache["port"]["cache"]._entries
    jax_entries = with_cache["jax"]["cache"]._entries
    assert list(port) == list(jax_entries)
    for key, ent in port.items():
        got = jax.tree.leaves(states_to_jax_layout(
            api.cfg, [ScanState(*(torch.from_numpy(x) for x in st))
                      for st in ent.carry]))
        want = jax.tree.leaves(jax_entries[key].carry)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# Engine level, within the port
# ---------------------------------------------------------------------------


def test_cache_hit_byte_identical_to_cold_prefill(models, with_cache):
    """Generation seeded from a cached carry equals a cold engine's output
    token for token, for every request of both waves."""
    _, _, api, params = models
    _, prompts = _shared_prefix_traffic()
    cold = StreamingEngine(api, params, n_slots=2, chunk=16)
    rids = [cold.submit(p, 6) for p in prompts]
    ref = cold.run()
    ref = [list(map(int, ref[r])) for r in rids]
    assert with_cache["port"]["tokens"] == ref + ref


def test_cache_hit_skips_prefill_work(models):
    """A hot request's cached chunks are never scheduled."""
    _, _, api, params = models
    shared, prompts = _shared_prefix_traffic(shared_len=48, n=2)

    def prefill_tokens(cache):
        eng = StreamingEngine(api, params, n_slots=1, chunk=16,
                              prefix_cache=cache)
        with use_metrics(MetricsRegistry()) as reg:
            for p in prompts:
                eng.submit(p, 2)
            eng.run()
            return reg.counter("serve_prefill_tokens_total").value

    cold = prefill_tokens(None)
    warm = prefill_tokens(PrefixCache(1 << 20, min_hits=1))
    assert warm <= cold - shared.size            # request 2 skipped 48 toks


def test_cache_save_load_past_corrupted_chunk(models):
    _, _, api, params = models
    _, prompts = _shared_prefix_traffic()
    cache = PrefixCache(1 << 20, min_hits=1)
    eng = StreamingEngine(api, params, n_slots=2, chunk=16,
                          prefix_cache=cache)
    rids = [eng.submit(p, 4) for p in prompts]
    ref = eng.run()
    assert len(cache) > 0

    with tempfile.TemporaryDirectory() as d:
        cache.save(d, 1)
        cache.save(d, 2)
        corrupt_checkpoint(d, 2, kind="flip_byte")

        cache2 = PrefixCache(1 << 20, min_hits=1)
        eng2 = StreamingEngine(api, params, n_slots=2, chunk=16,
                               prefix_cache=cache2)
        assert cache2.load(d) == 1               # fell back past corruption
        assert len(cache2) == len(cache)
        with pytest.raises(CheckpointCorruptionError):
            cache2.load(d, step=2)               # explicit step: no fallback
    for key, ent in cache._entries.items():      # the carries, bit for bit
        for a, b in zip(jax.tree.leaves(ent.carry),
                        jax.tree.leaves(cache2._entries[key].carry)):
            assert a.tobytes() == b.tobytes()

    # restored entries serve byte-identical generations
    rids2 = [eng2.submit(p, 4) for p in prompts]
    out2 = eng2.run()
    for r1, r2 in zip(rids, rids2):
        assert ref[r1] == out2[r2]
    assert cache2.stats()["hits"] >= len(prompts)


def test_softmax_arch_bypasses_cleanly(models):
    """The softmax model's KV cache is not position-free: the engine
    refuses it before binding or touching the cache, which stays usable."""
    _, _, api, params = models
    softmax = build(smoke_config("phi3-mini-3.8b", attn_mode="softmax",
                                 **SMALL))
    cache = PrefixCache(1 << 20)
    with pytest.raises(ValueError, match="position-free"):
        StreamingEngine(softmax, params, prefix_cache=cache)
    assert cache.chunk is None and len(cache) == 0   # untouched
    eng = StreamingEngine(api, params, n_slots=2, chunk=16,
                          prefix_cache=cache)
    assert cache.chunk == 16                         # bound by the real user
    eng.submit(np.arange(4, dtype=np.int32), 2)
    assert len(eng.run()[0]) == 2
