"""The port's replicated serving tier (``repro_torch.serving.router``)
against the JAX package's ``tests/test_router.py``: the same routing
rankings, and the same tokens and tier counters as the JAX router on the
same traffic — crash failover and drain byte-identical to an undisturbed
single engine, tier-wide shedding and re-routing, deadlines, tier-unique
ids, per-replica gauges and a prefix cache shared across replicas.
"""

import time

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.models.factory import build as jax_build
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.obs.metrics import use_metrics as jax_use_metrics
from repro.serving import ReplicatedRouter as JaxRouter
from repro.serving import StreamingEngine as JaxStreamingEngine
from repro.serving import router as jax_router
from repro.testing.faults import kill_router_replica as jax_kill
from repro_torch.configs import smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.factory import build
from repro_torch.obs.metrics import MetricsRegistry, use_metrics
from repro_torch.serving import (
    PrefixCache,
    ReplicatedRouter,
    StreamingEngine,
)
from repro_torch.serving.router import (
    ERR_DEADLINE,
    ReplicaView,
    RoundRobin,
    join_shortest_queue,
    least_occupancy,
    make_policy,
)
from repro_torch.testing import kill_router_replica

N_SLOTS = 4
CHUNK = 8
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=64)


@pytest.fixture(scope="module")
def models():
    japi = jax_build(jax_smoke_config("phi3-mini-3.8b", **SMALL))
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build(smoke_config("phi3-mini-3.8b", **SMALL))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), api.cfg,
                             "cpu")
    return japi, jparams, api, params


def _traffic(n=8, vocab=64):
    """Ragged deterministic mix: prompts 5-29 tokens, max_new 5-12."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, vocab, 5 + (7 * i) % 25).astype(np.int32),
             5 + (3 * i) % 8) for i in range(n)]


@pytest.fixture(scope="module")
def baseline(models):
    """The JAX package's undisturbed single-engine run (ids in submission
    order from 0, as the router allocates them), and the port's."""
    japi, jparams, api, params = models
    out = []
    for eng in (JaxStreamingEngine(japi, jparams, n_slots=N_SLOTS,
                                   chunk=CHUNK),
                StreamingEngine(api, params, n_slots=N_SLOTS, chunk=CHUNK)):
        for p, n in _traffic():
            eng.submit(p, n)
        out.append({rid: list(map(int, t)) for rid, t in eng.run().items()})
    assert out[0] == out[1]
    return out[0]


def _both(models, fn):
    """Run ``fn(router_cls, api, params, kill)`` for the JAX and the port
    router; returns (jax result, port result)."""
    japi, jparams, api, params = models
    return (fn(JaxRouter, japi, jparams, jax_kill),
            fn(ReplicatedRouter, api, params, kill_router_replica))


def _tokens(out):
    return {rid: list(map(int, t)) for rid, t in out.items()}


# ---------------------------------------------------------------------------
# Routing policies (pure functions)
# ---------------------------------------------------------------------------


def _views(*rows, mod=None):
    cls = ReplicaView if mod is None else mod.ReplicaView
    return [cls(i, alive, qd, occ, fs)
            for i, (alive, qd, occ, fs) in enumerate(rows)]


def test_least_occupancy_ranking():
    rows = ((True, 5, 0.75, 1), (True, 0, 0.25, 3), (False, 0, 0.0, 4),
            (True, 2, 0.25, 3))
    assert least_occupancy(_views(*rows)) == [1, 3, 0]
    assert least_occupancy(_views(*rows)) == jax_router.least_occupancy(
        _views(*rows, mod=jax_router))


def test_jsq_ranking():
    rows = ((True, 4, 0.0, 4), (True, 1, 0.5, 2), (True, 1, 0.0, 4))
    assert join_shortest_queue(_views(*rows)) == [2, 1, 0]
    assert join_shortest_queue(_views(*rows)) == \
        jax_router.join_shortest_queue(_views(*rows, mod=jax_router))


def test_round_robin_rotates_over_alive():
    rr, jrr = RoundRobin(), jax_router.RoundRobin()
    rows = ((True, 0, 0.0, 4), (False, 0, 0.0, 4), (True, 0, 0.0, 4))
    got = [rr(_views(*rows)) for _ in range(3)]
    assert got == [[0, 2], [2, 0], [0, 2]]
    assert got == [jrr(_views(*rows, mod=jax_router)) for _ in range(3)]
    assert rr(_views((False, 0, 0.0, 4))) == []


def test_make_policy_rejects_unknown():
    with pytest.raises(ValueError, match="unknown route policy"):
        make_policy("fastest-first")
    assert make_policy(least_occupancy) is least_occupancy
    # named factories hand out fresh state per router
    assert make_policy("round-robin") is not make_policy("round-robin")


# ---------------------------------------------------------------------------
# Byte-parity pins
# ---------------------------------------------------------------------------


def test_chaos_failover_byte_parity(models, baseline):
    """Kill 1 of 3 replicas mid-flight: nothing lost, every completion
    byte-identical to the undisturbed single engine, and the tier's
    counters equal the JAX router's."""
    def run(router_cls, api, params, kill):
        router = router_cls(api, params, n_replicas=3, n_slots=N_SLOTS,
                            chunk=CHUNK)
        for p, n in _traffic():
            router.submit(p, n)
        for _ in range(3):       # let the victim accept + decode real work
            router.step()
        victim = next(i for i in range(3)
                      if any(s is not None for s in router.engines[i].active))
        kill(router, victim)
        out = router.run()
        return victim, _tokens(out), router.stats(), dict(router.errors)

    want, got = _both(models, run)
    assert got == want
    victim, out, stats, errors = got
    assert stats["failed_over"] > 0 and not errors
    assert out == baseline


def test_drain_byte_parity(models, baseline):
    """Planned drain: queued + active requests carry-migrate to the
    survivors and continue byte-identically."""
    def run(router_cls, api, params, kill):
        router = router_cls(api, params, n_replicas=2, n_slots=N_SLOTS,
                            chunk=CHUNK)
        for p, n in _traffic():
            router.submit(p, n)
        for _ in range(3):
            router.step()
        victim = next(i for i in range(2)
                      if any(s is not None for s in router.engines[i].active))
        n_moved = router.drain(victim)
        out = router.run()
        idle = not any(s is not None for s in router.engines[victim].active)
        return victim, n_moved, idle, _tokens(out), router.stats()

    want, got = _both(models, run)
    assert got == want
    victim, n_moved, idle, out, stats = got
    assert n_moved > 0 and stats["migrated"] == n_moved and idle
    assert out == baseline


def test_threaded_step_equals_serial(models, baseline):
    """Replicas on one device step in turn by default; stepped on worker
    threads (``parallel_step=True``) through a crash and a drain, the tier
    gives the same tokens and counters."""
    _, _, api, params = models

    def run(parallel_step):
        router = ReplicatedRouter(api, params, n_replicas=3,
                                  n_slots=N_SLOTS, chunk=CHUNK,
                                  parallel_step=parallel_step)
        for p, n in _traffic():
            router.submit(p, n)
        for _ in range(3):
            router.step()
        kill_router_replica(router, 0)
        router.step()
        router.drain(1)
        out = router.run()
        threaded = router._pool is not None
        router.close()
        return _tokens(out), router.stats(), router._parallel, threaded

    serial, threads = run(None), run(True)
    assert serial[2:] == (False, False) and threads[2:] == (True, True)
    assert serial[:2] == threads[:2]
    assert serial[0] == baseline and serial[1]["failed_over"] > 0


def test_reinstate_after_drain(models, baseline):
    """A drained replica returns to duty; with no survivors, run() refuses
    to spin instead of hanging."""
    _, _, api, params = models
    router = ReplicatedRouter(api, params, n_replicas=1, n_slots=N_SLOTS,
                              chunk=CHUNK)
    for p, n in _traffic():
        router.submit(p, n)
    router.step()
    router.drain(0)              # sole replica: everything parks in front
    assert router.front
    with pytest.raises(RuntimeError, match="no alive replicas"):
        router.run()
    router.reinstate(0)
    assert _tokens(router.run()) == baseline


# ---------------------------------------------------------------------------
# Tier-wide degradation
# ---------------------------------------------------------------------------


def test_shed_only_when_all_replicas_saturated_and_front_full(models):
    """One replica rejecting re-routes to the next-best; the tier sheds
    only at total saturation, before any id or record is allocated."""
    def run(router_cls, api, params, kill):
        router = router_cls(api, params, n_replicas=2, n_slots=1,
                            chunk=CHUNK, max_queue=1,
                            policy=lambda views: [0, 1])
        p = np.arange(4, dtype=np.int32)
        r0 = router.submit(p, 2)     # -> replica 0's queue (now full)
        r1 = router.submit(p, 2)     # replica 0 rejects -> re-routed to 1
        assert router.n_rerouted == 1 and router.engines[1].queue
        r2 = router.submit(p, 2)     # both queues full -> front queue
        assert [d["request_id"] for d in router.front] == [r2]
        with pytest.raises(Exception, match="front queue is full") as exc:
            router.submit(p, 2)      # all saturated AND front full -> shed
        assert type(exc.value).__name__ == "EngineOverloaded"
        assert router.stats()["requests"] == 3   # shed allocated no id
        out = router.run()
        return sorted(out) == [r0, r1, r2], _tokens(out), router.stats()

    want, got = _both(models, run)
    assert got == want and got[0]
    assert got[2]["shed"] == 1


def test_front_queue_fifo_no_jumping(models):
    _, _, api, params = models
    router = ReplicatedRouter(api, params, n_replicas=1, n_slots=1,
                              chunk=CHUNK)
    p = np.arange(4, dtype=np.int32)
    router.submit(p, 2)          # fills the 1-deep replica queue
    waiting = router.submit(p, 2)
    late = router.submit(p, 2)
    assert [d["request_id"] for d in router.front] == [waiting, late]


def test_front_queue_deadline_expires(models):
    """Deadlines keep billing while a request waits at the front."""
    _, _, api, params = models
    router = ReplicatedRouter(api, params, n_replicas=1, n_slots=1,
                              chunk=CHUNK)
    p = np.arange(4, dtype=np.int32)
    router.submit(p, 3)
    rid = router.submit(p, 3, deadline_s=0.03)   # parks in the front queue
    assert [d["request_id"] for d in router.front] == [rid]
    time.sleep(0.05)
    out = router.run()
    assert router.errors[rid] == ERR_DEADLINE
    assert rid not in out


def test_migration_keeps_one_deadline_budget(models):
    """A migrated request's deadline is re-based as *remaining* budget."""
    _, _, api, params = models
    router = ReplicatedRouter(api, params, n_replicas=2, n_slots=N_SLOTS,
                              chunk=CHUNK)
    p, n = _traffic(1)[0]
    t0 = time.perf_counter()
    router.submit(p, n, deadline_s=30.0)
    router.step()
    victim = next(i for i in range(2)
                  if any(s is not None for s in router.engines[i].active)
                  or router.engines[i].queue)
    assert router.drain(victim) == 1
    q = router.engines[1 - victim].queue[-1]
    assert q.deadline is not None and q.carry is not None
    assert q.deadline == pytest.approx(t0 + 30.0, abs=1.0)


# ---------------------------------------------------------------------------
# Tier-wide ids + per-replica observability
# ---------------------------------------------------------------------------


def test_tier_unique_ids_and_sampling_seeds(models):
    """Ids are allocated tier-wide, and a custom (per-row) sampler sees a
    distinct ``(request_id, step)``-absolute seed for every token."""
    _, _, api, params = models
    seen = []

    def recording(logits, seeds):
        seen.append(int(seeds[0]))
        return logits.argmax(dim=-1)

    router = ReplicatedRouter(api, params, n_replicas=2, n_slots=1,
                              chunk=CHUNK, sampler=recording,
                              policy="round-robin")
    p = np.arange(6, dtype=np.int32)
    rids = [router.submit(p, 3) for _ in range(2)]   # one per replica
    assert rids == [0, 1]
    assert sorted(router.run()) == rids
    assert len(seen) == 6                            # 2 requests x 3 steps
    assert len(set(seen)) == 6, "sampling seeds reused across replicas"


def test_per_replica_gauges_and_tier_aggregates(models):
    """Each replica's serve_* series lands under its replica label, the
    router publishes tier aggregates equal to the JAX router's, and
    replica_views reads the gauges."""
    def run(router_cls, api, params, kill):
        jax_side = router_cls is JaxRouter
        reg = JaxRegistry() if jax_side else MetricsRegistry()
        with (jax_use_metrics if jax_side else use_metrics)(reg):
            router = router_cls(api, params, n_replicas=2, n_slots=2,
                                chunk=CHUNK)
            for p, n in _traffic(4):
                router.submit(p, n)
            router.step()
            views = {v.index: v for v in router.replica_views()}
            for i in range(2):
                occ = reg.peek("serve_slot_occupancy", {"replica": i})
                assert occ is not None and views[i].occupancy == occ
            router.run()
        snap = reg.snapshot()
        return ({k: v["value"] for k, v in snap["counters"].items()},
                {k: v["value"] for k, v in snap["gauges"].items()})

    want, got = _both(models, run)
    assert got == want
    counters, gauges = got
    assert gauges["router_replicas_alive"] == 2
    assert gauges["router_front_queue_depth"] == 0
    assert counters["router_requests_total"] == 4
    done = [k for k in counters
            if k.startswith('serve_requests_completed_total{replica=')]
    assert len(done) >= 1 and sum(counters[k] for k in done) == 4


# ---------------------------------------------------------------------------
# Cross-replica prefix-cache sharing
# ---------------------------------------------------------------------------


def test_prefix_cache_shared_across_replicas(models):
    """The same prompt served on replica A then replica B: B's prefill
    skips cached chunks and the output is byte-identical to a cold single
    engine's."""
    _, _, api, params = models
    prompt = np.random.default_rng(5).integers(0, 64, 4 * CHUNK).astype(
        np.int32)
    cold_eng = StreamingEngine(api, params, n_slots=1, chunk=CHUNK)
    cold_eng.submit(prompt, 6)
    cold = cold_eng.run()[0]

    cache = PrefixCache(max_bytes=4 << 20, min_hits=1)
    router = ReplicatedRouter(api, params, n_replicas=2, n_slots=1,
                              chunk=CHUNK, policy="round-robin",
                              prefix_cache=cache)
    r0 = router.submit(prompt, 6)        # replica A: populates the cache
    router.run()
    saved0 = cache.stats()["prefill_tokens_saved"]
    r1 = router.submit(prompt, 6)        # replica B (round-robin rotated)
    out = router.run()
    assert router.engines[1]._next_id == 2, \
        "round-robin did not place the second request on replica B"
    st = cache.stats()
    assert st["hit_rate"] > 0 and st["prefill_tokens_saved"] > saved0
    assert out[r0] == cold and out[r1] == cold
    assert router.stats()["failed_over"] == 0
