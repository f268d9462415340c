"""The port's serving degradation against the JAX package's: slot
quarantine, deadlines, ``max_queue`` shedding and engine snapshots (the
engine half of ``tests/test_fault_tolerance.py``), their instruments and
events (``tests/test_obs.py``), the same metric names and counter values
as the JAX registry after the same scenario — and the kernels' launch
counters under threads.
"""

import sys
import tempfile
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.factory import build as jax_build
from repro.obs.events import EventLog as JaxEventLog
from repro.obs.events import use_events as jax_use_events
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.obs.metrics import use_metrics as jax_use_metrics
from repro.serving import ReplicatedRouter as JaxRouter
from repro.serving import StreamingEngine as JaxStreamingEngine
from repro.testing import poison_engine_slot as jax_poison
from repro_torch.configs import smoke_config
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.aaren_scan import aaren_scan
from repro_torch.kernels.aaren_scan_bwd import aaren_scan_bwd
from repro_torch.models.convert import params_from_jax
from repro_torch.models.factory import build
from repro_torch.models.lm import lm_state_init
from repro_torch.obs.events import EventLog, use_events, validate_events
from repro_torch.obs.metrics import MetricsRegistry, use_metrics
from repro_torch.serving import (
    ERR_DEADLINE,
    ERR_POISONED,
    EngineOverloaded,
    ReplicatedRouter,
    StreamingEngine,
    generate,
)
from repro_torch.testing import corrupt_checkpoint, poison_engine_slot
from repro_torch.train import guard as tguard

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=64)


@pytest.fixture(scope="module")
def models():
    japi = jax_build(jax_smoke_config("phi3-mini-3.8b", **SMALL))
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build(smoke_config("phi3-mini-3.8b", **SMALL))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), api.cfg,
                             "cpu")
    return japi, jparams, api, params


def _prompts(n, length, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (n, length)).astype(
        np.int32)


def _carry_is_init(api, eng, slot):
    init = lm_state_init(api.cfg, eng.n_slots, device="cpu")
    return all(torch.equal(a[slot], b[slot])
               for sa, sb in zip(eng.states, init) for a, b in zip(sa, sb))


# ---------------------------------------------------------------------------
# Quarantine
# ---------------------------------------------------------------------------


def test_poisoned_slot_quarantined_batchmates_byte_identical(models):
    """NaN-carry slot 1 errors out and is reset to the init carry; slots 0
    and 2 produce exactly the tokens of an uninjected run, which equal the
    JAX engine's, as in the JAX package's own poisoned run."""
    japi, jparams, api, params = models
    prompts = _prompts(3, 5)

    def run(eng_cls, a, p, poison):
        clean = eng_cls(a, p, n_slots=3)
        rc = [clean.submit(prompts[i], 6) for i in range(3)]
        out_clean = clean.run()
        eng = eng_cls(a, p, n_slots=3)
        rids = [eng.submit(prompts[i], 6) for i in range(3)]
        eng.step(), eng.step()
        poison(eng, 1)
        eng.step()
        freed = eng.active[1] is None
        out = eng.run()
        return ([list(map(int, out_clean[r])) for r in rc],
                {r: list(map(int, t)) for r, t in out.items()},
                dict(eng.errors), eng.n_quarantined, rids, freed)

    want = run(JaxStreamingEngine, japi, jparams, jax_poison)
    got = run(StreamingEngine, api, params, poison_engine_slot)
    assert got == want
    clean, out, errors, n_quarantined, rids, freed = got
    assert errors == {rids[1]: ERR_POISONED} and n_quarantined == 1
    assert freed and rids[1] not in out
    assert out[rids[0]] == clean[0] and out[rids[2]] == clean[2]


def test_quarantined_slot_serves_next_request_correctly(models):
    """The quarantined slot's carry is the init carry bit for bit, and the
    next request through it matches a dedicated ``generate``."""
    _, _, api, params = models
    prompts = _prompts(2, 5, seed=1)
    eng = StreamingEngine(api, params, n_slots=1)
    r0 = eng.submit(prompts[0], 6)
    eng.step(), eng.step()
    poison_engine_slot(eng, 0)
    eng.run()
    assert eng.errors[r0] == ERR_POISONED
    assert _carry_is_init(api, eng, 0)
    r1 = eng.submit(prompts[1], 6)
    out = eng.run()
    solo, _ = generate(api, params, prompts[1][None], 6)
    assert out[r1] == solo[0].tolist()


# ---------------------------------------------------------------------------
# Deadlines and shedding
# ---------------------------------------------------------------------------


def test_deadline_expires_queued_and_active(models):
    _, _, api, params = models
    prompts = _prompts(2, 4)
    eng = StreamingEngine(api, params, n_slots=1)
    # active: admitted, then the clock runs out mid-decode
    r_active = eng.submit(prompts[0], 1000, deadline_s=0.05)
    eng.step()
    # queued: never admitted before expiry (slot busy)
    r_queued = eng.submit(prompts[1], 4, deadline_s=0.01)
    time.sleep(0.08)
    out = eng.run()
    assert eng.errors[r_active] == ERR_DEADLINE
    assert eng.errors[r_queued] == ERR_DEADLINE
    assert r_active not in out and r_queued not in out
    assert _carry_is_init(api, eng, 0)


def test_load_shedding_bounded_queue(models):
    _, _, api, params = models
    prompts = _prompts(4, 4)
    eng = StreamingEngine(api, params, n_slots=1, max_queue=2)
    eng.submit(prompts[0], 2)
    eng.submit(prompts[1], 2)
    with pytest.raises(EngineOverloaded, match="queue full"):
        eng.submit(prompts[2], 2)
    assert eng.n_shed == 1
    assert len(eng.run()) == 2          # queued work still completes
    eng.submit(prompts[3], 2)           # capacity freed after the drain
    assert len(eng.run()) == 3
    with pytest.raises(ValueError, match="already in use"):
        eng.submit(prompts[0], 2, request_id=0)
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(prompts[0], 2, deadline_s=-1.0)


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------


def test_engine_snapshot_restore_midflight(models):
    """Snapshot mid-flight (one slot decoding, one mid-prefill, one
    queued): the meta equals the JAX engine's at the same point, and a
    fresh engine restored from it finishes exactly as an uninterrupted
    run."""
    japi, jparams, api, params = models
    prompts = _prompts(3, 9, seed=2)
    metas = []
    for eng_cls, a, p in ((JaxStreamingEngine, japi, jparams),
                          (StreamingEngine, api, params)):
        eng = eng_cls(a, p, n_slots=2, chunk=4)
        for i in range(3):
            eng.submit(prompts[i], 6)
        eng.step(), eng.step()
        metas.append(eng.snapshot()["meta"])
    assert metas[1] == metas[0]

    ref = StreamingEngine(api, params, n_slots=2, chunk=4)
    rr = [ref.submit(prompts[i], 6) for i in range(3)]
    out_ref = ref.run()
    a = StreamingEngine(api, params, n_slots=2, chunk=4)
    ra = [a.submit(prompts[i], 6) for i in range(3)]
    a.step(), a.step()
    snap = a.snapshot()
    b = StreamingEngine(api, params, n_slots=2, chunk=4, seed=5)
    b.restore(snap)
    assert b.seed == 0
    out = b.run()
    for i in range(3):
        assert out[ra[i]] == out_ref[rr[i]], f"request {i} diverged"


def test_engine_save_load_via_checkpoint_layer(models):
    """The newest engine checkpoint is corrupt: load falls back to the
    older one, restores its carries bit for bit and finishes correctly."""
    _, _, api, params = models
    prompts = _prompts(2, 5, seed=3)
    ref = StreamingEngine(api, params, n_slots=2)
    rr = [ref.submit(prompts[i], 6) for i in range(2)]
    out_ref = ref.run()

    a = StreamingEngine(api, params, n_slots=2)
    ra = [a.submit(prompts[i], 6) for i in range(2)]
    with tempfile.TemporaryDirectory() as d:
        a.step()
        a.save(d, 1)
        at_1 = [x.clone() for st in a.states for x in st]
        a.step()
        a.save(d, 2)
        corrupt_checkpoint(d, 2, "truncate_chunk")
        b = StreamingEngine(api, params, n_slots=2)
        assert b.load(d) == 1
        assert all(torch.equal(x, y) for x, y in zip(
            at_1, [x for st in b.states for x in st]))
        out = b.run()
    for i in range(2):
        assert out[ra[i]] == out_ref[rr[i]]


def test_engine_snapshot_shape_mismatch_rejected(models):
    _, _, api, params = models
    a = StreamingEngine(api, params, n_slots=2)
    b = StreamingEngine(api, params, n_slots=3)
    with pytest.raises(ValueError, match="n_slots"):
        b.restore(a.snapshot())


# ---------------------------------------------------------------------------
# Instruments and events
# ---------------------------------------------------------------------------


def test_engine_shed_and_deadline_instruments(models):
    _, _, api, params = models
    prompts = _prompts(4, 4, seed=4)
    reg = MetricsRegistry()
    log = EventLog(path=None)
    with use_metrics(reg), use_events(log):
        eng = StreamingEngine(api, params, n_slots=1, max_queue=2)
        eng.submit(prompts[0], 2)
        eng.submit(prompts[1], 2, deadline_s=0.0)   # expires before admit
        with pytest.raises(EngineOverloaded):
            eng.submit(prompts[2], 2)
        eng.run()
    validate_events(log.records)
    snap = reg.snapshot()
    assert snap["counters"]["serve_shed_total"]["value"] == 1
    assert snap["counters"]["serve_deadline_expired_total"]["value"] == 1
    kinds = [r["kind"] for r in log.records]
    assert "request_shed" in kinds
    expired = [r["data"] for r in log.records
               if r["kind"] == "deadline_expired"]
    assert expired and expired[0]["queued"] is True


def test_engine_latency_maps_evicted(models):
    """Every terminal path (complete, deadline, quarantine) evicts the
    per-request latency maps."""
    _, _, api, params = models
    eng = StreamingEngine(api, params, n_slots=2)
    for wave in range(5):                       # 5 waves x 4 requests
        for p in _prompts(4, 6, seed=10 + wave):
            eng.submit(p, 3)
        eng.run()
    assert len(eng.finished) == 20
    assert eng.submitted_at == {} and eng.first_token_at == {}
    p = _prompts(2, 4, seed=20)
    r0 = eng.submit(p[0], 1000, deadline_s=0.0)
    eng.run()
    assert r0 in eng.errors
    assert eng.submitted_at == {} and eng.first_token_at == {}
    r1 = eng.submit(p[1], 6)
    eng.step(), eng.step()
    poison_engine_slot(eng, 0)
    eng.run()
    assert r1 in eng.errors
    assert eng.submitted_at == {} and eng.first_token_at == {}


def _scenario(router_cls, api, params, poison):
    """Shedding, a queued deadline, a quarantine, a drain (migration and
    injection) and completions, through a 2-replica tier."""
    prompts = _prompts(7, 12, seed=6)
    router = router_cls(api, params, n_replicas=2, n_slots=2, chunk=4,
                        max_queue=1, policy=lambda views: [0, 1])
    router.engines[1].submit(prompts[6], 4, deadline_s=0.0,
                             request_id=100)
    for p in prompts[:4]:
        router.submit(p, 4)
    with pytest.raises(Exception, match="front queue is full"):
        router.submit(prompts[5], 4)
    router.step(), router.step()
    poison(router.engines[0], 1)
    router.step()
    router.drain(1)
    router.run()
    return router


def test_registry_names_and_counters_equal_jax(models):
    """The same scenario in both packages: the registries hold the same
    series names, equal counter values and equal gauges; the event logs
    hold the same event kinds in the same numbers."""
    japi, jparams, api, params = models
    jreg, jlog = JaxRegistry(), JaxEventLog(path=None)
    with jax_use_metrics(jreg), jax_use_events(jlog):
        jr = _scenario(JaxRouter, japi, jparams, jax_poison)
    reg, log = MetricsRegistry(), EventLog(path=None)
    with use_metrics(reg), use_events(log):
        r = _scenario(ReplicatedRouter, api, params, poison_engine_slot)
    validate_events(log.records)
    assert reg.names() == jreg.names()
    got, want = reg.snapshot(), jreg.snapshot()
    for kind in ("counters", "gauges"):
        assert ({k: v["value"] for k, v in got[kind].items()}
                == {k: v["value"] for k, v in want[kind].items()})
    assert ({k: v["count"] for k, v in got["histograms"].items()}
            == {k: v["count"] for k, v in want["histograms"].items()})
    kinds = sorted(rec["kind"] for rec in log.records)
    assert kinds == sorted(rec["kind"] for rec in jlog.records)
    for k in ("request_shed", "deadline_expired", "quarantine",
              "request_migrated", "request_injected"):
        assert k in kinds, k
    assert r.stats() == jr.stats()
    assert ({k: list(map(int, v)) for k, v in r.finished.items()}
            == {k: list(map(int, v)) for k, v in jr.finished.items()})
    counters = {k: v["value"] for k, v in got["counters"].items()}
    for name in ("serve_shed_total", "serve_deadline_expired_total",
                 "serve_quarantine_total", "serve_migrated_total",
                 "serve_injected_total"):
        assert sum(v for k, v in counters.items()
                   if k.split("{")[0] == name) >= 1, name


# ---------------------------------------------------------------------------
# Repairs: launch counters under threads, the guard carry's device
# ---------------------------------------------------------------------------


def test_launch_counters_exact_under_threads():
    """Eight threads counting launches of every wrapper lose no update."""
    wrappers = (aaren_scan, aaren_scan_bwd, fa.flash_attention,
                fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [w.n_launches for w in wrappers]
    n = 4000

    def work():
        for _ in range(n):
            for w in wrappers:
                kbuild.count_launch(w)

    threads = [threading.Thread(target=work) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # switch threads often
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert [w.n_launches - b for w, b in zip(wrappers, before)] == \
        [8 * n] * len(wrappers)


def test_guard_state_defaults_to_the_card():
    """``init_guard_state`` runs on the card unless asked for the CPU."""
    cfg = tguard.GuardConfig()
    if torch.cuda.is_available():
        assert tguard.init_guard_state(cfg).lr_scale.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tguard.init_guard_state(cfg)
    assert tguard.init_guard_state(cfg, device="cpu").lr_scale.device.type \
        == "cpu"
