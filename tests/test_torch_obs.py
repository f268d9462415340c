"""The port's observability layer (``repro_torch.obs``) — the cases of
``tests/test_obs.py`` for everything ported — and the train loop's and the
streaming engine's instruments riding on it.

Across the packages: the same registry operations give byte-equal
Prometheus text and equal snapshot payloads, and an event log the port
writes passes the JAX package's ``validate_events``.  Model:
``smoke_config("phi3-mini-3.8b", n_layers=1)``, batches of 2 x 16.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.obs import events as jax_events
from repro.obs import export as jax_export
from repro.obs import metrics as jax_metrics
from repro_torch.configs import smoke_config
from repro_torch.data.packing import PackedLMIterator
from repro_torch.data.synthetic import SyntheticLMIterator
from repro_torch.models.factory import build
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.events import (
    EventLog,
    read_events,
    run_metadata,
    use_events,
    validate_event,
    validate_events,
)
from repro_torch.obs.export import (
    prometheus_text,
    serve_metrics,
    snapshot_document,
    write_snapshot,
)
from repro_torch.obs.metrics import (
    Counter,
    Histogram,
    MetricsRegistry,
    use_metrics,
)
from repro_torch.serving.engine import StreamingEngine
from repro_torch.train.guard import GUARD_METRIC_KEYS, GuardConfig
from repro_torch.train.loop import LoopConfig, run_train_loop
from repro_torch.train.optim import make_optimizer, warmup_cosine
from repro_torch.train.state import init_train_state, make_train_step

DATA = dict(seq_len=16, batch=2, seed=0)


@pytest.fixture(scope="module")
def model():
    cfg = smoke_config("phi3-mini-3.8b", n_layers=1)
    return cfg, build(cfg)


def _train_setup(model, guard=None):
    cfg, api = model
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 2, 20))
    state = init_train_state(api.init(0, device="cpu"), opt, guard=guard)
    return state, make_train_step(api.loss, opt, guard=guard)


def _data(model):
    return SyntheticLMIterator(vocab=model[0].vocab, **DATA)


def _loop(total, **kw):
    return LoopConfig(total_steps=total, install_signal_handlers=False, **kw)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def _drive(mod):
    """One sequence of registry operations through a package's metrics
    module: every instrument kind, labels, label scopes and the ambient
    helpers."""
    reg = mod.MetricsRegistry()
    reg.counter("serve_shed_total").inc(3)
    reg.gauge("serve_queue_depth").set(2)
    h = reg.histogram("serve_ttft_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0, 0.1):
        h.observe(v)
    with mod.use_metrics(reg):
        mod.inc("serve_requests_total", labels={"replica": "0"})
        with mod.label_scope(replica=1, zone='a"b'):
            mod.inc("serve_requests_total", 2)
            mod.set_gauge("serve_slot_occupancy", 0.75)
            mod.observe("serve_itl_s", 0.003)
            mod.observe("serve_itl_s", 0.2)
        mod.set_gauge("train_grad_norm", 1.0 / 3.0)
        mod.observe("train_step_time_s", 12.5)
    return reg


def test_registry_text_and_snapshot_equal_jax():
    treg, jreg = _drive(obs_metrics), _drive(jax_metrics)
    assert treg.snapshot() == jreg.snapshot()
    ttext = prometheus_text(treg.snapshot())
    assert ttext == jax_export.prometheus_text(jreg.snapshot())
    assert 'serve_requests_total{replica="1",zone="a\\"b"} 2' in ttext
    tdoc, jdoc = snapshot_document(treg), jax_export.snapshot_document(jreg)
    assert tdoc["schema"] == jdoc["schema"] == 1
    assert tdoc["metrics"] == jdoc["metrics"]


def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    c = reg.counter("c_total")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g")
    g.set(4)
    g.set(2)
    assert g.value == 2.0
    h = reg.histogram("h_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 10.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["histograms"]["h_s"]["counts"] == [1, 2, 1]
    assert snap["histograms"]["h_s"]["count"] == 4
    assert json.loads(json.dumps(snap)) == snap


def test_registry_get_or_create_and_kind_conflicts():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    reg.histogram("h", buckets=(1.0,))
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=(2.0,))
    assert isinstance(reg.counter("y"), Counter)
    assert isinstance(reg.histogram("h", buckets=(1.0,)), Histogram)


def test_histogram_quantile():
    h = Histogram("q", buckets=(1.0, 2.0, 3.0))
    assert np.isnan(h.quantile(0.5))
    for v in (0.5, 1.5, 1.5, 2.5):
        h.observe(v)
    assert h.quantile(0.5) == 2.0 and h.quantile(1.0) == 3.0
    with pytest.raises(ValueError):
        h.quantile(1.5)


def test_helpers_noop_without_registry_and_scoped():
    assert obs_metrics.current() is None
    obs_metrics.inc("a")
    obs_metrics.set_gauge("b", 1.0)
    obs_metrics.observe("c", 1.0)
    reg = MetricsRegistry()
    with use_metrics(reg):
        obs_metrics.inc("a")
    assert obs_metrics.current() is None
    assert reg.names() == ["a"]


def test_registry_thread_safety():
    reg = MetricsRegistry()

    def work():
        for _ in range(2000):
            reg.counter("n").inc()
            reg.histogram("h").observe(0.01)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert reg.counter("n").value == 16000
    assert reg.histogram("h").count == 16000


def test_label_scope_is_thread_local():
    reg = MetricsRegistry()
    seen = {}

    def other():
        seen["labels"] = obs_metrics.current_labels()
        with use_metrics(reg):
            obs_metrics.inc("t")

    with obs_metrics.label_scope(replica=0):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert seen["labels"] is None
    assert reg.names() == ["t"]


# ---------------------------------------------------------------------------
# Event log
# ---------------------------------------------------------------------------


def test_event_log_envelope_validates_in_both_packages(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    with EventLog(path) as log:
        log.emit("a", x=1)
        log.emit("b", y=[1, 2])
    recs = read_events(path)
    assert [r["kind"] for r in recs] == ["run_meta", "a", "b"]
    assert [r["seq"] for r in recs] == [0, 1, 2]
    validate_events(recs)
    jax_events.validate_events(recs)
    assert jax_events.SCHEMA_VERSION == obs_events.SCHEMA_VERSION
    assert jax_events.ENVELOPE_KEYS == obs_events.ENVELOPE_KEYS
    mem = EventLog(None)
    assert mem.records[0]["kind"] == "run_meta"
    with pytest.raises(ValueError):
        log.emit("after close")


def test_validate_rejects_malformed():
    good = EventLog(None).records[0]
    validate_event(good)
    for bad in ({**good, "schema": 2}, {**good, "kind": ""},
                {**good, "data": []}, {**good, "seq": -1},
                {k: v for k, v in good.items() if k != "run"}):
        with pytest.raises(ValueError):
            validate_event(bad)
    with pytest.raises(ValueError, match="run_meta"):
        validate_events([{**good, "kind": "x"}])
    with pytest.raises(ValueError):
        validate_events([])


def test_ambient_emit_noop_and_scoped():
    assert obs_events.current() is None
    assert obs_events.emit("dropped") is None
    with use_events(EventLog(path=None)) as log:
        obs_events.emit("kept", n=1)
    assert obs_events.current() is None
    assert [r["kind"] for r in log.records] == ["run_meta", "kept"]


def test_run_metadata_provenance():
    meta = run_metadata({"extra_key": "v"})
    for k in ("git_sha", "torch_version", "torch_cuda", "backend",
              "device_count", "device_kind", "utc"):
        assert k in meta, k
    assert "jax_version" not in meta and "kernel_mode" not in meta
    assert meta["extra_key"] == "v"
    assert meta["torch_version"] == torch.__version__
    assert meta["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")


# ---------------------------------------------------------------------------
# Trace gate
# ---------------------------------------------------------------------------


def test_span_off_is_shared_null():
    prev = obs_trace.set_enabled(False)
    try:
        assert obs_trace.span("a") is obs_trace.span("b")
        with obs_trace.span("a"):
            pass
    finally:
        obs_trace.set_enabled(prev)


def test_traced_step_names_its_phases_in_the_profiler(model):
    """Tracing on, a CPU torch.profiler run of one training step shows the
    ``train.step`` span and the dispatch spans of the plain scans."""
    state, step = _train_setup(model)
    prev = obs_trace.set_enabled(True)
    try:
        assert obs_trace.span("x") is not obs_trace.span("x")

        @obs_trace.annotate("fn")
        def f(v):
            return v + 1

        assert f(1) == 2
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run_train_loop(step, state, _data(model), _loop(1))
    finally:
        obs_trace.set_enabled(prev)
    names = {e.key for e in prof.key_averages()}
    for want in ("train.step", "aaren_scan_fwd.plain",
                 "aaren_scan_bwd.plain"):
        assert want in names, sorted(n for n in names if "." in n)


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------


def _sample_registry():
    reg = MetricsRegistry()
    reg.counter("serve_shed_total").inc(3)
    reg.gauge("serve_queue_depth").set(2)
    h = reg.histogram("serve_ttft_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg


def test_prometheus_text_and_snapshot_document(tmp_path):
    text = prometheus_text(_sample_registry().snapshot())
    assert "# TYPE serve_shed_total counter\nserve_shed_total 3" in text
    assert 'serve_ttft_s_bucket{le="1"} 2' in text
    assert 'serve_ttft_s_bucket{le="+Inf"} 3' in text
    assert prometheus_text({}).strip() == ""
    doc = snapshot_document(_sample_registry())
    assert doc["schema"] == 1 and "git_sha" in doc["meta"]
    assert snapshot_document()["metrics"] == {
        "counters": {}, "gauges": {}, "histograms": {}}
    p = str(tmp_path / "m.json")
    write_snapshot(p, _sample_registry())
    assert json.load(open(p))["metrics"]["gauges"][
        "serve_queue_depth"]["value"] == 2


def test_serve_metrics_http_endpoints():
    reg = _sample_registry()
    server = serve_metrics(reg, port=0)
    try:
        host, port = server.server_address[:2]
        assert host == "127.0.0.1"
        base = f"http://{host}:{port}"
        text = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "serve_shed_total 3" in text
        doc = json.loads(
            urllib.request.urlopen(f"{base}/metrics.json").read())
        assert doc["metrics"]["counters"]["serve_shed_total"]["value"] == 3
        reg.counter("serve_shed_total").inc()
        text = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "serve_shed_total 4" in text
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope")
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# Train-loop instrumentation
# ---------------------------------------------------------------------------


def test_train_loop_smoke_events_and_metrics(model, tmp_path):
    """One guarded run with obs on: a JSONL log valid in both packages and
    a snapshot carrying the named train instruments; the loop removes what
    it installed."""
    state, step = _train_setup(model, guard=GuardConfig())
    events_path = str(tmp_path / "events.jsonl")
    metrics_path = str(tmp_path / "metrics.json")
    res = run_train_loop(step, state, _data(model),
                         _loop(4, log_every=2, guard=True,
                               events=events_path, metrics_out=metrics_path))
    assert res.state.step == 4
    assert obs_events.current() is None and obs_metrics.current() is None
    recs = read_events(events_path)
    validate_events(recs)
    jax_events.validate_events(recs)
    kinds = [r["kind"] for r in recs]
    assert kinds[0] == "run_meta" and kinds[-1] == "run_end"
    assert kinds.count("train_step") == 2           # steps 0 and 2
    assert recs[-1]["data"]["step"] == 4
    assert recs[-1]["data"]["preempted"] is False
    m = json.load(open(metrics_path))["metrics"]
    assert m["histograms"]["train_step_time_s"]["count"] == 4
    assert m["counters"]["train_tokens_total"]["value"] == 4 * 2 * 16
    assert m["gauges"]["train_tokens_per_s"]["value"] > 0
    assert m["gauges"]["train_grad_norm"]["value"] > 0
    assert m["gauges"]["train_guard_lr_scale"]["value"] == 1.0


def test_train_step_events_carry_on_log_metrics_verbatim(model):
    state, step = _train_setup(model, guard=GuardConfig())
    seen = {}
    log = EventLog(path=None)
    with use_events(log):
        run_train_loop(step, state, _data(model),
                       _loop(3, log_every=1, guard=True),
                       on_log=lambda s, m: seen.setdefault(s, dict(m)))
    by_step = {r["data"]["step"]: r["data"] for r in log.records
               if r["kind"] == "train_step"}
    assert set(by_step) == set(seen) == {0, 1, 2}
    for s, m in seen.items():
        assert by_step[s] == {"step": s, **m}
        for k in GUARD_METRIC_KEYS:
            assert k in by_step[s], k


def test_ambient_sink_wins_over_loop_config(model, tmp_path):
    state, step = _train_setup(model)
    unused = tmp_path / "unused.jsonl"
    log = EventLog(path=None)
    with use_events(log):
        run_train_loop(step, state, _data(model),
                       _loop(1, events=str(unused)))
    assert not unused.exists()
    assert log.records[-1]["kind"] == "run_end"


def test_straggler_flags_after_warmup_with_event_and_counter(model):
    state, step = _train_setup(model)
    reg, log = MetricsRegistry(), EventLog(path=None)
    with use_metrics(reg), use_events(log):
        res = run_train_loop(step, state, _data(model),
                             _loop(8, straggler_warmup=3),
                             _test_hooks={"sleep": {6: 10.0}})
    flagged = [s for s, _, _ in res.stragglers]    # real step times vary
    assert 6 in flagged
    assert reg.snapshot()["counters"]["train_straggler_total"][
        "value"] == len(flagged)
    assert [r["data"]["step"] for r in log.records
            if r["kind"] == "straggler"] == flagged


def test_loop_token_utilization_gauge(model):
    state, step = _train_setup(model)
    kw = dict(vocab=model[0].vocab, seq_len=16, batch=2, seed=3)
    reg = MetricsRegistry()
    with use_metrics(reg):
        res = run_train_loop(step, state, PackedLMIterator(**kw),
                             _loop(2, log_every=1, pack_sequences=True))
    ref = PackedLMIterator(**kw)
    utils = [float((np.asarray(next(ref)["segment_ids"]) != 0).mean())
             for _ in range(2)]
    assert reg.snapshot()["gauges"]["train_token_util"]["value"] == (
        pytest.approx(utils[-1]))
    assert res.history[0][1]["token_util"] == pytest.approx(utils[0])


def test_loop_metrics_out_installs_own_registry(model, tmp_path):
    state, step = _train_setup(model)
    p = str(tmp_path / "m.json")
    run_train_loop(step, state, _data(model), _loop(2, metrics_out=p))
    assert obs_metrics.current() is None
    m = json.load(open(p))["metrics"]
    assert m["histograms"]["train_step_time_s"]["count"] == 2
    assert m["counters"]["train_tokens_total"]["value"] == 2 * 2 * 16


# ---------------------------------------------------------------------------
# Serving-engine instrumentation
# ---------------------------------------------------------------------------


def _serve(model, params, prompts, max_new=5):
    eng = StreamingEngine(model[1], params, n_slots=2, chunk=8)
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    return eng, [out[r] for r in rids]


def test_engine_smoke_events_and_metrics_and_identical_tokens(model):
    """One serving run with obs on: the TTFT/ITL histograms, token counters,
    occupancy gauge and a valid event log; the tokens are byte-identical to
    a run with obs off, and the latency maps end empty in both."""
    cfg, api = model
    params = api.init(0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 20))
    _, off = _serve(model, params, prompts)
    reg, log = MetricsRegistry(), EventLog(path=None)
    with use_metrics(reg), use_events(log):
        eng, on = _serve(model, params, prompts)
    assert on == off
    assert eng.submitted_at == {} and eng.first_token_at == {}
    validate_events(log.records)
    jax_events.validate_events(log.records)
    kinds = [r["kind"] for r in log.records]
    for kind in ("request_submitted", "first_token", "request_completed"):
        assert kinds.count(kind) == 4, kind
    for d in (r["data"] for r in log.records
              if r["kind"] == "request_completed"):
        assert d["n_tokens"] == 5 and d["total_s"] >= d["ttft_s"] > 0
    snap = reg.snapshot()
    assert snap["counters"]["serve_requests_total"]["value"] == 4
    assert snap["counters"]["serve_requests_completed_total"]["value"] == 4
    assert snap["histograms"]["serve_ttft_s"]["count"] == 4
    assert snap["histograms"]["serve_itl_s"]["count"] == 16
    assert snap["counters"]["serve_prefill_tokens_total"]["value"] == 80
    assert snap["counters"]["serve_decode_tokens_total"]["value"] == 16
    assert 0 < snap["gauges"]["serve_slot_occupancy"]["value"] <= 1.0
    assert snap["gauges"]["serve_queue_depth"]["value"] == 0


def test_engine_latency_maps_evicted_over_waves(model):
    cfg, api = model
    params = api.init(0, device="cpu")
    eng = StreamingEngine(api, params, n_slots=2, chunk=4)
    rng = np.random.default_rng(1)
    for _ in range(3):
        for p in rng.integers(0, cfg.vocab, (3, 5)):
            eng.submit(p, 2)
        eng.run()
    assert len(eng.finished) == 9
    assert eng.submitted_at == {} and eng.first_token_at == {}


def test_engine_traced_tick_names_its_phases(model):
    cfg, api = model
    params = api.init(0, device="cpu")
    eng = StreamingEngine(api, params, n_slots=2, chunk=4)
    eng.submit(np.arange(6), 2)
    prev = obs_trace.set_enabled(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            eng.run()
    finally:
        obs_trace.set_enabled(prev)
    names = {e.key for e in prof.key_averages()}
    for want in ("engine.schedule", "engine.step", "engine.sample",
                 "aaren_scan_fwd.plain"):
        assert want in names


def test_serve_launcher_writes_events_and_snapshot(tmp_path, capsys):
    """``launch/serve.py --events --metrics-out --metrics-port``: a valid
    event log with every request's events, a snapshot with the request
    counters, and the endpoint's address printed and shut down."""
    from repro_torch.launch import serve as serve_cli

    ev, snap = str(tmp_path / "serve.jsonl"), str(tmp_path / "serve.json")
    serve_cli.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
                    "--requests", "2", "--prompt-len", "5", "--max-new", "3",
                    "--events", ev, "--metrics-out", snap,
                    "--metrics-port", "0"])
    out = capsys.readouterr().out
    assert "metrics: http://127.0.0.1:" in out and "metrics snapshot" in out
    recs = read_events(ev)
    validate_events(recs)
    assert [r["kind"] for r in recs].count("request_completed") == 2
    counters = json.load(open(snap))["metrics"]["counters"]
    assert counters["serve_requests_total"]["value"] == 2
    assert counters["serve_decode_tokens_total"]["value"] == 2 * 2
    assert obs_metrics.current() is None and obs_events.current() is None
