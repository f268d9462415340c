"""Observability layer of the port: the PyTorch twin of ``repro.obs``.

* :mod:`repro_torch.obs.metrics` — process-local registry of counters,
  gauges and fixed-bucket histograms (a copy of the JAX package's).
* :mod:`repro_torch.obs.events` — structured JSONL event sink with the same
  schema-versioned envelope; the run header carries torch and card info.
* :mod:`repro_torch.obs.trace` — ``torch.profiler.record_function`` (plus
  NVTX on a card) spans gated by ``REPRO_TRACE``; the shared no-op when
  off.  Wrapped around the kernel dispatch boundary, the train step and the
  engine's schedule/step/sample phases.
* :mod:`repro_torch.obs.export` — Prometheus-style text exposition + JSON
  snapshot, served from ``launch/serve.py`` and dumped at loop exit from
  ``train/loop.py``.
"""

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
from repro_torch.obs.metrics import MetricsRegistry, use_metrics
from repro_torch.obs.trace import span, trace_enabled

__all__ = [
    "EventLog",
    "MetricsRegistry",
    "prometheus_text",
    "read_events",
    "run_metadata",
    "serve_metrics",
    "snapshot_document",
    "span",
    "trace_enabled",
    "use_events",
    "use_metrics",
    "validate_event",
    "validate_events",
    "write_snapshot",
]
