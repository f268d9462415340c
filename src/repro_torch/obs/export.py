"""Metrics exposition: Prometheus text form + JSON snapshot documents.

Port of ``repro.obs.export``: the same text and documents, over the port's
own registry and :func:`repro_torch.obs.events.run_metadata`.

Two consumers, one source (:meth:`MetricsRegistry.snapshot`):

* :func:`prometheus_text` renders the snapshot in the Prometheus text
  exposition format (counters/gauges as single samples, histograms as
  cumulative ``_bucket{le=...}`` series + ``_sum``/``_count``) — what
  :func:`serve_metrics` serves at ``/metrics`` from ``launch/serve.py``.
* :func:`snapshot_document` / :func:`write_snapshot` wrap the snapshot with
  :func:`repro_torch.obs.events.run_metadata` into one attributable JSON document
  — what ``train/loop.py`` dumps at loop exit.
"""

from __future__ import annotations

import json
import re
import threading

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.events import SCHEMA_VERSION, run_metadata

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitise to the Prometheus metric-name charset (dots -> underscores)."""
    return _NAME_RE.sub("_", name)


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _series(key: str) -> tuple[str, str, str]:
    """Split a snapshot series key into (prom name, ``{labels}``, suffix).

    Snapshot keys follow :func:`repro_torch.obs.metrics.series_key` —
    ``name`` or ``name{k="v",...}``.  Returns the sanitised base name, the
    ready-to-append brace block (``""`` for unlabeled), and the raw label
    body (for merging extra labels such as histogram ``le``).
    """
    base, body = _metrics.split_series_key(key)
    n = _prom_name(base)
    return n, (f"{{{body}}}" if body else ""), body


def prometheus_text(snapshot: dict) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` dict as exposition text.

    Labeled series render with their label block; the ``# TYPE`` header is
    emitted once per base metric name (snapshot keys sort labeled series
    of one name adjacently, since ``"name" < "name{"`` lexically).
    """
    lines: list[str] = []
    typed: set[tuple[str, str]] = set()

    def type_line(n: str, kind: str) -> None:
        if (n, kind) not in typed:
            typed.add((n, kind))
            lines.append(f"# TYPE {n} {kind}")

    for key, st in snapshot.get("counters", {}).items():
        n, block, _ = _series(key)
        type_line(n, "counter")
        lines.append(f"{n}{block} {_fmt(st['value'])}")
    for key, st in snapshot.get("gauges", {}).items():
        n, block, _ = _series(key)
        type_line(n, "gauge")
        lines.append(f"{n}{block} {_fmt(st['value'])}")
    for key, st in snapshot.get("histograms", {}).items():
        n, block, body = _series(key)
        type_line(n, "histogram")
        pre = f"{body}," if body else ""
        cum = 0
        for bound, c in zip(st["buckets"], st["counts"]):
            cum += c
            lines.append(f'{n}_bucket{{{pre}le="{_fmt(bound)}"}} {cum}')
        cum += st["counts"][len(st["buckets"])]
        lines.append(f'{n}_bucket{{{pre}le="+Inf"}} {cum}')
        lines.append(f"{n}_sum{block} {_fmt(st['sum'])}")
        lines.append(f"{n}_count{block} {st['count']}")
    return "\n".join(lines) + "\n"


def snapshot_document(registry=None, extra_meta: dict | None = None) -> dict:
    """Snapshot + provenance: ``{"schema", "meta", "metrics"}``.

    ``registry=None`` uses the ambient registry (empty snapshot when none
    is installed — an obs-off run still writes a valid, attributable doc).
    """
    reg = registry if registry is not None else _metrics.current()
    snap = reg.snapshot() if reg is not None else {
        "counters": {}, "gauges": {}, "histograms": {}}
    return {
        "schema": SCHEMA_VERSION,
        "meta": run_metadata(extra_meta),
        "metrics": snap,
    }


def write_snapshot(path: str, registry=None,
                   extra_meta: dict | None = None) -> str:
    doc = snapshot_document(registry, extra_meta)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def serve_metrics(registry, port: int, host: str = "127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text) + ``/metrics.json`` (snapshot
    document) from a daemon thread.  Returns the ``ThreadingHTTPServer``;
    call ``.shutdown()`` to stop.  ``port=0`` binds an ephemeral port
    (``server.server_address[1]`` reports it) — the form tests use.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):                              # noqa: N802 (stdlib)
            if self.path.startswith("/metrics.json"):
                body = json.dumps(snapshot_document(registry),
                                  sort_keys=True).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                body = prometheus_text(registry.snapshot()).encode()
                ctype = "text/plain; version=0.0.4"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                     # silence per-request
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="repro-metrics-http")
    t.start()
    return server
