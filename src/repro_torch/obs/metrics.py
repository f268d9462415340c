"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``repro.obs.metrics``: the port keeps its own, so it imports
nothing of the JAX package; ``tests/test_torch_obs.py`` holds the two
equal (the same operations give byte-equal exposition text).

Design constraints (DESIGN.md §Observability):

* **Thread-safe.**  The serving engine's ``submit`` path runs on caller
  threads while ``step`` runs on the engine thread; every instrument update
  takes a per-instrument lock (uncontended in the common case) and
  ``snapshot()`` takes a consistent view under the registry lock.
* **Plain-dict snapshots.**  ``snapshot()`` returns nothing but dicts,
  lists, floats, and ints — directly JSON-serialisable, no instrument
  objects leak out.
* **Near-zero cost when no registry is installed.**  The hot paths call the
  module-level helpers (:func:`inc`, :func:`set_gauge`, :func:`observe`);
  with no ambient registry each is one global load + ``None`` check.
* **Fixed buckets.**  Histograms are Prometheus-style cumulative-bucket
  histograms with boundaries fixed at creation — an observe is a bisect +
  two adds, never an allocation, so a decode loop can observe every token.

Naming scheme: ``<subsystem>_<quantity>[_<unit>]`` with ``_total`` for
counters — ``train_step_time_s``, ``serve_ttft_s``, ``serve_shed_total``.

Labels: every accessor takes ``labels={"replica": "0"}``; each distinct
label set is its own series, stored under the canonical key
``name{k="v",...}`` (keys sorted, values stringified).  The replicated
serving tier relies on this — N in-process engines each emit ``serve_*``
under their own ``replica`` label instead of silently merging into one
instrument.  :func:`label_scope` sets ambient labels for the current
thread; the module-level helpers merge them in, so instrumented code
(e.g. the engine) needs no label plumbing when run under a router.
"""

from __future__ import annotations

import bisect
import contextlib
import threading

#: default buckets for latency-type histograms, in seconds (Prometheus-ish
#: log-spaced ladder; +Inf is implicit).
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def series_key(name: str, labels: dict | None = None) -> str:
    """Canonical registry key for a (name, labels) series.

    ``name`` for the unlabeled series, else ``name{k="v",...}`` with keys
    sorted — the same grammar the Prometheus exposition uses, so the
    exporter can split a key back into (base name, label string) at the
    first ``{``.
    """
    if not labels:
        return name
    if "{" in name:
        raise ValueError(f"metric name {name!r} must not contain '{{' "
                         "(labels go in labels=)")
    body = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                    for k, v in sorted(labels.items()))
    return f"{name}{{{body}}}"


def split_series_key(key: str) -> tuple[str, str]:
    """Inverse view of :func:`series_key`: ``(base_name, label_body)``.

    ``label_body`` is the inside of the braces (no braces), empty for the
    unlabeled series.
    """
    base, brace, rest = key.partition("{")
    return base, (rest[:-1] if brace else "")


class Counter:
    """Monotonically increasing float counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return {"value": self._value}


class Gauge:
    """Last-value gauge (set wins; no aggregation)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return {"value": self._value}


class Histogram:
    """Fixed-bucket histogram; buckets are upper bounds, +Inf implicit.

    ``counts[i]`` is the number of observations ``<= buckets[i]`` minus
    those in earlier buckets (per-bucket, not cumulative — the exporter
    cumulates for the Prometheus text form); ``counts[-1]`` is the +Inf
    overflow bucket.
    """

    kind = "histogram"

    def __init__(self, name: str, buckets=DEFAULT_TIME_BUCKETS,
                 help: str = ""):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"histogram {name}: needs >= 1 bucket bound")
        self.name = name
        self.help = help
        self.buckets = b
        self._counts = [0] * (len(b) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation; +Inf bucket reports the last bound)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self._count
            if total == 0:
                return float("nan")
            rank = q * total
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank and c:
                    return (self.buckets[i] if i < len(self.buckets)
                            else self.buckets[-1])
        return self.buckets[-1]

    def snapshot(self):
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    Re-requesting a name returns the existing instrument; requesting it as a
    different kind (or a histogram with different buckets) is an error — a
    name means one thing for the life of the process.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, kind, labels=None, **kwargs):
        key = series_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = kind(key, **kwargs)
                self._metrics[key] = m
                return m
        if not isinstance(m, kind):
            raise TypeError(
                f"metric {key!r} already registered as {m.kind}, "
                f"requested {kind.kind}")
        if kind is Histogram and "buckets" in kwargs:
            want = tuple(sorted(float(x) for x in kwargs["buckets"]))
            if want != m.buckets:
                raise ValueError(
                    f"histogram {key!r} already registered with buckets "
                    f"{m.buckets}, requested {want}")
        return m

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get(name, Counter, labels=labels, help=help)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get(name, Gauge, labels=labels, help=help)

    def histogram(self, name: str, buckets=DEFAULT_TIME_BUCKETS,
                  help: str = "", labels: dict | None = None) -> Histogram:
        return self._get(name, Histogram, labels=labels, buckets=buckets,
                         help=help)

    def peek(self, name: str, labels: dict | None = None):
        """Read a series' value without creating it (``None`` if absent).

        The router's occupancy policy reads per-replica gauges through
        this: a get-or-create accessor would mint zero-valued series for
        replicas that haven't reported yet and pollute the snapshot.
        """
        with self._lock:
            m = self._metrics.get(series_key(name, labels))
        return None if m is None else m.value

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Plain-dict view: ``{kind_plural: {name: state}}``."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for name, m in sorted(items):
            out[m.kind + "s"][name] = m.snapshot()
        return out


# ---------------------------------------------------------------------------
# Ambient registry (install once per process / per test scope)
# ---------------------------------------------------------------------------

_REGISTRY: MetricsRegistry | None = None


def install(reg: MetricsRegistry) -> MetricsRegistry:
    global _REGISTRY
    _REGISTRY = reg
    return reg


def uninstall() -> None:
    global _REGISTRY
    _REGISTRY = None


def current() -> MetricsRegistry | None:
    return _REGISTRY


@contextlib.contextmanager
def use_metrics(reg: MetricsRegistry):
    """Scoped install — the test-friendly form of :func:`install`."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = reg
    try:
        yield reg
    finally:
        _REGISTRY = prev


# ---------------------------------------------------------------------------
# Ambient labels (per thread): the router wraps each replica's engine calls
# in label_scope(replica=i) so every serve_* update the engine makes lands
# on that replica's series without the engine knowing about replicas.
# ---------------------------------------------------------------------------

_LABELS = threading.local()


def current_labels() -> dict | None:
    """The calling thread's ambient label set (``None`` when unset)."""
    return getattr(_LABELS, "labels", None)


@contextlib.contextmanager
def label_scope(**labels):
    """Attach ``labels`` to every metric update on this thread.

    Nested scopes merge (inner keys win); values are stringified at entry.
    """
    prev = getattr(_LABELS, "labels", None)
    merged = dict(prev) if prev else {}
    merged.update({k: str(v) for k, v in labels.items()})
    _LABELS.labels = merged
    try:
        yield merged
    finally:
        _LABELS.labels = prev


def _effective_labels(labels: dict | None) -> dict | None:
    ambient = getattr(_LABELS, "labels", None)
    if ambient is None:
        return labels
    if labels is None:
        return ambient
    return {**ambient, **labels}


# ---------------------------------------------------------------------------
# Hot-path helpers: one global load + None check when observability is off
# ---------------------------------------------------------------------------


def inc(name: str, n: float = 1.0, labels: dict | None = None) -> None:
    reg = _REGISTRY
    if reg is not None:
        reg.counter(name, labels=_effective_labels(labels)).inc(n)


def set_gauge(name: str, v: float, labels: dict | None = None) -> None:
    reg = _REGISTRY
    if reg is not None:
        reg.gauge(name, labels=_effective_labels(labels)).set(v)


def observe(name: str, v: float, buckets=DEFAULT_TIME_BUCKETS,
            labels: dict | None = None) -> None:
    reg = _REGISTRY
    if reg is not None:
        reg.histogram(name, buckets=buckets,
                      labels=_effective_labels(labels)).observe(v)
