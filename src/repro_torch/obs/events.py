"""Structured JSONL event sink — the single durable record of a run.

Port of ``repro.obs.events`` with the same envelope, so a log written by
either package passes the other's :func:`validate_events`.  Every record is
one JSON object per line with a fixed envelope (``SCHEMA_VERSION`` pins it;
bump on any envelope change)::

    {"schema": 1, "run": "<run id>", "seq": <int>,   # per-sink, monotonic
     "t_s": <float>,      # monotonic seconds since the sink opened
     "wall_s": <float>,   # unix wall clock (for cross-run alignment only)
     "kind": "<event kind>", "data": {...}}          # kind-specific payload

The first record of every sink is ``kind="run_meta"`` whose data is
:func:`run_metadata` — git sha and torch/device info — so an event log is
attributable to the code and hardware that produced it without any
out-of-band context.  The port picks a kernel by the tensor's device, so
there is no kernel mode to record.

``EventLog(path=None)`` keeps records in memory (``.records``) instead of
writing — the form tests use to assert on exact payloads.  File-backed
sinks do NOT retain records (a multi-day run must not grow an in-memory
copy of its own log); read them back with :func:`read_events`.

Ambient install mirrors :mod:`repro_torch.obs.metrics`: subsystems call the
module-level :func:`emit`, which is one global load + ``None`` check when
no sink is installed.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import threading
import time
import uuid

SCHEMA_VERSION = 1

#: envelope keys every record must carry (validate_event contract)
ENVELOPE_KEYS = ("schema", "run", "seq", "t_s", "wall_s", "kind", "data")


_GIT_SHA: dict[bool, str] = {}


def git_sha(short: bool = False) -> str:
    """Current commit of the repo this package lives in; "unknown" offline.

    Memoized per process — one ``git rev-parse`` subprocess, not one per
    event-log/snapshot header.
    """
    if short not in _GIT_SHA:
        try:
            cmd = (["git", "rev-parse"] + (["--short"] if short else [])
                   + ["HEAD"])
            out = subprocess.run(
                cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=5)
            sha = out.stdout.strip()
            _GIT_SHA[short] = (sha if out.returncode == 0 and sha
                               else "unknown")
        except (OSError, subprocess.SubprocessError):
            _GIT_SHA[short] = "unknown"
    return _GIT_SHA[short]


def run_metadata(extra: dict | None = None) -> dict:
    """Provenance stamp: git sha, torch and device info, timestamps.

    Shared by the event-log header, the metrics-snapshot document, and
    ``benchmarks/torch/common.py::write_bench`` — one schema for "what
    produced this".  The device fields describe the card when the process
    has one (``backend`` "cuda"), else the CPU.
    """
    import torch

    cuda = torch.cuda.is_available()
    meta = {
        "schema": SCHEMA_VERSION,
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "device_kind": torch.cuda.get_device_name() if cuda else "cpu",
        "trace": os.environ.get("REPRO_TRACE", ""),
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if extra:
        meta.update(extra)
    return meta


class EventLog:
    """Append-only JSONL sink (file-backed) or in-memory record list.

    Thread-safe: the ``seq`` counter and the write are under one lock, so
    concurrent emitters (engine submit threads vs the step loop) interleave
    whole records, never partial lines.
    """

    def __init__(self, path: str | None = None, *, run_id: str | None = None,
                 meta: dict | None = None):
        self.path = path
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self._t0 = time.monotonic()
        self._seq = 0
        self._lock = threading.Lock()
        self._closed = False
        self.records: list[dict] = []      # populated only when path is None
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")
        else:
            self._fh = None
        self.emit("run_meta", **run_metadata(meta))

    def emit(self, kind: str, **data) -> dict:
        """Append one record; returns it (with the envelope filled in)."""
        now = time.monotonic()
        with self._lock:
            if self._closed:
                raise ValueError(f"EventLog({self.path!r}) is closed")
            rec = {
                "schema": SCHEMA_VERSION,
                "run": self.run_id,
                "seq": self._seq,
                "t_s": now - self._t0,
                "wall_s": time.time(),
                "kind": str(kind),
                "data": data,
            }
            self._seq += 1
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
            else:
                self.records.append(rec)
        return rec

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None and not self._closed:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str) -> list[dict]:
    """Parse a JSONL event log back into records (strict: bad line raises)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: invalid JSON: {e}") from e
    return out


def validate_event(rec: dict) -> None:
    """Raise ``ValueError`` unless ``rec`` is a schema-valid event record."""
    if not isinstance(rec, dict):
        raise ValueError(f"event must be a dict, got {type(rec).__name__}")
    missing = [k for k in ENVELOPE_KEYS if k not in rec]
    if missing:
        raise ValueError(f"event missing envelope keys {missing}: {rec}")
    if rec["schema"] != SCHEMA_VERSION:
        raise ValueError(f"schema {rec['schema']} != {SCHEMA_VERSION}")
    if not isinstance(rec["kind"], str) or not rec["kind"]:
        raise ValueError(f"bad kind: {rec['kind']!r}")
    if not isinstance(rec["data"], dict):
        raise ValueError(f"data must be a dict: {rec['data']!r}")
    for k in ("t_s", "wall_s"):
        if not isinstance(rec[k], (int, float)):
            raise ValueError(f"{k} must be numeric: {rec[k]!r}")
    if not isinstance(rec["seq"], int) or rec["seq"] < 0:
        raise ValueError(f"seq must be a non-negative int: {rec['seq']!r}")


def validate_events(records: list[dict]) -> None:
    """Whole-log validation: per-record schema + per-run monotonic seq/t_s
    + a leading ``run_meta`` record for every run id present."""
    if not records:
        raise ValueError("empty event log")
    last: dict[str, tuple[int, float]] = {}
    first_kind: dict[str, str] = {}
    for rec in records:
        validate_event(rec)
        run = rec["run"]
        if run not in first_kind:
            first_kind[run] = rec["kind"]
        if run in last:
            pseq, pt = last[run]
            if rec["seq"] <= pseq:
                raise ValueError(
                    f"run {run}: seq not increasing ({pseq} -> {rec['seq']})")
            if rec["t_s"] < pt:
                raise ValueError(
                    f"run {run}: t_s went backwards ({pt} -> {rec['t_s']})")
        last[run] = (rec["seq"], rec["t_s"])
    for run, kind in first_kind.items():
        if kind != "run_meta":
            raise ValueError(f"run {run}: first record is {kind!r}, "
                             "expected 'run_meta'")


# ---------------------------------------------------------------------------
# Ambient sink
# ---------------------------------------------------------------------------

_SINK: EventLog | None = None


def install(log: EventLog) -> EventLog:
    global _SINK
    _SINK = log
    return log


def uninstall() -> None:
    global _SINK
    _SINK = None


def current() -> EventLog | None:
    return _SINK


@contextlib.contextmanager
def use_events(log: EventLog):
    """Scoped install; closes nothing (the caller owns the sink)."""
    global _SINK
    prev = _SINK
    _SINK = log
    try:
        yield log
    finally:
        _SINK = prev


def emit(kind: str, **data) -> dict | None:
    """Emit to the ambient sink; no-op (returns None) when none installed."""
    sink = _SINK
    if sink is None:
        return None
    return sink.emit(kind, **data)
