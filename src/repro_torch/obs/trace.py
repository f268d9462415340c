"""Profiling trace hooks: named phases for ``torch.profiler``, free when off.

Port of ``repro.obs.trace``.  ``span(name)`` wraps a region in
``torch.profiler.record_function(name)``, so a ``torch.profiler`` trace
shows the phase as a named row on the host timeline and attributes the
device kernels launched inside it to the phase; when the process has a
card it also opens an NVTX range of the same name, for tools that read
NVTX.  The kernel dispatch boundary (``kernels/ops.py``), the train step
(``train/loop.py``) and the engine's schedule/step/sample phases
(``serving/engine.py``) carry spans.

Gating: the ``REPRO_TRACE`` env var, read **once at import** — when off
(default), :func:`span` returns a shared null context manager: one function
call + one global load, no objects allocated.  Tests flip it with
:func:`set_enabled`.

Enable with ``REPRO_TRACE=1`` and capture with
``torch.profiler.profile(activities=[CPU, CUDA])``; ``key_averages()``
lists each span with its host and device time.
"""

from __future__ import annotations

import os

TRACE_ENV = "REPRO_TRACE"


def _env_enabled() -> bool:
    return os.environ.get(TRACE_ENV, "").strip().lower() not in (
        "", "0", "false", "off", "no")


_ENABLED = _env_enabled()


def trace_enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Force the gate (tests); returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


class _NullSpan:
    """Reusable do-nothing context manager (the off path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    """Live span: ``record_function`` plus an NVTX range on a card."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self):
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        import torch

        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """Context manager naming one phase; the shared no-op when tracing is
    off.  Usage: ``with span("engine.step"): ...``"""
    if not _ENABLED:
        return _NULL
    return _Span(name)


def annotate(name: str):
    """Decorator form of :func:`span` (the gate is still checked per call,
    so flipping ``set_enabled`` affects already-decorated functions)."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with span(name):
                return fn(*a, **k)

        return wrapped

    return deco
