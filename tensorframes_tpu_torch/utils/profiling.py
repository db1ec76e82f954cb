"""Tracing / profiling.

The reference has nothing beyond log4j levels (SURVEY.md §5: manual timing
only in ``ignore``-d perf suites); here per-verb wall-clock metrics are
first-class, plus ``torch.profiler`` device traces.

* ``span(name, rows=...)`` — context manager accumulating wall-clock,
  call count and row throughput per named operation. The five verbs
  record their execution automatically; user code can add its own.
* ``metrics()`` / ``report()`` / ``reset_metrics()`` — inspect the
  accumulated stats (``report()`` is the profiling sibling of
  ``explain``).
* ``trace(logdir)`` — context manager around ``torch.profiler``:
  captures a Chrome trace of host and device activity into ``logdir``.

When structured tracing is on (:mod:`..observability.events`), every span
and record also lands on its Chrome-trace timeline as a complete event.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Iterator

from .logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class SpanStats:
    calls: int = 0
    seconds: float = 0.0
    rows: int = 0

    @property
    def rows_per_sec(self) -> float:
        return self.rows / self.seconds if self.seconds > 0 else 0.0


_lock = threading.Lock()
_stats: Dict[str, SpanStats] = {}
_events_mod = None


def _trace_events():
    """The structured event tracer, imported on first use (the
    observability package imports nothing of this module's callers)."""
    global _events_mod
    if _events_mod is None:
        from ..observability import events

        _events_mod = events
    return _events_mod


@contextlib.contextmanager
def span(name: str, rows: int = 0) -> Iterator[None]:
    """Accumulate wall-clock (and optional row count) under ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _accumulate(name, dt, rows)
        ev = _trace_events()
        if ev.TRACER.enabled:
            ev.TRACER.emit_complete(name, t0, dt, args={"rows": rows} if rows else None,
                                    cat="profiling")


def _accumulate(name: str, seconds: float, rows: int) -> None:
    with _lock:
        s = _stats.setdefault(name, SpanStats())
        s.calls += 1
        s.seconds += seconds
        s.rows += rows
    _latency_mod().observe_verb(name, seconds)


_latency = None


def _latency_mod():
    """The verb-latency histograms (observability/latency.py), imported
    on first use like the tracer."""
    global _latency
    if _latency is None:
        from ..observability import latency

        _latency = latency
    return _latency


def record(name: str, seconds: float, rows: int = 0) -> None:
    """Directly accumulate one measurement (for code that times itself)."""
    _accumulate(name, seconds, rows)
    ev = _trace_events()
    if ev.TRACER.enabled:
        # callers record right after timing, so "it just ended" places
        # the event's start closely enough for a timeline
        ev.TRACER.emit_complete(name, time.perf_counter() - seconds, seconds,
                                args={"rows": rows} if rows else None, cat="profiling")


def metrics() -> Dict[str, SpanStats]:
    """Snapshot of accumulated span stats."""
    with _lock:
        return {k: dataclasses.replace(v) for k, v in _stats.items()}


def reset_metrics() -> None:
    with _lock:
        _stats.clear()


def report() -> str:
    """Human-readable per-span table (the profiling ``explain``)."""
    snap = metrics()
    if not snap:
        return "no spans recorded"
    name_w = max(len(k) for k in snap) + 2
    lines = [f"{'span':<{name_w}}{'calls':>7}{'seconds':>12}{'rows':>12}{'rows/s':>14}"]
    for name in sorted(snap):
        s = snap[name]
        rps = f"{s.rows_per_sec:,.0f}" if s.rows else "-"
        rows = f"{s.rows:,}" if s.rows else "-"
        lines.append(f"{name:<{name_w}}{s.calls:>7}{s.seconds:>12.4f}{rows:>12}{rps:>14}")
    return "\n".join(lines)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a region in the device trace (a ``torch.profiler``
    ``record_function`` range, shown in a :func:`trace`) and accumulate
    its wall-clock span, as :func:`span` does. Exceptions from the body
    propagate untouched."""
    import torch

    with torch.profiler.record_function(name), span(name):
        yield


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (CPU, plus CUDA when a GPU is
    present) and write it as ``<logdir>/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
