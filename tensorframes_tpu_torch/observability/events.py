"""Structured event tracing → Chrome ``trace_event`` JSON.

The aggregate side of observability lives in ``utils/profiling.py``
(per-span totals) and ``observability/metrics.py`` (counters/gauges/
histograms). This module is the **timeline** side: begin/end spans with
natural nesting, instant events, monotonic microsecond timestamps, and
real thread ids, exported in the Chrome ``trace_event`` JSON format that
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` open
directly. It layers on top of ``utils/profiling.py``: when tracing is
enabled, every ``profiling.span``/``record`` (the five verbs, the
relational ops, the plan's segments) also lands on the timeline, as do
the executor's dispatches; disabled, it costs one attribute check.

Usage::

    from tensorframes_tpu_torch.observability import events

    events.enable()
    with events.span("ingest", rows=100_000):
        ...
    events.instant("watermark", step=7)
    events.save("trace.json")           # open in Perfetto

The buffer is bounded (``max_events``): past the cap new events are
dropped and counted (``TRACER.dropped`` and
``tftpu_trace_events_dropped_total``). Spans are recorded as complete
("X"-phase) events at span END, so nesting is reconstructed by time
containment per thread; a span that never exits leaves no partial event.

The ``otherData`` stamp carries the run id and the process index of
:mod:`.context`, so per-process shards of one run can be merged.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from ..utils import get_logger
from .context import process_index, run_id
from .metrics import counter as _counter

logger = get_logger(__name__)

__all__ = [
    "Tracer",
    "TRACER",
    "enable",
    "disable",
    "active",
    "clear",
    "span",
    "instant",
    "to_chrome_trace",
    "save",
    "save_shard",
    "run_id",
    "process_index",
]

#: Monotonic epoch for this process: every timestamp is microseconds
#: since this instant.
_EPOCH = time.perf_counter()
#: Wall-clock captured at the same instant as ``_EPOCH``: the anchor that
#: places each process's monotonic timeline on one real-time axis.
_EPOCH_UNIX_US = int(time.time() * 1e6)

# registered at import so the family is in every exposition: a silently
# truncated trace would read as "nothing else happened"
_EVENTS_DROPPED = _counter(
    "tftpu_trace_events_dropped_total",
    "Trace events discarded because the tracer ring was full",
)

def _us(t_perf: float) -> float:
    return (t_perf - _EPOCH) * 1e6


def _clean_args(args: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce event args to strict-JSON-safe values at emit time: numpy
    and torch scalars via .item(), non-finite floats to null, anything
    else to str — the end-of-run export must never raise."""
    out: Dict[str, Any] = {}
    for k, v in args.items():
        if not isinstance(v, (str, int, float, bool)) and v is not None:
            item = getattr(v, "item", None)
            if callable(item):
                try:
                    v = item()
                except Exception:
                    v = str(v)
            if not isinstance(v, (str, int, float, bool)) and v is not None:
                v = str(v)
        if isinstance(v, float) and not math.isfinite(v):
            v = None
        out[k] = v
    return out


class Tracer:
    """Bounded in-memory trace_event collector (thread-safe)."""

    def __init__(self, max_events: int = 200_000):
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._named_threads: set = set()
        self.dropped = 0
        self.enabled = False

    # -- lifecycle ----------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._named_threads.clear()
            self.dropped = 0

    # -- recording ----------------------------------------------------------

    def _append(self, ev: Dict[str, Any], tid: int) -> None:
        with self._lock:
            # the cap is hard: a full buffer drops the event (counted),
            # and thread_name metadata is only added when there is room
            # for it AND the event it annotates
            if len(self._events) >= self.max_events:
                self.dropped += 1
                _EVENTS_DROPPED.inc()
                return
            if (
                tid not in self._named_threads
                and len(self._events) + 2 <= self.max_events
            ):
                self._named_threads.add(tid)
                self._events.append({
                    "ph": "M",
                    "name": "thread_name",
                    "pid": ev["pid"],
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            self._events.append(ev)

    def emit_complete(
        self,
        name: str,
        t0_perf: float,
        dur_s: float,
        args: Optional[Dict[str, Any]] = None,
        cat: str = "tftpu",
    ) -> None:
        """Record a complete ("X") event from a perf_counter start and a
        duration — the hook ``profiling`` and the instrumented hot paths
        use, since they already hold both numbers."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        ev: Dict[str, Any] = {
            "ph": "X",
            "name": name,
            "cat": cat,
            "ts": _us(t0_perf),
            "dur": dur_s * 1e6,
            "pid": os.getpid(),
            "tid": tid,
        }
        if args:
            ev["args"] = _clean_args(args)
        self._append(ev, tid)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "tftpu", **args: Any) -> Iterator[None]:
        """Trace the body as one complete event (no-op when disabled)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit_complete(
                name, t0, time.perf_counter() - t0,
                args=args or None, cat=cat,
            )

    def instant(self, name: str, cat: str = "tftpu", **args: Any) -> None:
        """A zero-duration marker ("i" phase, thread scope)."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        ev: Dict[str, Any] = {
            "ph": "i",
            "s": "t",
            "name": name,
            "cat": cat,
            "ts": _us(time.perf_counter()),
            "pid": os.getpid(),
            "tid": tid,
        }
        if args:
            ev["args"] = _clean_args(args)
        self._append(ev, tid)

    # -- export -------------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The JSON-object trace format: ``{"traceEvents": [...]}`` plus
        metadata, accepted by Perfetto and chrome://tracing."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "tensorframes_tpu_torch.observability.events",
                "dropped_events": dropped,
                "run_id": run_id(),
                "process_index": process_index(),
                "pid": os.getpid(),
                "trace_epoch_unix_us": _EPOCH_UNIX_US,
            },
        }

    def save(self, path: str) -> str:
        """Write the trace JSON to ``path`` and return it."""
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f, default=str)
        logger.info(
            "trace: wrote %d events to %s (open in https://ui.perfetto.dev)",
            len(trace["traceEvents"]), path,
        )
        return path

    def save_shard(self, directory: str) -> str:
        """Write this process's trace as a per-process shard,
        ``<dir>/trace_<run_id>_p<process_index>.json``: every process of
        a run writes into one shared directory without collisions."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"trace_{run_id()}_p{process_index()}.json"
        )
        return self.save(path)


#: Process-wide default tracer; the module-level helpers and every
#: instrumented layer use this instance.
TRACER = Tracer()


def _abandon_buffer_after_fork() -> None:
    # a forked worker: the parent's pre-fork events belong in the
    # parent's shard. The enabled state is inherited, and the epoch pair
    # stays valid across fork. No lock: the child is single-threaded now.
    TRACER._events = []
    TRACER._named_threads = set()
    TRACER.dropped = 0


if hasattr(os, "register_at_fork"):  # pragma: no branch - posix
    os.register_at_fork(after_in_child=_abandon_buffer_after_fork)


def enable() -> None:
    """Start collecting events on the default tracer."""
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def active() -> bool:
    """True when the default tracer is collecting."""
    return TRACER.enabled


def clear() -> None:
    TRACER.clear()


def span(name: str, cat: str = "tftpu", **args: Any):
    """Context manager tracing the body on the default tracer."""
    return TRACER.span(name, cat=cat, **args)


def instant(name: str, cat: str = "tftpu", **args: Any) -> None:
    TRACER.instant(name, cat=cat, **args)


def to_chrome_trace() -> Dict[str, Any]:
    return TRACER.to_chrome_trace()


def save(path: str) -> str:
    return TRACER.save(path)


def save_shard(directory: str) -> str:
    """Write the default tracer's per-process shard into ``directory``."""
    return TRACER.save_shard(directory)
