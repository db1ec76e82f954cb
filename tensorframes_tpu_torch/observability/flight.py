"""Crash flight recorder: an always-on black box of recent operations.

When a run dies — a guard-raise on a NaN step, an unhandled exception,
or a ``kill -9`` that leaves no Python at all — the postmortem question
is always the same: *what was the system doing right before?* This
module keeps a bounded, always-on ring of the recent **operational**
events and turns it into a redacted JSONL dump at the moment of death,
so ``read_blackbox()`` shows the history after a crash. The record kinds
are the reference package's: ``dispatch`` / ``dispatch.error`` (the
executor), ``retry`` / ``retry.exhausted``, ``guard.trip``,
``fault.injected`` / ``fault.delayed`` / ``fault.kill_rank``,
``checkpoint.save`` / ``checkpoint.restore``, ``crash``.

Two storage layers:

* **In-memory ring** (``deque(maxlen=capacity)``) — always recording;
  the cost per record is a small dict build and an append. Dumped to
  JSONL by :meth:`FlightRecorder.dump` (the installed hooks call it on a
  crash).
* **Disk spool** (armed by ``TFTPU_FLIGHT_DIR``) — every record is also
  appended, line-flushed, to a two-segment rotating file pair, so a
  ``kill -9`` (no Python runs, no hook fires) still leaves the last
  ``<= 2 * capacity`` records on disk. :func:`read_blackbox` reassembles
  them afterwards.

Dump triggers (all best-effort — the recorder must never turn a crash
into a different crash): unhandled exceptions through a chained
``sys.excepthook`` (installed at import when the spool dir is armed),
and ``StepGuard`` escalation to ``NonFiniteError``.

Records are **redacted** before they are written anywhere: values are
scalars and short strings only, array-likes degrade to shape and dtype,
and fields whose names smell like credentials are blanked — a
postmortem must never carry tensor contents or secrets.
"""

from __future__ import annotations

import collections
import glob
import json
import math
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from ..utils import get_logger
from . import context as _context
from .metrics import counter as _counter

logger = get_logger(__name__)

__all__ = [
    "FlightRecorder",
    "RECORDER",
    "record",
    "dump",
    "install_excepthook",
    "read_blackbox",
    "set_spool_dir",
]

#: Ring capacity (records); the spool keeps at most twice this on disk.
DEFAULT_CAPACITY = 512

_MAX_STR = 240  # chars kept of any string field
_SECRET_HINTS = ("secret", "token", "password", "passwd", "api_key",
                 "apikey", "credential", "auth")

_RECORDS = _counter(
    "tftpu_flight_records_total",
    "Operational events captured by the flight recorder ring",
)
_DUMPS = _counter(
    "tftpu_flight_dumps_total",
    "Flight-recorder postmortem dumps written",
)


def _redact_value(v: Any) -> Any:
    """One field value → a JSON-safe, content-free form."""
    if v is None or isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        if isinstance(v, float) and not math.isfinite(v):
            return str(v)  # "nan"/"inf": strict JSON has no token
        return v
    if isinstance(v, str):
        return v if len(v) <= _MAX_STR else v[:_MAX_STR] + "…"
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is not None and dtype is not None:
        # arrays never dump contents: a black box rides CI artifacts
        return f"<array shape={tuple(shape)} dtype={dtype}>"
    if isinstance(v, (list, tuple)):
        if len(v) > 8:
            return f"<{type(v).__name__} len={len(v)}>"
        return [_redact_value(x) for x in v]
    if isinstance(v, dict):
        return redact_fields(v) if len(v) <= 8 else f"<dict len={len(v)}>"
    return _redact_value(str(v))


def redact_fields(fields: Dict[str, Any]) -> Dict[str, Any]:
    """Redact a record's fields: credential-smelling names are blanked,
    everything else passes through :func:`_redact_value`."""
    out: Dict[str, Any] = {}
    for k, v in fields.items():
        lk = str(k).lower()
        if any(h in lk for h in _SECRET_HINTS):
            out[k] = "[redacted]"
        else:
            out[k] = _redact_value(v)
    return out


def _exc_fields(exc: BaseException, tb_chars: int = 2000) -> Dict[str, Any]:
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    return {
        "error": type(exc).__name__,
        "message": str(exc)[:_MAX_STR],
        "traceback": tb[-tb_chars:],
    }


class FlightRecorder:
    """Bounded operational-event ring with an optional crash-safe spool."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, spool_dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.total_records = 0
        self._spool_dir = spool_dir
        self._spool_file = None
        self._spool_lines = 0
        self._spool_path: Optional[str] = None
        self._dump_count = 0

    # -- spool --------------------------------------------------------------

    @property
    def spool_dir(self) -> Optional[str]:
        return self._spool_dir

    def set_spool_dir(self, directory: Optional[str]) -> None:
        """(Re)arm or disarm the disk spool."""
        with self._lock:
            self._close_spool_locked()
            self._spool_dir = directory

    def _close_spool_locked(self) -> None:
        if self._spool_file is not None:
            try:
                self._spool_file.close()
            except OSError:  # pragma: no cover - close on a dead fs
                pass
            self._spool_file = None
            self._spool_lines = 0
            self._spool_path = None

    def _spool_locked(self):
        if not self._spool_dir:
            return None
        if self._spool_file is None or self._spool_file.closed:
            os.makedirs(self._spool_dir, exist_ok=True)
            ctx = _context.snapshot()
            self._spool_path = os.path.join(
                self._spool_dir,
                f"flight_{ctx['run_id']}_p{ctx['process_index']}_pid{os.getpid()}.jsonl",
            )
            self._spool_file = open(self._spool_path, "a")
            self._spool_lines = 0
        elif self._spool_lines >= self.capacity:
            # two-segment rotation: the previous segment replaces ".1",
            # bounding disk to <= 2*capacity lines however long the run
            self._spool_file.close()
            os.replace(self._spool_path, self._spool_path + ".1")
            self._spool_file = open(self._spool_path, "a")
            self._spool_lines = 0
        return self._spool_file

    # -- recording ----------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> None:
        """Append one operational record (thread-safe, never raises)."""
        try:
            rec = {"kind": kind, "ts": round(time.time(), 6), **redact_fields(fields)}
            with self._lock:
                self._seq += 1
                rec["seq"] = self._seq
                self._ring.append(rec)
                self.total_records += 1
                f = self._spool_locked()
                if f is not None:
                    f.write(json.dumps(rec, default=str) + "\n")
                    f.flush()
                    self._spool_lines += 1
            _RECORDS.inc()
        except Exception as e:  # pragma: no cover - must never propagate
            logger.debug("flight record failed: %s", e)

    def records(self) -> List[Dict[str, Any]]:
        """Ring contents, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- postmortem ---------------------------------------------------------

    def dump(self, path: Optional[str] = None, reason: str = "manual",
             exc: Optional[BaseException] = None) -> Optional[str]:
        """Write the postmortem JSONL: one header line (context, reason,
        redacted exception) then the ring oldest-first. ``path=None``
        writes ``postmortem_<run>_p<rank>_pid<pid>_<n>.jsonl`` (n = the
        per-process dump counter) into the spool dir — or returns None
        when no spool dir is armed. Best-effort: returns None on an IO
        failure instead of raising inside a dying process."""
        try:
            if path is None:
                if not self._spool_dir:
                    return None
                os.makedirs(self._spool_dir, exist_ok=True)
                ctx = _context.snapshot()
                # a per-process counter in the name: a guard-raise
                # postmortem must survive a later crash dump
                with self._lock:
                    self._dump_count += 1
                    n = self._dump_count
                path = os.path.join(
                    self._spool_dir,
                    f"postmortem_{ctx['run_id']}_p{ctx['process_index']}"
                    f"_pid{os.getpid()}_{n}.jsonl",
                )
            header: Dict[str, Any] = {
                "kind": "postmortem",
                "reason": reason,
                "ts": round(time.time(), 6),
                "pid": os.getpid(),
                **_context.snapshot(),
                "records": len(self._ring),
                "total_records": self.total_records,
            }
            if exc is not None:
                header.update(redact_fields(_exc_fields(exc)))
            with open(path, "w") as f:
                f.write(json.dumps(header, default=str) + "\n")
                for rec in self.records():
                    f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
            _DUMPS.inc()
            logger.warning("flight recorder: postmortem (%s) → %s", reason, path)
            return path
        except Exception as e:  # pragma: no cover - dying process
            logger.debug("flight dump failed: %s", e)
            return None

    def _abandon_spool_after_fork(self) -> None:
        # forked child: the inherited handle points at the parent's spool
        # (parent rank/pid in the name) — drop it without closing (the fd
        # is shared; per-record flush means no buffered bytes are lost)
        # so the child's first record reopens under its own identity
        self._spool_file = None
        self._spool_lines = 0
        self._spool_path = None


#: Process-wide recorder; spool armed by TFTPU_FLIGHT_DIR at import.
RECORDER = FlightRecorder(
    capacity=int(os.environ.get("TFTPU_FLIGHT_EVENTS", DEFAULT_CAPACITY)),
    spool_dir=os.environ.get("TFTPU_FLIGHT_DIR") or None,
)

if hasattr(os, "register_at_fork"):  # pragma: no branch - posix
    os.register_at_fork(after_in_child=lambda: RECORDER._abandon_spool_after_fork())


def record(kind: str, **fields: Any) -> None:
    """Record on the process-wide flight recorder."""
    RECORDER.record(kind, **fields)


def dump(path: Optional[str] = None, reason: str = "manual",
         exc: Optional[BaseException] = None) -> Optional[str]:
    """Dump the process-wide recorder's postmortem (see
    :meth:`FlightRecorder.dump`)."""
    return RECORDER.dump(path, reason=reason, exc=exc)


def set_spool_dir(directory: Optional[str]) -> None:
    """(Re)arm the process-wide recorder's disk spool. Arming also
    installs the crash excepthook."""
    RECORDER.set_spool_dir(directory)
    if directory:
        install_excepthook()


# -- crash hook -------------------------------------------------------------

_hook_installed = False


def install_excepthook() -> None:
    """Chain a postmortem dump into ``sys.excepthook`` (idempotent). The
    previous hook still runs — this observes death, it does not change
    how death looks."""
    global _hook_installed
    if _hook_installed:
        return
    prev = sys.excepthook

    def _flight_excepthook(tp, val, tb):
        try:
            RECORDER.record("crash", error=tp.__name__, message=str(val)[:_MAX_STR])
            RECORDER.dump(reason="crash", exc=val)
        finally:
            prev(tp, val, tb)

    sys.excepthook = _flight_excepthook
    _hook_installed = True


if os.environ.get("TFTPU_FLIGHT_DIR"):
    install_excepthook()


# -- black-box recovery -----------------------------------------------------

def read_blackbox(directory: str) -> List[Dict[str, Any]]:
    """Reassemble spooled flight records after an unclean death (e.g.
    ``kill -9``): reads every ``flight_*.jsonl`` segment pair under
    ``directory``, tolerating a torn final line (the kill can land
    mid-write), and returns records sorted by (file identity, seq)."""
    out: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(directory, "flight_*.jsonl*"))):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail line from the kill
                    rec["_file"] = os.path.basename(path)
                    out.append(rec)
        except OSError:
            continue
    out.sort(key=lambda r: (r.get("_file", "").split(".jsonl")[0], r.get("seq", 0)))
    return out
