"""Fleet rendezvous: heartbeats, replica liveness and the coordinated-abort
signal, over files in a shared directory.

The reference package's ``resilience/fleet.py`` in its file-based half —
what the serving fleet (:mod:`tensorframes_tpu_torch.serving.fleet`) runs
on:

* **Heartbeats** — every process in a fleet publishes a small JSON beat
  (stamped with the observability ``run_id``/``process_index`` context)
  into a shared **rendezvous dir** (``TFTPU_FLEET_DIR``) every
  ``heartbeat_interval_s``. A clean exit leaves a final ``stopped`` beat,
  so a finished process is never mistaken for a dead one.
* **Status** — :func:`fleet_status` classifies every rank from its newest
  beat: *stopped*, *dead* past ``heartbeat_timeout_s``, *straggler* past
  half of it, else *alive*.
* **Coordinated abort** — :func:`signal_abort` publishes one abort record
  (first writer wins), :func:`abort_requested` reads it, and
  :func:`clear_fleet` removes a run's state between incarnations.

File names and JSON fields are the reference's, byte for byte, so either
package reads the other's rendezvous dir. The drop-heartbeat chaos site
``fleet.heartbeat`` sits in :class:`Heartbeater`'s loop. The SPMD half
(``FleetMonitor``, ``enroll``, ``run_with_deadline``, ``barrier``) comes
with the multi-device work.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..config import get_config
from ..observability import context as _context
from ..observability import flight as _flight
from ..observability.metrics import counter as _counter
from ..observability.metrics import gauge as _gauge
from ..observability.metrics import histogram as _histogram
from ..utils import get_logger
from . import faults as _faults

logger = get_logger(__name__)

__all__ = [
    "FleetStatus",
    "Heartbeater",
    "rendezvous_dir",
    "write_beat",
    "read_heartbeats",
    "write_json_atomic",
    "read_latest_records",
    "fleet_status",
    "signal_abort",
    "abort_requested",
    "clear_fleet",
]

# Fleet telemetry under the reference's names, registered at import so
# an exposition always carries the family: a run that never lost a rank
# reads 0, it does not vanish.
_HEARTBEATS = _counter(
    "tftpu_fleet_heartbeats_total",
    "Heartbeats this process published into the rendezvous dir",
)
_HEARTBEATS_SKIPPED = _counter(
    "tftpu_fleet_heartbeats_skipped_total",
    "Heartbeats dropped (fleet.heartbeat fault injection or beat-write "
    "IO failure)",
)
MISSED_BEATS = _counter(
    "tftpu_fleet_missed_beats_total",
    "Monitor scans that found a peer's newest beat stale (straggler or "
    "dead threshold)",
)
_STRAGGLERS = _counter(
    "tftpu_fleet_stragglers_total",
    "Peer ranks newly flagged as stragglers (beat older than the "
    "straggler threshold, younger than the dead timeout)",
)
DEAD_RANKS = _counter(
    "tftpu_fleet_dead_ranks_total",
    "Peer ranks declared dead (heartbeat older than the timeout, or "
    "process reaped by the supervisor)",
)
_ABORTS = _counter(
    "tftpu_fleet_aborts_total",
    "Coordinated aborts signalled into the rendezvous dir",
)
_HUNG_DISPATCHES = _counter(
    "tftpu_fleet_hung_dispatches_total",
    "Dispatches/barriers that exceeded the dispatch deadline and were "
    "aborted by the watchdog",
)
_DEADLINE_EXEMPTIONS = _counter(
    "tftpu_fleet_deadline_exemptions_total",
    "First dispatches that ran unbounded because their XLA compile "
    "happens lazily inside the call (the executor's counted lazy-jit "
    "fallback — the ONLY exempt class since the unified AOT dispatch; "
    "a nonzero rate in steady state means programs are living on the "
    "fallback path)",
)
RESTARTS = _counter(
    "tftpu_fleet_restarts_total",
    "Full-fleet restarts performed by supervise() after a rank failure",
)
RECOVERY_SECONDS = _histogram(
    "tftpu_fleet_recovery_seconds",
    "Failure-detection → fleet-respawned wall-clock per supervise() "
    "restart",
)
ALIVE_RANKS = _gauge(
    "tftpu_fleet_alive_ranks",
    "Ranks of the supervised fleet currently running (supervisor's view)",
)

_faults.register_site(
    "fleet.heartbeat",
    "Heartbeater beat loop — an injected error drops the beat "
    "(drop-heartbeat chaos: peers must detect the silence)",
)


# ---------------------------------------------------------------------------
# rendezvous dir + heartbeat files
# ---------------------------------------------------------------------------

def rendezvous_dir() -> Optional[str]:
    """The fleet rendezvous directory (``TFTPU_FLEET_DIR``), or None
    when this process is not part of a fleet."""
    return os.environ.get("TFTPU_FLEET_DIR") or None


def _hb_path(directory: str, run_id: str, rank: int) -> str:
    return os.path.join(directory, f"hb_{run_id}_p{rank}.json")


def write_json_atomic(path: str, rec: dict) -> str:
    """Publish one JSON record atomically (tmp-write + rename): a reader
    never sees a torn record. Shared by heartbeats and the serving
    fleet's replica cards."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)
    return path


def read_latest_records(
    directory: str,
    pattern: str,
    run_id: Optional[str] = None,
    *,
    rank_field: str = "process_index",
) -> Dict[int, dict]:
    """The newest record per rank (``{rank: record}``) matching
    ``pattern``, filtered to ``run_id`` when given. Tolerates unreadable
    and foreign files: a monitor must never crash on a half-provisioned
    dir. The one tolerant read behind heartbeats and replica cards."""
    out: Dict[int, dict] = {}
    for path in _glob.glob(os.path.join(directory, pattern)):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        try:
            rank = int(rec[rank_field])
        except (KeyError, TypeError, ValueError):
            continue
        if run_id is not None and rec.get("run_id") != run_id:
            continue
        prev = out.get(rank)
        if prev is None or rec.get("ts", 0) >= prev.get("ts", 0):
            out[rank] = rec
    return out


def write_beat(
    directory: str,
    *,
    seq: int = 0,
    interval_s: Optional[float] = None,
    stopped: bool = False,
    rank: Optional[int] = None,
) -> str:
    """Atomically publish one heartbeat record. ``stopped=True`` is the
    clean-exit marker: a finished rank must read as departed, not dead."""
    ctx = _context.snapshot()
    rank = ctx["process_index"] if rank is None else int(rank)
    rec = {
        "run_id": ctx["run_id"],
        "process_index": rank,
        "pid": os.getpid(),
        "seq": int(seq),
        "ts": time.time(),
        "interval_s": float(
            get_config().heartbeat_interval_s if interval_s is None
            else interval_s
        ),
        "stopped": bool(stopped),
    }
    os.makedirs(directory, exist_ok=True)
    return write_json_atomic(_hb_path(directory, rec["run_id"], rank), rec)


def read_heartbeats(
    directory: str, run_id: Optional[str] = None
) -> Dict[int, dict]:
    """The newest published beat per rank (``{rank: record}``), filtered
    to ``run_id`` when given (see :func:`read_latest_records`)."""
    pattern = f"hb_{run_id}_p*.json" if run_id else "hb_*_p*.json"
    return read_latest_records(directory, pattern, run_id)


@dataclass
class FleetStatus:
    """One scan's verdict over the fleet's heartbeats."""

    alive: List[int] = field(default_factory=list)
    stopped: List[int] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)
    dead: List[int] = field(default_factory=list)
    #: expected (per ``num_processes``) but never published a beat
    missing: List[int] = field(default_factory=list)
    #: newest-beat age per seen rank, seconds
    ages: Dict[int, float] = field(default_factory=dict)

    def unresponsive(self) -> List[int]:
        """Ranks a hung dispatch should name: dead + missing + stragglers."""
        return sorted(set(self.dead) | set(self.missing) | set(self.stragglers))


def fleet_status(
    directory: str,
    *,
    run_id: Optional[str] = None,
    num_processes: Optional[int] = None,
    timeout_s: Optional[float] = None,
    straggler_s: Optional[float] = None,
    now: Optional[float] = None,
) -> FleetStatus:
    """Classify every rank from its newest beat: ``stopped`` (clean final
    beat), ``dead`` (age > ``timeout_s``), ``straggler`` (age >
    ``straggler_s``, default half the timeout), else ``alive``; ranks
    below ``num_processes`` that never published are ``missing``."""
    cfg = get_config()
    timeout_s = cfg.heartbeat_timeout_s if timeout_s is None else timeout_s
    straggler_s = timeout_s / 2.0 if straggler_s is None else straggler_s
    now = time.time() if now is None else now
    beats = read_heartbeats(directory, run_id)
    st = FleetStatus()
    for rank in sorted(beats):
        rec = beats[rank]
        age = max(0.0, now - float(rec.get("ts", 0)))
        st.ages[rank] = age
        if rec.get("stopped"):
            st.stopped.append(rank)
        elif age > timeout_s:
            st.dead.append(rank)
        elif age > straggler_s:
            st.stragglers.append(rank)
        else:
            st.alive.append(rank)
    if num_processes:
        st.missing = sorted(set(range(int(num_processes))) - set(beats))
    return st


# ---------------------------------------------------------------------------
# coordinated abort
# ---------------------------------------------------------------------------

def _abort_path(directory: str, run_id: str) -> str:
    return os.path.join(directory, f"abort_{run_id}.json")


def signal_abort(
    directory: str,
    reason: str,
    *,
    dead_ranks: Sequence[int] = (),
    run_id: Optional[str] = None,
) -> str:
    """Publish the coordinated-abort signal into the rendezvous dir
    (first writer wins: the original cause must not be overwritten by the
    cascade it triggers)."""
    run_id = run_id or _context.run_id()
    os.makedirs(directory, exist_ok=True)
    path = _abort_path(directory, run_id)
    rec = {
        "run_id": run_id,
        "reason": str(reason)[:500],
        "ranks": sorted(int(r) for r in dead_ranks),
        "by": _context.process_index(),
        "pid": os.getpid(),
        "ts": time.time(),
    }
    try:
        with open(path, "x") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        _ABORTS.inc()
        _flight.record("fleet.abort", reason=rec["reason"], ranks=rec["ranks"])
        logger.error("fleet: coordinated abort signalled: %s", reason)
    except FileExistsError:
        pass  # a peer already signalled; theirs is the cause of record
    except OSError as e:  # pragma: no cover - dying filesystem
        logger.warning("fleet: abort signal write failed: %s", e)
    return path


def abort_requested(
    directory: str, run_id: Optional[str] = None
) -> Optional[dict]:
    """The coordinated-abort record, if one has been signalled."""
    run_id = run_id or _context.run_id()
    try:
        with open(_abort_path(directory, run_id)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def clear_fleet(directory: str, run_id: Optional[str] = None) -> int:
    """Remove heartbeat, abort and barrier state for ``run_id`` (every
    run when None), so a stale abort signal cannot kill a fleet's next
    incarnation at birth. Returns the number of files removed."""
    run_id = run_id or "*"
    removed = 0
    for pattern in (
        f"hb_{run_id}_p*.json",
        f"abort_{run_id}.json",
        f"barrier_{run_id}_*",
    ):
        for path in _glob.glob(os.path.join(directory, pattern)):
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
    return removed


# ---------------------------------------------------------------------------
# heartbeat publisher
# ---------------------------------------------------------------------------

class Heartbeater:
    """Daemon thread publishing this process's beat every
    ``interval_s``. The ``fleet.heartbeat`` fault site sits in the loop:
    an injected error drops beats without harming the host process."""

    def __init__(
        self, directory: str, interval_s: Optional[float] = None,
        rank: Optional[int] = None,
    ):
        self.directory = directory
        self.interval_s = float(
            get_config().heartbeat_interval_s if interval_s is None
            else interval_s
        )
        self.rank = _context.process_index() if rank is None else int(rank)
        self.seq = 0
        self.skipped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeater":
        if self._thread is not None:
            return self
        # the first beat synchronously: a supervisor must see this rank
        # the instant start() returns, not an interval later
        self.beat_once()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"tfs-heartbeat-p{self.rank}",
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat_once()

    def beat_once(self) -> bool:
        """Publish one beat; False when it was dropped (an injected fault
        or an IO failure: either way the silence is what peers see)."""
        try:
            _faults.fault_point("fleet.heartbeat")
            self.seq += 1
            write_beat(
                self.directory, seq=self.seq, interval_s=self.interval_s,
                rank=self.rank,
            )
        except Exception as e:
            self.skipped += 1
            _HEARTBEATS_SKIPPED.inc()
            logger.debug("heartbeat dropped: %s", e)
            return False
        _HEARTBEATS.inc()
        return True

    def stop(self, graceful: bool = True) -> None:
        """Stop beating; ``graceful`` publishes the final ``stopped``
        beat, so peers read this rank as departed, not dead."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s * 4 + 1.0)
            self._thread = None
        if graceful:
            try:
                self.seq += 1
                write_beat(
                    self.directory, seq=self.seq, interval_s=self.interval_s,
                    rank=self.rank, stopped=True,
                )
            except OSError as e:  # pragma: no cover - dying filesystem
                logger.debug("final heartbeat failed: %s", e)
