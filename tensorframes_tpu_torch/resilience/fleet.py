"""Fleet supervision: heartbeats, dead-rank detection, the hung-dispatch
watchdog and the coordinated abort, over files in a shared directory.

The reference package's ``resilience/fleet.py``:

* **Heartbeats** — every process in a fleet publishes a small JSON beat
  (stamped with the observability ``run_id``/``process_index`` context)
  into a shared **rendezvous dir** (``TFTPU_FLEET_DIR``;
  :func:`~.supervisor.supervise` arms it for its children) every
  ``heartbeat_interval_s``. A clean exit leaves a final ``stopped`` beat,
  so a finished process is never mistaken for a dead one.
* **Monitoring** — :func:`fleet_status` classifies every rank from its
  newest beat: *stopped*, *dead* past ``heartbeat_timeout_s``,
  *straggler* past half of it, else *alive*. :class:`FleetMonitor` (a
  daemon thread) scans it and fires callbacks once per new verdict;
  :func:`enroll` wires the default policy: a dead peer, or a peer's abort
  signal, dumps a flight-recorder postmortem naming the missing rank,
  signals the **coordinated abort** and exits with
  :data:`ABORT_EXIT_CODE`.
* **Coordinated abort** — :func:`signal_abort` publishes one abort record
  (first writer wins), :func:`abort_requested` reads it, and
  :func:`clear_fleet` removes a run's state between incarnations.
* **Hung-dispatch watchdog** — :func:`run_with_deadline` bounds a call by
  ``config.dispatch_deadline_s``; on expiry it dumps a
  ``fleet.hung_dispatch`` postmortem naming the stalled call and the
  unresponsive ranks, signals the abort and raises
  :class:`HungDispatchError`. The executor's dispatches and every
  collective of :mod:`..parallel.collectives` run under it.
* **Lost peers** — gloo raises in a collective whose peer died, where
  XLA's collectives hang; :func:`abort_on_lost_peer` turns that error into
  the coordinated abort of an enrolled rank, so a survivor never writes a
  checkpoint newer than its dead peer's.
* **Rendezvous barrier** — :func:`barrier`, a file-based fleet barrier
  with the same deadline semantics, for host-side lockstep points.

File names and JSON fields are the reference's, byte for byte, so either
package reads the other's rendezvous dir. The chaos sites:
``fleet.heartbeat`` (drop-heartbeat) in :class:`Heartbeater`'s loop,
``fleet.barrier`` (delay-collective), ``executor.dispatch`` and
``fleet.rank.kill`` (kill-rank).
"""

from __future__ import annotations

import glob as _glob
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

from ..config import get_config
from ..observability import context as _context
from ..observability import flight as _flight
from ..observability.metrics import counter as _counter
from ..observability.metrics import gauge as _gauge
from ..observability.metrics import histogram as _histogram
from ..utils import get_logger
from . import faults as _faults
from . import retry as _retry

logger = get_logger(__name__)

__all__ = [
    "ABORT_EXIT_CODE",
    "FleetError",
    "DeadRankError",
    "HungDispatchError",
    "CoordinatedAbortError",
    "FleetStatus",
    "Heartbeater",
    "FleetMonitor",
    "FleetMember",
    "rendezvous_dir",
    "write_beat",
    "read_heartbeats",
    "write_json_atomic",
    "read_latest_records",
    "fleet_status",
    "signal_abort",
    "abort_requested",
    "clear_fleet",
    "enroll",
    "current_member",
    "abort_on_lost_peer",
    "barrier",
    "dispatch_deadline_s",
    "note_deadline_exemption",
    "run_with_deadline",
]

#: Exit code of a coordinated abort: a rank that detected a dead peer (or
#: saw the abort signal) and exited on purpose; the supervisor tells it
#: from the crash that caused it.
ABORT_EXIT_CODE = 43

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
_faults.register_site(
    "fleet.barrier",
    "fleet.barrier arrival — an injected Delay stalls this rank's "
    "arrival (hung-collective chaos at a rendezvous point)",
)


class FleetError(RuntimeError):
    """Base of the fleet-supervision failure family."""


class DeadRankError(FleetError):
    """One or more peer ranks stopped heartbeating (or were reaped)."""

    def __init__(self, ranks: Sequence[int], message: str):
        super().__init__(message)
        self.ranks = tuple(sorted(int(r) for r in ranks))


class HungDispatchError(FleetError, TimeoutError):
    """A dispatch/barrier exceeded the dispatch deadline. Subclasses
    ``TimeoutError`` so the default retry classification treats it as
    transient (a redial after a fleet restart may succeed)."""


class CoordinatedAbortError(FleetError):
    """A peer signalled the coordinated abort; this rank stops too."""


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


# ---------------------------------------------------------------------------
# monitor
# ---------------------------------------------------------------------------

class FleetMonitor:
    """Daemon thread classifying peers from their beats. Callbacks fire
    once per newly detected condition: ``on_dead(ranks, status)``,
    ``on_straggler(ranks, status)``, ``on_abort(record)``. The monitor
    never judges its own rank (a wedged self cannot usefully self-report;
    peers and the supervisor own that verdict). When ``num_processes`` is
    known, a rank that never publishes a beat within ``startup_grace_s``
    of the monitor's start (default ``max(4 × timeout_s, 20 s)``: peers
    may still be importing torch or loading a model before they enroll)
    is declared dead too: a rank that crashed before its first beat must
    not stay invisible."""

    def __init__(
        self,
        directory: str,
        *,
        run_id: Optional[str] = None,
        num_processes: Optional[int] = None,
        timeout_s: Optional[float] = None,
        straggler_s: Optional[float] = None,
        poll_s: Optional[float] = None,
        self_rank: Optional[int] = None,
        startup_grace_s: Optional[float] = None,
        on_dead: Optional[Callable[[List[int], FleetStatus], None]] = None,
        on_straggler: Optional[Callable[[List[int], FleetStatus], None]] = None,
        on_abort: Optional[Callable[[dict], None]] = None,
    ):
        cfg = get_config()
        self.directory = directory
        self.run_id = run_id or _context.run_id()
        self.num_processes = num_processes
        self.timeout_s = cfg.heartbeat_timeout_s if timeout_s is None else timeout_s
        self.straggler_s = self.timeout_s / 2.0 if straggler_s is None else straggler_s
        self.poll_s = cfg.heartbeat_interval_s if poll_s is None else poll_s
        self.self_rank = _context.process_index() if self_rank is None else self_rank
        self.startup_grace_s = (
            max(4.0 * self.timeout_s, 20.0) if startup_grace_s is None else startup_grace_s
        )
        self._t0 = time.monotonic()
        self.on_dead = on_dead
        self.on_straggler = on_straggler
        self.on_abort = on_abort
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the monitor thread scans, and so does a rank that lost a peer in
        # a collective (abort_on_lost_peer): each verdict is reported once
        self._lock = threading.Lock()
        self._reported_dead: Set[int] = set()
        self._reported_straggler: Set[int] = set()
        self._abort_seen = False

    def start(self) -> "FleetMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name=f"tfs-fleet-monitor-p{self.self_rank}",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 4 + 1.0)
            self._thread = None

    def status(self) -> FleetStatus:
        return fleet_status(
            self.directory, run_id=self.run_id, num_processes=self.num_processes,
            timeout_s=self.timeout_s, straggler_s=self.straggler_s,
        )

    def check_once(self) -> FleetStatus:
        """One scan (the loop body; callable directly from tests)."""
        ab = abort_requested(self.directory, self.run_id)
        with self._lock:
            first_abort = ab is not None and not self._abort_seen
            self._abort_seen = self._abort_seen or ab is not None
        if first_abort:
            _flight.record(
                "fleet.abort_seen", reason=ab.get("reason"), ranks=ab.get("ranks"),
                by=ab.get("by"),
            )
            if self.on_abort is not None:
                self.on_abort(ab)
        st = self.status()
        with self._lock:
            new_stragglers = [r for r in st.stragglers
                              if r != self.self_rank and r not in self._reported_straggler]
            self._reported_straggler.update(new_stragglers)
        if new_stragglers:
            _STRAGGLERS.inc(len(new_stragglers))
            MISSED_BEATS.inc(len(new_stragglers))
            for r in new_stragglers:
                _flight.record(
                    "fleet.straggler", rank=r, age_s=round(st.ages.get(r, -1.0), 3),
                    straggler_s=self.straggler_s,
                )
            logger.warning(
                "fleet: straggler rank(s) %s (beat age > %.3gs)", new_stragglers, self.straggler_s,
            )
            if self.on_straggler is not None:
                self.on_straggler(new_stragglers, st)
        dead_now = list(st.dead)
        if st.missing and time.monotonic() - self._t0 > self.startup_grace_s:
            # expected ranks that never published a beat: after the
            # startup grace they are dead, not "not yet here"
            dead_now.extend(st.missing)
        with self._lock:
            new_dead = [r for r in dead_now
                        if r != self.self_rank and r not in self._reported_dead]
            self._reported_dead.update(new_dead)
        if new_dead:
            DEAD_RANKS.inc(len(new_dead))
            MISSED_BEATS.inc(len(new_dead))
            for r in new_dead:
                _flight.record(
                    "fleet.heartbeat_lost", rank=r, age_s=round(st.ages.get(r, -1.0), 3),
                    timeout_s=self.timeout_s, never_started=r in st.missing,
                )
            logger.error(
                "fleet: dead rank(s) %s (no heartbeat for > %.3gs)", new_dead, self.timeout_s,
            )
            if self.on_dead is not None:
                self.on_dead(new_dead, st)
        return st

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_once()
            except Exception as e:  # pragma: no cover - must keep watching
                logger.debug("fleet monitor scan failed: %s", e)


# ---------------------------------------------------------------------------
# enrollment (the worker-side default policy)
# ---------------------------------------------------------------------------

@dataclass
class FleetMember:
    """This process's fleet membership: its heartbeater and monitor.
    ``abort_on_dead`` is :func:`enroll`'s policy: exit on a dead peer."""

    directory: str
    heartbeater: Heartbeater
    monitor: Optional[FleetMonitor]
    abort_on_dead: bool = True

    def leave(self, graceful: bool = True) -> None:
        if self.monitor is not None:
            self.monitor.stop()
        self.heartbeater.stop(graceful=graceful)


_member_lock = threading.Lock()
_member: Optional[FleetMember] = None
# the first thread into _abort_self exits the process; a second one (the
# monitor and a collective's lost peer, say) waits for that exit
_abort_lock = threading.Lock()


def current_member() -> Optional[FleetMember]:
    with _member_lock:
        return _member


def _abort_self(reason: str, ranks: Sequence[int], directory: str, signal_peers: bool) -> None:
    """The coordinated-abort exit: postmortem first (the black box must
    name the missing rank), signal peers, a graceful final beat, then
    ``os._exit``: a main thread blocked inside a collective cannot be
    unwound politely, and a bounded, diagnosable death is the contract."""
    if not _abort_lock.acquire(blocking=False):
        threading.Event().wait()  # another thread is already exiting
    _flight.record("fleet.self_abort", reason=reason, ranks=list(ranks))
    _flight.dump(reason="fleet_abort")
    if signal_peers:
        signal_abort(directory, reason, dead_ranks=ranks)
    member = current_member()
    if member is not None:
        member.heartbeater.stop(graceful=True)
    logger.error("fleet: aborting (exit %d): %s", ABORT_EXIT_CODE, reason)
    os._exit(ABORT_EXIT_CODE)


def enroll(
    directory: Optional[str] = None,
    *,
    monitor: bool = True,
    abort_on_dead: bool = True,
    num_processes: Optional[int] = None,
    timeout_s: Optional[float] = None,
    interval_s: Optional[float] = None,
) -> Optional[FleetMember]:
    """Join the fleet rooted at ``directory`` (default ``TFTPU_FLEET_DIR``;
    a no-op returning None when unset: a single-process run pays
    nothing). Starts the heartbeat publisher and, with ``monitor=True``,
    the peer monitor under the default policy: a dead peer or a peer's
    abort signal → flight postmortem naming the rank → coordinated abort
    → ``os._exit(ABORT_EXIT_CODE)`` (``abort_on_dead=False`` records
    without exiting). Idempotent per process; ``training.run_resumable``
    calls it, so a training loop launched under ``supervise()`` is
    fleet-aware."""
    global _member
    directory = directory or rendezvous_dir()
    if not directory:
        return None
    # creation happens under the lock: two concurrent first enrollments
    # would otherwise each start a Heartbeater, and the loser's orphan
    # would publish fresh beats for this rank after the member left
    with _member_lock:
        if _member is not None:
            return _member
        member = _enroll_locked(
            directory, monitor=monitor, abort_on_dead=abort_on_dead,
            num_processes=num_processes, timeout_s=timeout_s, interval_s=interval_s,
        )
        _member = member
    import atexit

    atexit.register(member.leave)
    logger.info(
        "fleet: enrolled rank %d in %s (interval %.3gs)",
        member.heartbeater.rank, directory, member.heartbeater.interval_s,
    )
    return member


def _enroll_locked(
    directory: str,
    *,
    monitor: bool,
    abort_on_dead: bool,
    num_processes: Optional[int],
    timeout_s: Optional[float],
    interval_s: Optional[float],
) -> FleetMember:
    num_processes = _context.num_processes() if num_processes is None else num_processes
    hb = Heartbeater(directory, interval_s=interval_s).start()
    mon = None
    if monitor:
        def _on_dead(ranks: List[int], st: FleetStatus) -> None:
            reason = f"rank(s) {ranks} stopped heartbeating (timeout {mon.timeout_s:g}s)"
            if abort_on_dead:
                _abort_self(reason, ranks, directory, signal_peers=True)

        def _on_abort(rec: dict) -> None:
            reason = f"coordinated abort from rank {rec.get('by')}: {rec.get('reason')}"
            if abort_on_dead:
                _abort_self(reason, rec.get("ranks") or [], directory, signal_peers=False)

        mon = FleetMonitor(
            directory, num_processes=num_processes, timeout_s=timeout_s,
            on_dead=_on_dead, on_abort=_on_abort,
        )
        mon.start()
    return FleetMember(directory, hb, mon, abort_on_dead)


def _reset_member_for_tests() -> None:
    """Forget the enrollment singleton (test hygiene only)."""
    global _member
    with _member_lock:
        m, _member = _member, None
    if m is not None:
        m.leave(graceful=False)


def _after_fork_in_child() -> None:
    # a forked child inherits the parent's membership object but not its
    # threads: drop it so the child can enroll under its own rank. No
    # lock: the child is single-threaded here.
    global _member
    _member = None


if hasattr(os, "register_at_fork"):  # pragma: no branch - posix
    os.register_at_fork(after_in_child=_after_fork_in_child)


# ---------------------------------------------------------------------------
# hung-dispatch watchdog
# ---------------------------------------------------------------------------

def dispatch_deadline_s() -> float:
    """The active dispatch deadline (seconds; 0 = watchdog disabled)."""
    try:
        return float(get_config().dispatch_deadline_s or 0.0)
    except (TypeError, ValueError):
        return 0.0


def note_deadline_exemption(describe: str) -> None:
    """Record that one call ran unbounded by the watchdog (counted and
    flight-recorded: a fleet exempting calls in steady state is a fleet
    the deadline does not protect)."""
    _DEADLINE_EXEMPTIONS.inc()
    _flight.record("fleet.deadline_exemption", entry=describe)


def _hung(
    describe: str,
    deadline: float,
    directory: Optional[str],
    *,
    missing: Optional[List[int]] = None,
    extra: Optional[dict] = None,
    signal: bool = True,
    message: Optional[str] = None,
) -> HungDispatchError:
    """Build the hung-dispatch verdict — the one protocol the watchdog
    and the barrier share: count, flight-record and dump a postmortem
    naming the stalled call and the unresponsive ranks, and (unless
    ``signal=False``) the coordinated abort. ``missing`` overrides the
    heartbeat-inferred unresponsive set when the caller knows it exactly
    (the barrier does, from arrivals)."""
    directory = directory or rendezvous_dir()
    if missing is None:
        missing = []
        if directory:
            try:
                missing = fleet_status(
                    directory, run_id=_context.run_id(),
                    num_processes=_context.num_processes(),
                ).unresponsive()
            except Exception:  # pragma: no cover - status is best-effort
                pass
    _HUNG_DISPATCHES.inc()
    _flight.record(
        "fleet.hung_dispatch", entry=describe, deadline_s=deadline,
        missing_ranks=missing, **(extra or {}),
    )
    _flight.dump(reason="hung_dispatch")
    if signal and directory:
        signal_abort(
            directory,
            f"hung dispatch {describe!r} (deadline {deadline:g}s, "
            f"unresponsive ranks {missing})",
            dead_ranks=missing,
        )
    if message is None:
        message = f"dispatch {describe!r} exceeded the {deadline:g}s deadline"
        if missing:
            message += f"; unresponsive rank(s): {missing}"
        message += (
            " — aborted by the hung-collective watchdog (see the "
            "flight-recorder postmortem; the in-flight attempt is "
            "abandoned, not interrupted)"
        )
    return HungDispatchError(message)


def run_with_deadline(
    fn: Callable[[], object],
    *,
    describe: str = "dispatch",
    deadline: Optional[float] = None,
    directory: Optional[str] = None,
    signal: bool = True,
):
    """Run ``fn()`` bounded by the dispatch deadline (default
    ``config.dispatch_deadline_s``; disabled → a plain call, no thread).
    On expiry the attempt is abandoned on its daemon thread (Python
    cannot interrupt a call blocked in a collective) and
    :class:`HungDispatchError` raises after the postmortem/abort
    protocol. ``signal=False`` skips the coordinated-abort write for
    calls that are retried on timeout (the process-group handshake): an
    abort record outliving a successful redial would kill every rank."""
    d = dispatch_deadline_s() if deadline is None else float(deadline or 0)
    if d <= 0:
        return fn()
    try:
        return _retry.run_abandonable(
            fn, (), {}, d, thread_name="tfs-dispatch-deadline"
        )
    except _retry.WatchdogExpired:
        raise _hung(describe, d, directory, signal=signal) from None


# gloo's words for a peer that is gone (its TCP pair closed or reset under
# a collective) and NCCL's for a communicator whose peer exited
_PEER_LOST = ("closed by peer", "reset by peer", "Broken pipe", "remote process exited",
              "communicator was aborted")


def _peer_lost(error: BaseException) -> bool:
    """Whether a collective's ``error`` says that a peer rank is gone."""
    return type(error).__name__ == "DistNetworkError" or any(m in str(error) for m in _PEER_LOST)


def abort_on_lost_peer(describe: str, error: BaseException) -> None:
    """End this rank through the coordinated abort when its collective
    ``describe`` raised ``error`` because a peer is gone, and it is
    enrolled (:func:`enroll`, default policy) in a fleet of more than one
    rank. Otherwise return, and the caller re-raises.

    Gloo raises where the reference's XLA collectives hang, and the
    reference's survivor is then ended by its monitor with no checkpoint
    written. Without this the survivor's ``run_resumable`` would write an
    emergency checkpoint newer than its dead peer's, and the restarted
    data-parallel fleet would pair the wrong steps' collectives. The lost
    rank named is the abort record's when one appears within the
    heartbeat timeout (the supervisor's, first writer wins), else the
    rendezvous dir's unresponsive ranks, as a hung dispatch names them."""
    member = current_member()
    n = _context.num_processes() or 1
    if member is None or not member.abort_on_dead or n <= 1 or not _peer_lost(error):
        return
    mon = member.monitor
    timeout = mon.timeout_s if mon is not None else get_config().heartbeat_timeout_s
    me = _context.process_index()
    _flight.record("fleet.peer_lost", entry=describe, error=type(error).__name__,
                   message=str(error)[:300])
    until = time.monotonic() + timeout
    while True:
        ab = abort_requested(member.directory)
        if ab is not None:
            if mon is not None:
                mon.check_once()  # records fleet.abort_seen; its on_abort exits
            _abort_self(f"coordinated abort from rank {ab.get('by')}: {ab.get('reason')}",
                        ab.get("ranks") or [], member.directory, signal_peers=False)
        ranks = [r for r in fleet_status(member.directory, run_id=_context.run_id(),
                                         num_processes=n, timeout_s=timeout).unresponsive()
                 if r != me]
        if ranks or time.monotonic() > until:
            _abort_self(f"collective {describe!r} lost a peer (unresponsive rank(s) {ranks}): "
                        f"{error}", ranks, member.directory, signal_peers=True)
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# rendezvous barrier
# ---------------------------------------------------------------------------

# per-(directory, run incarnation, name) call counter: every use of a
# barrier name is its own generation, agreeing across ranks because every
# rank calls every barrier in order
_gen_lock = threading.Lock()
_barrier_gen: Dict[str, int] = {}


def barrier(
    name: str,
    *,
    directory: Optional[str] = None,
    num_processes: Optional[int] = None,
    rank: Optional[int] = None,
    deadline: Optional[float] = None,
    poll_s: float = 0.01,
) -> None:
    """File-based fleet barrier: every rank marks its arrival at ``name``
    and waits for all ``num_processes`` peers, bounded by ``deadline``
    (``None`` or ``<= 0``: the dispatch deadline when armed, else
    ``max(4 × heartbeat_timeout_s, 20 s)``; a barrier is never
    unbounded). A missing peer raises :class:`HungDispatchError` naming
    the missing ranks after the postmortem/abort protocol; a peer's abort
    signal raises :class:`CoordinatedAbortError`. A process outside a
    rendezvous dir, or alone, returns at once. Reusing a name is fine:
    each use is a new generation (``TFTPU_FLEET_ATTEMPT`` folded in, so a
    restarted fleet counts afresh); generations two or more behind are
    pruned on entry."""
    directory = directory or rendezvous_dir()
    if not directory:
        return
    n = num_processes if num_processes is not None else _context.num_processes()
    if not n or int(n) <= 1:
        return
    n = int(n)
    rank = _context.process_index() if rank is None else int(rank)
    run = _context.run_id()
    _faults.delay_point("fleet.barrier")
    attempt = os.environ.get("TFTPU_FLEET_ATTEMPT", "0")
    with _gen_lock:
        gen_key = f"{os.path.abspath(directory)}|{run}_a{attempt}_{name}"
        gen = _barrier_gen.get(gen_key, 0)
        _barrier_gen[gen_key] = gen + 1
    base = f"barrier_{run}_a{attempt}_{name}"
    tag = f"{base}.g{gen}"
    os.makedirs(directory, exist_ok=True)
    # being AT generation g proves every rank observed all of g-2's
    # arrivals: those files can go (g-1's must stay for slower peers)
    for path in _glob.glob(os.path.join(directory, f"{base}.g*")):
        try:
            old_gen = int(os.path.basename(path)[len(base) + 2:].split("_p", 1)[0])
        except (IndexError, ValueError):
            continue
        if old_gen <= gen - 2:
            try:
                os.remove(path)
            except OSError:
                pass  # a peer pruned it first
    with open(os.path.join(directory, f"{tag}_p{rank}"), "w") as f:
        f.write(str(time.time()))
    d = deadline
    if d is None or d <= 0:
        d = dispatch_deadline_s() or max(4.0 * get_config().heartbeat_timeout_s, 20.0)
    t0 = time.monotonic()
    while True:
        arrived = set()
        for path in _glob.glob(os.path.join(directory, f"{tag}_p*")):
            try:
                arrived.add(int(path.rsplit("_p", 1)[1]))
            except (IndexError, ValueError):
                continue
        if len(arrived) >= n:
            return
        ab = abort_requested(directory, run)
        if ab is not None:
            raise CoordinatedAbortError(
                f"barrier {name!r}: coordinated abort from rank "
                f"{ab.get('by')}: {ab.get('reason')}"
            )
        if time.monotonic() - t0 > d:
            missing = sorted(set(range(n)) - arrived)
            raise _hung(
                f"fleet.barrier[{name}]", d, directory,
                missing=missing, extra={"arrived": sorted(arrived)},
                message=(
                    f"barrier {name!r}: rank(s) {missing} missing after "
                    f"the {d:g}s deadline (arrived: {sorted(arrived)}) — "
                    "aborted by the hung-collective watchdog (see the "
                    "flight-recorder postmortem)"
                ),
            )
        time.sleep(poll_s)
