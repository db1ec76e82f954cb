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
from typing import Callable, Dict, List, Optional, Sequence

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
    "FleetError",
    "DeadRankError",
    "HungDispatchError",
    "CoordinatedAbortError",
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
    "barrier",
    "dispatch_deadline_s",
    "note_deadline_exemption",
    "run_with_deadline",
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
