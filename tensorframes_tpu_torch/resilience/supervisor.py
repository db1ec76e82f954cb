"""Fleet launcher: spawn ranks, reap crashes, coordinated teardown,
restart and resume.

The reference package's ``resilience/supervisor.py``. ``supervise()``
owns a multi-process run end to end, and its unit of recovery is the
whole fleet: ranks that share collectives cannot lose one rank and go on,
so any rank's death (a crash, a SIGKILL, a stale heartbeat) takes down
the survivors through the coordinated abort, and the fleet restarts.
Convergence is the checkpoint's: workers that drive
:func:`~tensorframes_tpu_torch.training.run_resumable` resume from the
newest intact step with a deterministic batch replay, so a ``kill -9`` of
any rank converges to the state of an uninterrupted run, bit for bit.

Lifecycle per incarnation:

1. **clear** stale heartbeat, abort and barrier files from the rendezvous
   dir (a leftover abort signal must not kill the new attempt at birth);
2. **spawn** ``num_processes`` ranks with
   :func:`~tensorframes_tpu_torch.observability.context.child_env`
   identity (a shared ``TFTPU_RUN_ID``, each rank's
   ``TFTPU_PROCESS_INDEX``) plus ``TFTPU_FLEET_DIR``,
   ``TFTPU_NUM_PROCESSES``, ``TFTPU_FLEET_ATTEMPT`` and
   ``TFTPU_FLIGHT_DIR``, so every child heartbeats, monitors and spools
   its black box with no code of its own;
3. **watch**: reap exits, and declare a running rank dead when its
   published heartbeat goes stale past the timeout. A stale beat catches
   a stall of the whole process (SIGSTOP, swap death, a wedged
   interpreter); a rank blocked in a collective keeps beating from its
   daemon thread, so a hung collective is the dispatch deadline's
   (``configure(dispatch_deadline_s=)``), and a collective that raises on
   a lost peer ends the rank through the coordinated abort;
4. on a failure: **signal the coordinated abort**, give survivors a grace
   window to die cleanly (their monitors see the signal and exit
   :data:`~tensorframes_tpu_torch.resilience.fleet.ABORT_EXIT_CODE`), then
   SIGTERM, then SIGKILL; **restart** up to ``max_restarts`` times,
   counting ``tftpu_fleet_restarts_total`` and the detection → respawn
   wall in ``tftpu_fleet_recovery_seconds``.

Exceeding the restart budget raises :class:`SuperviseError` carrying the
whole per-attempt exit-code history.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

from ..config import get_config
from ..observability import context as _context
from ..observability import flight as _flight
from ..utils import get_logger
from . import fleet as _fleet

# the supervisor's view rides the tftpu_fleet_* instruments fleet.py
# registers at import: one definition each
from .fleet import (
    ALIVE_RANKS as _ALIVE_RANKS,
    DEAD_RANKS as _DEAD_RANKS,
    MISSED_BEATS as _MISSED_BEATS,
    RECOVERY_SECONDS as _RECOVERY_SECONDS,
    RESTARTS as _RESTARTS,
)

logger = get_logger(__name__)

__all__ = ["RankFailure", "SuperviseResult", "SuperviseError", "supervise"]

Cmd = Union[Sequence[str], Callable[[int], Sequence[str]]]


@dataclass
class RankFailure:
    """What took an incarnation down."""

    rank: int
    reason: str
    #: "exit" (nonzero rc), "signal" (killed), "heartbeat" (wedged),
    #: "abort" (a rank signalled the coordinated abort first)
    kind: str


@dataclass
class SuperviseResult:
    """Outcome of one :func:`supervise` call."""

    ok: bool
    #: fleet incarnations launched (1 = no restart was needed)
    attempts: int
    restarts: int
    #: per-incarnation ``{rank: returncode}`` (negative = -signal)
    exit_codes: List[Dict[int, int]]
    failures: List[RankFailure]
    #: total failure-detection → fleet-respawned seconds across restarts
    recovery_seconds: float
    rendezvous_dir: str
    run_id: str


class SuperviseError(_fleet.FleetError):
    """The restart budget ran out; ``result`` holds the whole history."""

    def __init__(self, message: str, result: SuperviseResult):
        super().__init__(message)
        self.result = result


def _spawn_fleet(
    cmd: Cmd,
    num_processes: int,
    *,
    run_id: str,
    rendezvous_dir: str,
    flight_dir: str,
    flight_explicit: bool,
    attempt: int,
    env: Optional[Dict[str, str]],
    inherit_env: bool,
) -> Dict[int, subprocess.Popen]:
    procs: Dict[int, subprocess.Popen] = {}
    try:
        for i in range(num_processes):
            e = dict(os.environ) if inherit_env else {}
            if env:
                e.update(env)
            e.update(_context.child_env(i))
            e["TFTPU_RUN_ID"] = run_id
            e["TFTPU_FLEET_DIR"] = rendezvous_dir
            e["TFTPU_NUM_PROCESSES"] = str(num_processes)
            e["TFTPU_FLEET_ATTEMPT"] = str(attempt)
            if flight_explicit:
                # the caller named the black box's place: it wins over an
                # inherited TFTPU_FLIGHT_DIR
                e["TFTPU_FLIGHT_DIR"] = flight_dir
            else:
                e.setdefault("TFTPU_FLIGHT_DIR", flight_dir)
            argv = list(cmd(i)) if callable(cmd) else list(cmd)
            procs[i] = subprocess.Popen(argv, env=e)
    except BaseException:
        # a later rank failed to spawn (cmd(i) raised, ENOMEM, ...): the
        # ranks already running must not go on unsupervised
        for p in procs.values():
            try:
                p.kill()
                p.wait(timeout=10)
            except Exception:  # pragma: no cover - best-effort reap
                pass
        raise
    return procs


def _teardown(procs: Dict[int, subprocess.Popen], grace_s: float) -> Dict[int, int]:
    """Reap every rank: wait out the grace window (monitors that saw the
    abort signal exit on their own, their final beat and postmortem
    written), then SIGTERM, then SIGKILL."""
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline and any(p.poll() is None for p in procs.values()):
        time.sleep(0.02)
    for p in procs.values():
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and any(p.poll() is None for p in procs.values()):
        time.sleep(0.02)
    for p in procs.values():
        if p.poll() is None:  # a stopped process, or one in uninterruptible IO
            p.kill()
    return {i: p.wait() for i, p in procs.items()}


def supervise(
    cmd: Cmd,
    num_processes: int,
    *,
    rendezvous_dir: Optional[str] = None,
    max_restarts: int = 2,
    heartbeat_timeout_s: Optional[float] = None,
    poll_s: float = 0.05,
    grace_s: float = 3.0,
    env: Optional[Dict[str, str]] = None,
    inherit_env: bool = True,
    run_id: Optional[str] = None,
    flight_dir: Optional[str] = None,
) -> SuperviseResult:
    """Launch and supervise a ``num_processes``-rank fleet running ``cmd``
    (one argv for every rank, or ``cmd(rank) -> argv``).

    Blocks until the fleet finishes clean (every rank exits 0), returning
    the :class:`SuperviseResult`, or the restart budget is spent
    (:class:`SuperviseError`). Any rank exiting nonzero, dying to a
    signal, or letting its heartbeat go stale past ``heartbeat_timeout_s``
    fails the incarnation: survivors are torn down by the coordinated
    abort, the grace window, SIGTERM and SIGKILL, and the whole fleet
    restarts (resuming from a checkpoint is the workers' side of the
    contract, through ``run_resumable``). A stale heartbeat detects a
    stall of the whole process; a rank wedged inside a collective still
    beats, so pair supervision with ``configure(dispatch_deadline_s=)``.
    ``rendezvous_dir`` defaults to a fresh temporary dir; the children's
    flight-recorder black boxes spool under ``flight_dir`` (default
    ``<rendezvous>/flight``) for ``read_blackbox()``."""
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    rendezvous_dir = rendezvous_dir or tempfile.mkdtemp(prefix="tftpu-fleet-")
    os.makedirs(rendezvous_dir, exist_ok=True)
    run = run_id or _context.run_id()
    flight_explicit = flight_dir is not None
    flight_dir = flight_dir or os.path.join(rendezvous_dir, "flight")
    timeout = (
        get_config().heartbeat_timeout_s if heartbeat_timeout_s is None
        else float(heartbeat_timeout_s)
    )
    restarts = 0
    attempts = 0
    recovery_total = 0.0
    t_detect: Optional[float] = None
    exit_codes: List[Dict[int, int]] = []
    failures: List[RankFailure] = []
    while True:
        attempts += 1
        _fleet.clear_fleet(rendezvous_dir, run)
        procs = _spawn_fleet(
            cmd, num_processes, run_id=run, rendezvous_dir=rendezvous_dir,
            flight_dir=flight_dir, flight_explicit=flight_explicit,
            attempt=attempts - 1, env=env, inherit_env=inherit_env,
        )
        if t_detect is not None:
            # recovery = failure detection → fleet respawned (teardown,
            # clear and spawn), as the histogram's help says
            recovery = time.monotonic() - t_detect
            t_detect = None
            recovery_total += recovery
            _RECOVERY_SECONDS.observe(recovery)
            logger.warning("supervise: fleet respawned %.2fs after failure detection", recovery)
        logger.info(
            "supervise: attempt %d — %d rank(s) up in %s", attempts, num_processes, rendezvous_dir,
        )
        failure: Optional[RankFailure] = None
        exited: Dict[int, int] = {}
        while failure is None and len(exited) < num_processes:
            time.sleep(poll_s)
            _ALIVE_RANKS.set(sum(1 for p in procs.values() if p.poll() is None))
            for i, p in procs.items():
                if i in exited:
                    continue
                rc = p.poll()
                if rc is None:
                    continue
                exited[i] = rc
                if rc == 0:
                    continue
                if rc == _fleet.ABORT_EXIT_CODE:
                    # a deliberate coordinated abort: the cause is in the
                    # abort record (usually another rank's death), not in
                    # this messenger
                    ab = _fleet.abort_requested(rendezvous_dir, run) or {}
                    blamed = ab.get("ranks") or [i]
                    failure = RankFailure(
                        rank=int(blamed[0]) if blamed else i,
                        reason=(
                            f"coordinated abort (signalled by rank {ab.get('by', i)}): "
                            f"{ab.get('reason', 'no record')}"
                        ),
                        kind="abort",
                    )
                elif rc < 0:
                    failure = RankFailure(
                        rank=i, reason=f"rank {i} killed by signal {-rc}", kind="signal",
                    )
                else:
                    failure = RankFailure(rank=i, reason=f"rank {i} exited rc={rc}", kind="exit")
                break
            if failure is not None:
                break
            # heartbeat watch: a rank can be alive as a process and dead as
            # a participant. Only ranks that published a beat are judged: a
            # worker that never enrolls is supervised by its exit code alone
            try:
                beats = _fleet.read_heartbeats(rendezvous_dir, run)
            except OSError:  # pragma: no cover - transient fs wobble
                beats = {}
            now = time.time()
            for i, rec in beats.items():
                if i in exited or i not in procs or rec.get("stopped"):
                    continue
                age = now - float(rec.get("ts", now))
                if age > timeout:
                    _flight.record(
                        "fleet.heartbeat_lost", rank=i, age_s=round(age, 3), timeout_s=timeout,
                    )
                    _MISSED_BEATS.inc()
                    failure = RankFailure(
                        rank=i,
                        reason=f"rank {i} heartbeat stale for {age:.2f}s (timeout {timeout:g}s)",
                        kind="heartbeat",
                    )
                    break
        if failure is None:
            exit_codes.append(exited)
            _ALIVE_RANKS.set(0)
            logger.info(
                "supervise: fleet finished clean after %d attempt(s) (%d restart(s))",
                attempts, restarts,
            )
            return SuperviseResult(
                ok=True, attempts=attempts, restarts=restarts, exit_codes=exit_codes,
                failures=failures, recovery_seconds=recovery_total,
                rendezvous_dir=rendezvous_dir, run_id=run,
            )
        t_detect = time.monotonic()
        failures.append(failure)
        _DEAD_RANKS.inc()
        _flight.record(
            "fleet.rank_dead", rank=failure.rank, reason=failure.reason,
            failure_kind=failure.kind, attempt=attempts,
        )
        logger.error("supervise: %s", failure.reason)
        _fleet.signal_abort(rendezvous_dir, failure.reason, dead_ranks=[failure.rank], run_id=run)
        final = _teardown(procs, grace_s)
        final.update(exited)
        exit_codes.append(final)
        _ALIVE_RANKS.set(0)
        if restarts >= max_restarts:
            result = SuperviseResult(
                ok=False, attempts=attempts, restarts=restarts, exit_codes=exit_codes,
                failures=failures, recovery_seconds=recovery_total,
                rendezvous_dir=rendezvous_dir, run_id=run,
            )
            raise SuperviseError(
                f"fleet failed {attempts} time(s) (restart budget "
                f"{max_restarts} exhausted); last failure: "
                f"{failure.reason}",
                result,
            )
        restarts += 1
        _RESTARTS.inc()
        _flight.record("fleet.restart", attempt=attempts + 1, after=failure.reason)
        logger.warning(
            "supervise: restarting fleet (attempt %d/%d)", attempts + 1, max_restarts + 1,
        )
