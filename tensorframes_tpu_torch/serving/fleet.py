"""Scale-out serving: a supervised multi-replica fleet behind one
fault-tolerant ingress.

Composition of parts that exist:

* **supervision** — replicas heartbeat into a shared rendezvous dir
  (:mod:`tensorframes_tpu_torch.resilience.fleet`); the fleet reaps
  crashed processes and declares wedged ones dead from stale beats.
  Serving replicas are **independent** servers, so a death restarts
  exactly ONE replica while the survivors keep taking traffic: that is
  what keeps p99 bounded through a ``kill -9``.
* **the shared builds** — every replica loads one kernel library,
  content-hashed under ``build/torch_kernels/`` (a cold start builds it
  once, under a lock, for all of them), so a RESTARTED replica runs no
  ``nvcc``: its healthz reads ``process.kernel_builds == 0``, and its
  ``xla_compiles`` (first-seen dispatch keys) are its warm-up's and no
  more. ``TFTPU_COMPILE_CACHE`` points every replica at one store (the
  plan-stats sidecar and the result store live there).
* **the server** — each replica keeps the whole single-process fast
  path (push-mode batcher, bucket ladder, deadlines, decode) untouched:
  a replica is just ``serve_replica(Server(...))``.
* **the router** — one ingress that load-balances by scraped queue
  depth, never routes to a dead, draining or starting replica, and
  redrives failed dispatches to survivors under the original deadline
  with idempotency-key dedup.

Lifecycle: ``start()`` spawns N replica processes (rank env: run id,
process index, fleet dir, attempt, flight spool and the shared store),
waits for readiness, and opens the ingress. The supervision thread
watches process exits and heartbeats; a death marks the replica dead at
the router (in-flight requests to it redrive at once), then respawns that
rank — crash restarts draw from ``max_restarts``; clean exits (a drained
replica: the rolling-restart flow) respawn without consuming budget.
``stop()`` drains every replica over HTTP (state ``draining`` →
``stopped``), escalates SIGTERM → SIGKILL for stragglers, and shuts the
router down.
"""

from __future__ import annotations

import os
import signal
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Union

from ..config import get_config
from ..observability import context as _context
from ..observability import flight as _flight
from ..utils import get_logger
from ..resilience import fleet as _fleet
from . import metrics as m
from .router import Router, RouterConfig, http_json
from .replica import card_addr, read_cards

logger = get_logger(__name__)

__all__ = ["ServingFleet", "FleetDegradedError"]

Cmd = Union[Sequence[str], Callable[[int], Sequence[str]]]


class FleetDegradedError(RuntimeError):
    """The restart budget ran out with replicas still down."""


class ServingFleet:
    """N supervised replica server processes + one router ingress.

    ``cmd`` is the replica argv (or ``cmd(rank) -> argv``) — a process
    that calls :func:`~tensorframes_tpu_torch.serving.replica.serve_replica`
    (e.g. ``python -m tensorframes_tpu_torch.serving.replica_main
    --demo``). The fleet owns the environment contract: each rank gets
    the fleet identity (``TFTPU_RUN_ID``/``TFTPU_PROCESS_INDEX``/
    ``TFTPU_FLEET_DIR``/``TFTPU_FLEET_ATTEMPT``/``TFTPU_FLIGHT_DIR``)
    plus ``TFTPU_COMPILE_CACHE`` pointing at ONE shared store.

    Context-manager friendly::

        with ServingFleet(cmd, 3) as fleet:
            requests.post(fleet.url + "/v1/score", json={...})
    """

    def __init__(
        self,
        cmd: Cmd,
        num_replicas: int,
        *,
        rendezvous_dir: Optional[str] = None,
        compile_cache: Optional[str] = None,
        max_restarts: int = 4,
        heartbeat_timeout_s: Optional[float] = None,
        poll_s: float = 0.05,
        ready_timeout_s: float = 120.0,
        grace_s: float = 5.0,
        env: Optional[Dict[str, str]] = None,
        inherit_env: bool = True,
        run_id: Optional[str] = None,
        flight_dir: Optional[str] = None,
        router_config: Optional[RouterConfig] = None,
        ingress_port: int = 0,
        ingress_addr: str = "127.0.0.1",
    ):
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}"
            )
        if max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {max_restarts}"
            )
        self.cmd = cmd
        self.num_replicas = int(num_replicas)
        self.rendezvous_dir = rendezvous_dir or tempfile.mkdtemp(
            prefix="tftpu-serving-fleet-"
        )
        self.compile_cache = compile_cache or os.path.join(
            self.rendezvous_dir, "store"
        )
        self.max_restarts = int(max_restarts)
        self.heartbeat_timeout_s = (
            get_config().heartbeat_timeout_s
            if heartbeat_timeout_s is None else float(heartbeat_timeout_s)
        )
        self.poll_s = float(poll_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.grace_s = float(grace_s)
        self._env = env
        self._inherit_env = inherit_env
        self.run_id = run_id or _context.run_id()
        self._flight_explicit = flight_dir is not None
        self.flight_dir = flight_dir or os.path.join(
            self.rendezvous_dir, "flight"
        )
        self.router = Router(
            fleet_dir=self.rendezvous_dir, run_id=self.run_id,
            config=router_config or RouterConfig(
                heartbeat_timeout_s=self.heartbeat_timeout_s,
            ),
        )
        self._ingress_port = int(ingress_port)
        self._ingress_addr = ingress_addr
        self._ingress = None
        self._procs: Dict[int, subprocess.Popen] = {}
        self._attempts: Dict[int, int] = {}
        #: rank -> monotonic time of the next spawn retry (set when a
        #: respawn failed transiently; the budget was already charged)
        self._respawn_pending: Dict[int, float] = {}
        self._lock = threading.Lock()
        self._stopping = False
        self._watcher: Optional[threading.Thread] = None
        self.restarts = 0
        #: per-rank report of the latest restart's warm state, scraped
        #: from the restarted replica's healthz once it turned running:
        #: {"kernel_builds": n, "xla_compiles": n, ...}
        self.restart_reports: Dict[int, dict] = {}
        self.degraded = False

    # -- lifecycle ----------------------------------------------------------

    @property
    def url(self) -> str:
        if self._ingress is None:
            raise RuntimeError("fleet is not started")
        return (
            f"http://{self._ingress_addr}:{self._ingress.server_address[1]}"
        )

    def pid(self, rank: int) -> Optional[int]:
        """The replica's current pid (chaos drills ``kill -9`` it)."""
        with self._lock:
            p = self._procs.get(rank)
            return None if p is None else p.pid

    def start(self, wait_ready: bool = True) -> "ServingFleet":
        os.makedirs(self.rendezvous_dir, exist_ok=True)
        os.makedirs(self.compile_cache, exist_ok=True)
        _fleet.clear_fleet(self.rendezvous_dir, self.run_id)
        for rank in range(self.num_replicas):
            self._spawn(rank)
        self.router.start()
        self._ingress = self.router.serve(
            port=self._ingress_port, addr=self._ingress_addr
        )
        _flight.record(
            "router.fleet_start", replicas=self.num_replicas,
            rendezvous_dir=self.rendezvous_dir,
            compile_cache=self.compile_cache,
        )
        self._watcher = threading.Thread(
            target=self._watch, daemon=True, name="tfs-serving-fleet"
        )
        self._watcher.start()
        if wait_ready:
            try:
                self.wait_ready()
            except BaseException:
                # readiness failed: the replicas are REAL OS children —
                # raising out of start() (and past __enter__, so
                # __exit__ never runs) must not orphan them serving
                # unsupervised
                self.stop(drain=False)
                raise
        return self

    def wait_ready(self, timeout: Optional[float] = None,
                   count: Optional[int] = None) -> None:
        """Block until ``count`` (default: all) replicas are routable.
        Raises :class:`FleetDegradedError` when the restart budget has
        run out with too few replicas live (waiting longer cannot
        help — nothing will respawn the missing ranks), and
        ``TimeoutError`` when the bound lapses first."""
        timeout = self.ready_timeout_s if timeout is None else timeout
        want = self.num_replicas if count is None else int(count)
        deadline = time.monotonic() + timeout
        while self.router.live_count() < want:
            if self.degraded:
                raise FleetDegradedError(
                    f"restart budget ({self.max_restarts}) exhausted "
                    f"with {self.router.live_count()}/{want} replicas "
                    f"live; status: {self.router.replicas()}"
                )
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {self.router.live_count()}/{want} replicas "
                    f"ready after {timeout:g}s; status: "
                    f"{self.router.replicas()}"
                )
            time.sleep(0.05)

    def _spawn(self, rank: int) -> None:
        attempt = self._attempts.get(rank, -1) + 1
        self._attempts[rank] = attempt
        e = dict(os.environ) if self._inherit_env else {}
        if self._env:
            e.update(self._env)
        e.update(_context.child_env(rank))
        e["TFTPU_RUN_ID"] = self.run_id
        e["TFTPU_FLEET_DIR"] = self.rendezvous_dir
        e["TFTPU_NUM_PROCESSES"] = str(self.num_replicas)
        e["TFTPU_FLEET_ATTEMPT"] = str(attempt)
        e["TFTPU_COMPILE_CACHE"] = self.compile_cache
        if self._flight_explicit:
            e["TFTPU_FLIGHT_DIR"] = self.flight_dir
        else:
            e.setdefault("TFTPU_FLIGHT_DIR", self.flight_dir)
        argv = (
            list(self.cmd(rank)) if callable(self.cmd)
            else list(self.cmd)
        )
        proc = subprocess.Popen(argv, env=e)
        with self._lock:
            self._procs[rank] = proc
        logger.info(
            "serving fleet: replica %d spawned (pid %d, attempt %d)",
            rank, proc.pid, attempt,
        )

    # -- supervision --------------------------------------------------------

    def _watch(self) -> None:
        budget_exhausted_logged = False
        pending_ready: Dict[int, float] = {}  # rank -> restart t0
        while not self._stopping:
            time.sleep(self.poll_s)
            if self._stopping:
                return
            try:
                budget_exhausted_logged = self._watch_once(
                    pending_ready, budget_exhausted_logged
                )
            except Exception as e:
                # one transient failure (a respawn hitting ENOMEM, a
                # user cmd(rank) raising, fs wobble) must not silently
                # END supervision forever — log and keep watching
                logger.error(
                    "serving fleet: supervision scan failed "
                    "(continuing): %s", e,
                )

    def _watch_once(self, pending_ready: Dict[int, float],
                    budget_exhausted_logged: bool) -> bool:
        """One supervision scan: reap exits, judge heartbeats, record
        restarted replicas' warm reports. Returns the updated
        budget-exhausted-logged flag."""
        # 0) spawn retries from a transiently-failed respawn (the
        # budget for that death is already charged — never again here)
        now_mono = time.monotonic()
        for rank, due in list(self._respawn_pending.items()):
            if now_mono < due:
                continue
            try:
                self._spawn(rank)
                del self._respawn_pending[rank]
            except Exception as e:
                self._respawn_pending[rank] = time.monotonic() + 2.0
                logger.error(
                    "serving fleet: respawn retry of replica %d failed "
                    "(%s) — backing off", rank, e,
                )
        with self._lock:
            procs = dict(self._procs)
        # 1) process exits
        for rank, p in procs.items():
            rc = p.poll()
            if rc is None or self._stopping:
                continue
            self._on_death(
                rank,
                reason=(
                    f"exited rc={rc}" if rc >= 0
                    else f"killed by signal {-rc}"
                ),
                clean=(rc == 0),
                pending_ready=pending_ready,
            )
        # 2) heartbeat staleness (wedged-but-alive replicas)
        try:
            beats = _fleet.read_heartbeats(
                self.rendezvous_dir, self.run_id
            )
        except OSError:  # pragma: no cover - transient fs wobble
            beats = {}
        now = time.time()
        for rank, rec in beats.items():
            with self._lock:
                p = self._procs.get(rank)
            if p is None or p.poll() is not None or rec.get("stopped"):
                continue
            if rec.get("pid") != p.pid:
                # a PREVIOUS incarnation's beat still on disk: the
                # respawned replica has not published yet (still
                # importing torch) — judging the stale beat against
                # the new process would kill every restart of a
                # heartbeat-detected death in an endless loop
                continue
            age = now - float(rec.get("ts", now))
            if age > self.heartbeat_timeout_s:
                logger.error(
                    "serving fleet: replica %d heartbeat stale "
                    "%.2fs — killing", rank, age,
                )
                try:
                    p.kill()
                    p.wait(timeout=10)
                except Exception:  # pragma: no cover - best effort
                    pass
                self._on_death(
                    rank,
                    reason=f"heartbeat stale {age:.2f}s",
                    clean=False, pending_ready=pending_ready,
                )
        # 3) restarted replicas turning ready: record the warm
        # report (the evidence that a restart builds nothing)
        for rank, t_restart in list(pending_ready.items()):
            snap = self.router.replicas().get(rank)
            if snap and snap["state"] == "running" \
                    and snap["attempt"] == self._attempts.get(rank):
                pending_ready.pop(rank)
                report = {
                    "recovery_s": round(
                        time.monotonic() - t_restart, 3
                    ),
                    "attempt": snap["attempt"],
                    **snap.get("process", {}),
                }
                self.restart_reports[rank] = report
                _flight.record(
                    "router.replica_restarted", rank=rank, **report
                )
                if (report.get("kernel_builds", 0) or 0) > 0:
                    # the shared-build contract broke: a restarted
                    # replica should load the library its fleet built
                    logger.warning(
                        "serving fleet: restarted replica %d ran %d "
                        "kernel library builds (the shared build under "
                        "build/torch_kernels should have made this 0)",
                        rank, report["kernel_builds"],
                    )
        if self.degraded and not budget_exhausted_logged:
            budget_exhausted_logged = True
            logger.error(
                "serving fleet: restart budget exhausted — "
                "continuing degraded on survivors"
            )
        return budget_exhausted_logged

    def _on_death(self, rank: int, *, reason: str, clean: bool,
                  pending_ready: Dict[int, float]) -> None:
        """One replica died: cut it from routing NOW, then respawn it
        (crash restarts draw from the budget; clean exits — a drained
        replica, the rolling-restart flow — respawn for free)."""
        if self._stopping:
            # a watcher iteration that outlived stop()'s bounded join
            # must not spawn an orphan replica into a torn-down fleet
            return
        self.router.mark_dead(rank, reason)
        _fleet.DEAD_RANKS.inc()
        _flight.record(
            "router.replica_exit", rank=rank, reason=reason, clean=clean,
        )
        logger.warning(
            "serving fleet: replica %d down (%s)%s", rank, reason,
            " [clean]" if clean else "",
        )
        if clean:
            # a clean exit only earns the budget-free respawn when
            # this incarnation actually REACHED readiness (the router
            # saw it running) — the rolling-restart flow. A cmd that
            # exits 0 without ever serving is crash-looping in
            # disguise and would otherwise respawn ~1/poll_s forever,
            # budget-free. Readiness, not wall-clock: a drain right
            # after a fast startup is still a legitimate clean retire.
            snap = self.router.replicas().get(rank)
            served = bool(
                snap
                and snap.get("attempt") == self._attempts.get(rank)
                and snap.get("ever_running")
            )
            if not served:
                logger.warning(
                    "serving fleet: replica %d exited clean without "
                    "ever becoming ready — charging the restart budget",
                    rank,
                )
                clean = False
        with self._lock:
            # the death is accounted NOW: leaving the dead Popen in
            # _procs would re-detect the same exit on every poll and
            # (if _spawn below fails transiently) re-charge the budget
            # for one death until it was exhausted
            self._procs.pop(rank, None)
        if not clean:
            if self.restarts >= self.max_restarts:
                self.degraded = True
                return
            self.restarts += 1
            m.ROUTER_REPLICA_RESTARTS.inc()
        pending_ready[rank] = time.monotonic()
        try:
            self._spawn(rank)
        except Exception as e:
            # transient fork failure (ENOMEM/EAGAIN, a user cmd(rank)
            # hiccup): the budget is already charged for THIS death —
            # retry the spawn with backoff instead of losing the rank
            logger.error(
                "serving fleet: respawn of replica %d failed (%s) — "
                "will retry", rank, e,
            )
            self._respawn_pending[rank] = time.monotonic() + 1.0

    # -- shutdown -----------------------------------------------------------

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Retire the fleet: drain every replica over HTTP (graceful —
        queued work completes), wait for clean exits, escalate SIGTERM
        → SIGKILL for stragglers, then stop the router and ingress."""
        self._stopping = True
        if self._watcher is not None:
            self._watcher.join(timeout=self.poll_s * 4 + 2.0)
            self._watcher = None
        bound = self.grace_s if timeout is None else timeout
        with self._lock:
            procs = dict(self._procs)
        if drain:
            cards = read_cards(self.rendezvous_dir, self.run_id)
            # drain CONCURRENTLY: the POSTs are independent, and a
            # wedged sidecar must cost one 2s timeout total, not 2s
            # per wedged replica serialized into every stop()
            drainers = [
                threading.Thread(
                    target=http_json,
                    args=(card_addr(card), "POST", "/admin/drain",
                          {}, 2.0),
                    daemon=True, name=f"tfs-fleet-drain-{rank}",
                )
                for rank, p in procs.items()
                if p.poll() is None
                and (card := cards.get(rank)) is not None
            ]
            for t in drainers:
                t.start()
            for t in drainers:
                t.join(timeout=2.5)
        deadline = time.monotonic() + bound
        while time.monotonic() < deadline and any(
            p.poll() is None for p in procs.values()
        ):
            time.sleep(0.02)
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and any(
            p.poll() is None for p in procs.values()
        ):
            time.sleep(0.02)
        for p in procs.values():
            if p.poll() is None:  # pragma: no cover - wedged in IO
                p.kill()
        exit_codes = {r: p.wait() for r, p in procs.items()}
        self.router.stop()  # also shuts the ingress httpd down
        self._ingress = None
        _flight.record(
            "router.fleet_stop", exit_codes=exit_codes,
            restarts=self.restarts,
        )
        logger.info(
            "serving fleet stopped (restarts=%d, exits=%s)",
            self.restarts, exit_codes,
        )

    def kill_replica(self, rank: int,
                     sig: int = signal.SIGKILL) -> Optional[int]:
        """Chaos helper: signal one replica (default ``kill -9``) —
        the supervision loop detects, reroutes, and restarts it.
        Returns the killed pid (None when the rank is not running)."""
        with self._lock:
            p = self._procs.get(rank)
        if p is None or p.poll() is not None:
            return None
        pid = p.pid
        os.kill(pid, sig)
        return pid

    def status(self) -> dict:
        return {
            "replicas": self.router.replicas(),
            "live": self.router.live_count(),
            "restarts": self.restarts,
            "degraded": self.degraded,
            "restart_reports": dict(self.restart_reports),
            "router": self.router.counters(),
        }

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)
