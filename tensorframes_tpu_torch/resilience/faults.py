"""Deterministic, seedable fault injection.

Production code paths declare **named sites** by calling
:func:`fault_point` — a no-op (one falsy dict check, no lock) unless a
test or drill has armed an injection for that site with :func:`inject`::

    from tensorframes_tpu_torch.resilience import faults

    with faults.inject("checkpoint.save", OSError("disk wobble"), every_n=2):
        ckpt.save(10, state)   # every 2nd save attempt raises OSError

Injections fire **deterministically** (``every_n`` / ``after`` /
``max_times`` counters) or **probabilistically but reproducibly** (``p=``
with a seeded PRNG), so a drill that exposed a bug replays bit for bit.
The registry is process-global and thread-safe: prefetch workers, retry
watchdogs and the training loop's thread all hit the same counters.

Two more site flavours: :func:`delay_point` sites catch an injected
:class:`Delay` and sleep (an operation that hangs instead of failing);
:func:`kill_point` sites catch an injected :class:`KillRank` and
``SIGKILL`` their own process — the deterministic stand-in for a
preempted rank.

Sites are **registered** (:func:`register_site` / :func:`list_sites`) by
the module that instruments them, with the reference package's names and
descriptions, so the catalog and ``docs/resilience.md`` never drift. Only
the sites this package instruments are registered.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple, Union

from ..observability import flight as _flight
from ..observability.metrics import counter as _counter
from ..utils import get_logger

logger = get_logger(__name__)

_INJECTIONS_FIRED = _counter(
    "tftpu_fault_injections_fired_total",
    "Armed fault injections that actually raised at a fault_point",
)

#: The core site names instrumented across the package (the full live
#: catalog, with the sites other modules register, is :func:`list_sites`).
SITES: Tuple[str, ...] = (
    "executor.run_block",
    "executor.run_rows",
    "io.prefetch.device_put",
    "io.save_frame",
    "io.load_frame",
    "checkpoint.save",
    "checkpoint.restore",
)

ErrorSpec = Union[BaseException, type]


class Delay(Exception):
    """Injectable stall: a :func:`delay_point` site catches it and sleeps
    ``seconds`` instead of raising. At a plain :func:`fault_point` it
    propagates like any other injected error."""

    def __init__(self, seconds: float):
        super().__init__(f"injected delay of {seconds:g}s")
        self.seconds = float(seconds)


class KillRank(BaseException):
    """Injectable preemption: a :func:`kill_point` site catches it and
    ``SIGKILL``s its own process — no exception path, no atexit.
    ``BaseException`` so a stray ``except Exception`` between the site and
    the drill cannot absorb a scheduled kill."""

    def __init__(self, message: str = "injected kill-rank fault"):
        super().__init__(message)


class Injection:
    """One armed fault: bookkeeping for when it fires. ``hits`` counts
    every time the site was reached while armed; ``fired`` the times it
    raised."""

    def __init__(self, site: str, error: ErrorSpec, every_n: int = 1, after: int = 0,
                 max_times: Optional[int] = None, p: Optional[float] = None, seed: int = 0):
        if every_n < 1:
            raise ValueError(f"every_n must be >= 1, got {every_n}")
        if p is not None and not (0.0 <= p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.site = site
        self.error = error
        self.every_n = every_n
        self.after = after
        self.max_times = max_times
        self.p = p
        self._rng = random.Random(seed)
        self.hits = 0
        self.fired = 0

    def _should_fire(self) -> bool:
        # caller holds the registry lock
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.max_times is not None and self.fired >= self.max_times:
            return False
        if self.p is not None:
            fire = self._rng.random() < self.p
        else:
            fire = (self.hits - self.after) % self.every_n == 0
        if fire:
            self.fired += 1
        return fire

    def make_error(self) -> BaseException:
        err = self.error
        if isinstance(err, BaseException):
            return err
        return err(f"injected fault at {self.site!r}")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Injection({self.site!r}, {self.error!r}, every_n={self.every_n}, "
                f"hits={self.hits}, fired={self.fired})")


_lock = threading.Lock()
_registry: Dict[str, List[Injection]] = {}
_sites: Dict[str, str] = {}


def register_site(name: str, where: str) -> None:
    """Declare a fault site in the catalog (idempotent; re-registering
    with a different description updates it)."""
    if not name:
        raise ValueError("site name must be non-empty")
    with _lock:
        _sites[name] = where


def list_sites() -> Dict[str, str]:
    """The registered site catalog, ``{site name: where it is
    instrumented}``, sorted by name."""
    with _lock:
        return dict(sorted(_sites.items()))


_CORE_SITE_DOCS: Dict[str, str] = {
    "executor.run_block": "CompiledProgram.run_block (block execution)",
    "executor.run_rows": "CompiledProgram.run_rows (vmapped execution)",
    "io.prefetch.device_put": "prefetch_to_device worker (host→HBM transfer)",
    "io.save_frame": "io.save_frame (frame persistence write)",
    "io.load_frame": "io.load_frame (frame persistence read)",
    "checkpoint.save": "Checkpointer.save (inside the retry scope)",
    "checkpoint.restore": "Checkpointer restore of one step directory",
}
for _name, _where in _CORE_SITE_DOCS.items():
    register_site(_name, _where)


def fault_point(site: str) -> None:
    """Instrumentation hook: raise if an armed injection elects to fire.
    The un-armed fast path is one truthiness check on a module dict."""
    if not _registry:
        return
    with _lock:
        injections = _registry.get(site)
        if not injections:
            return
        err = None
        for inj in injections:
            if inj._should_fire():
                err = inj.make_error()
                break
    if err is not None:
        _INJECTIONS_FIRED.inc()
        _flight.record("fault.injected", site=site, error=type(err).__name__, message=str(err))
        logger.debug("fault_point(%s): raising injected %r", site, err)
        raise err


def delay_point(site: str) -> None:
    """A fault site with stall semantics: an injected :class:`Delay`
    makes this call sleep in place (the operation hangs, it does not
    fail). Any other injected error propagates like :func:`fault_point`."""
    try:
        fault_point(site)
    except Delay as d:
        _flight.record("fault.delayed", site=site, seconds=d.seconds)
        logger.debug("delay_point(%s): sleeping injected %.3gs", site, d.seconds)
        time.sleep(d.seconds)


def kill_point(site: str = "fleet.rank.kill") -> None:
    """A fault site with preemption semantics: an injected
    :class:`KillRank` makes this process ``SIGKILL`` itself (the
    line-flushed flight spool survives as the black box). Any other
    injected error propagates like :func:`fault_point`."""
    try:
        fault_point(site)
    except KillRank:
        _flight.record("fault.kill_rank", site=site, pid=os.getpid())
        logger.warning("kill_point(%s): SIGKILLing own process (pid %d)", site, os.getpid())
        os.kill(os.getpid(), signal.SIGKILL)


register_site(
    "fleet.rank.kill",
    "kill_point default site: training.run_resumable loop edge (any "
    "enrolled rank can be deterministically preempted mid-run)",
)

# Serving-fleet chaos sites, registered here and not at the modules they
# instrument: a drill that arms them sees them in the catalog even in a
# process that never imports the serving package.
register_site(
    "router.dispatch",
    "serving/router.py Router.dispatch, before each router→replica "
    "attempt — an injected Delay stalls the proxied dispatch (deadline-"
    "expiry chaos at the ingress); any other injected error fails the "
    "attempt exactly like a dead replica socket, driving the redrive "
    "path deterministically",
)
register_site(
    "serving.replica",
    "serving/replica.py serve_replica main loop — an injected KillRank "
    "SIGKILLs the replica process (the serving-fleet kill-replica "
    "chaos: the fleet must reroute, redrive, and restart it); other "
    "injected errors crash the loop into the nonzero-exit path",
)


@contextmanager
def inject(site: str, error: ErrorSpec = RuntimeError, every_n: int = 1, after: int = 0,
           max_times: Optional[int] = None, p: Optional[float] = None,
           seed: int = 0) -> Iterator[Injection]:
    """Arm a fault at ``site`` for the duration of the ``with`` block.

    ``error`` is an exception instance (raised as it is, the same object
    every firing) or class (instantiated per firing). Deterministic
    schedule: skip the first ``after`` hits, then fire every
    ``every_n``-th hit, at most ``max_times`` times. Alternatively
    ``p=``/``seed=`` fires with probability ``p`` from a dedicated seeded
    PRNG. Yields the :class:`Injection` for hit/fire assertions."""
    inj = Injection(site, error, every_n=every_n, after=after, max_times=max_times, p=p,
                    seed=seed)
    with _lock:
        _registry.setdefault(site, []).append(inj)
    try:
        yield inj
    finally:
        with _lock:
            lst = _registry.get(site, [])
            if inj in lst:
                lst.remove(inj)
            if not lst:
                _registry.pop(site, None)


def active_sites() -> Tuple[str, ...]:
    """Site names with at least one armed injection."""
    with _lock:
        return tuple(sorted(_registry))


def reset() -> None:
    """Disarm everything (test hygiene after a failed drill)."""
    with _lock:
        _registry.clear()
