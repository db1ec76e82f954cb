"""Resilience: fault injection, retry policies, step guards.

The reference package's ``resilience/`` in its single-process subset:

* :mod:`.faults` — a deterministic, seedable fault-injection registry.
  Production code is instrumented with named ``fault_point(site)`` hooks
  (executor block and row dispatch, prefetch host → device copies,
  checkpoint save/restore) and the ``kill_point`` at
  ``run_resumable``'s loop edge; tests and drills arm them with the
  ``inject()`` context manager. Zero overhead when nothing is armed.
* :mod:`.retry` — retry policies (attempts, exponential backoff with
  deterministic jitter, per-attempt watchdog, total deadline,
  retryable-exception classification) for host-side IO and transfers.
* :mod:`.guards` — training-step guards that detect non-finite losses or
  states and skip the step, roll back to the last good state, or raise;
  plugged into ``training.run_resumable(guard=...)``.

* :mod:`.fleet` — the file-based fleet rendezvous: heartbeats
  (:class:`Heartbeater`), :func:`fleet_status`, the coordinated-abort
  signal, and the atomic records the serving fleet's replica cards share;
  and its deadline half: :func:`run_with_deadline` (the hung-collective
  watchdog) and the file :func:`barrier`, with the fleet error classes.

``FleetMonitor``, ``enroll`` and ``supervise()`` come with the
model-parallel slice. Checkpoint integrity lives in
:mod:`tensorframes_tpu_torch.checkpoint`.
"""

from __future__ import annotations

from .faults import (  # noqa: F401
    SITES,
    Delay,
    KillRank,
    active_sites,
    delay_point,
    fault_point,
    inject,
    kill_point,
    list_sites,
    register_site,
    reset,
)
from .fleet import (  # noqa: F401
    CoordinatedAbortError,
    DeadRankError,
    FleetError,
    FleetStatus,
    HungDispatchError,
    barrier,
    dispatch_deadline_s,
    run_with_deadline,
    Heartbeater,
    abort_requested,
    clear_fleet,
    fleet_status,
    read_heartbeats,
    rendezvous_dir,
    signal_abort,
    write_beat,
)
from .guards import NonFiniteError, StepGuard, tree_all_finite  # noqa: F401
from .retry import (  # noqa: F401
    AttemptTimeout,
    RetryError,
    RetryPolicy,
    retry_call,
    retryable,
)

__all__ = [
    "SITES",
    "active_sites",
    "fault_point",
    "delay_point",
    "kill_point",
    "inject",
    "reset",
    "Delay",
    "KillRank",
    "list_sites",
    "register_site",
    "AttemptTimeout",
    "RetryError",
    "RetryPolicy",
    "retry_call",
    "retryable",
    "NonFiniteError",
    "StepGuard",
    "tree_all_finite",
    "FleetStatus",
    "Heartbeater",
    "rendezvous_dir",
    "write_beat",
    "read_heartbeats",
    "fleet_status",
    "signal_abort",
    "abort_requested",
    "clear_fleet",
]
