"""Training-step guards: detect non-finite losses and states, and recover.

A diverged step does not crash — it silently poisons every parameter
with NaN. :class:`StepGuard` is the host-side tripwire, as in the
reference package: after each ``step_fn`` the training loop hands it the
candidate state and metrics, and it either admits the update, **skips**
it (back to the pre-step state), **rolls back** to the last admitted
snapshot, or **raises** :class:`NonFiniteError`.
``training.run_resumable(guard=...)`` and ``train_on_frame(guard=...)``
wire it in; pass a policy string (``"skip"`` / ``"rollback"`` /
``"raise"``) or a configured instance.

The port's train step updates its tensors in place, so by the time the
guard sees a NaN the pre-step state is gone unless it was copied. The
guard keeps that copy itself (:func:`..utils.tree.snapshot`, on the
state's devices): :meth:`StepGuard.seed` takes the first, each admitted
step refreshes it in place (under ``"rollback"`` every
``snapshot_every``-th), and a tripped step writes it back into the live
tensors and the optimizer's state (:func:`..utils.tree.assign`) before
it skips, rolls back or raises — so a raise leaves the last admitted
state in place, and an emergency checkpoint taken then is finite.
Without a seed (a bare :meth:`StepGuard.admit` call), ``"skip"`` returns
``prev_state`` as the reference does.

:func:`tree_all_finite` reduces each floating leaf on its own device
(``torch._foreach_norm`` with ``ord=inf`` over the leaves of a device,
then one ``isfinite``) and waits for the device once per call: the state
never travels to the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability import flight as _flight
from ..observability.metrics import counter as _counter
from ..utils import get_logger
from ..utils import tree as _tree

logger = get_logger(__name__)

_POLICIES = ("raise", "skip", "rollback")
_CHECKS = ("metrics", "state", "both")

# One trip counter per policy, pre-registered so the exposition always
# carries all three series.
_TRIP_COUNTERS = {
    p: _counter(
        "tftpu_guard_trips_total",
        "Non-finite training steps caught by StepGuard, by policy",
        labels={"policy": p},
    )
    for p in _POLICIES
}


class NonFiniteError(FloatingPointError):
    """A training step produced NaN/Inf and the guard policy is to stop."""


def _host_finite(x) -> bool:
    if isinstance(x, float):
        return math.isfinite(x)
    if isinstance(x, (bool, int, str, bytes)) or x is None:
        return True
    try:
        arr = np.asarray(x)
    except (TypeError, ValueError):
        return True  # a genuinely non-array leaf (e.g. a string metric)
    if arr.dtype == object:
        return True
    if arr.dtype.kind in "fc":
        return bool(np.isfinite(arr).all())
    if arr.dtype.kind == "V":  # ml_dtypes (bfloat16, float8…)
        return bool(np.isfinite(arr.astype(np.float32)).all())
    return True  # ints/bools vacuously finite


def tree_all_finite(tree: Any) -> bool:
    """True when every floating/complex leaf of ``tree`` is finite.

    Integer, bool and non-array leaves pass vacuously; an optimizer's
    moments count as leaves. Tensors are reduced on their own device —
    the largest |x| of each leaf by ``torch._foreach_norm(ord=inf)`` (NaN
    propagates through it) over the leaves of one device and dtype, then
    one ``isfinite().all()`` per device — and the call waits for each
    device once. Host leaves (numpy arrays, Python floats) are checked
    on the host."""
    groups: Dict[Tuple[torch.device, torch.dtype], List[torch.Tensor]] = {}
    for leaf in _tree.leaves(tree):
        if torch.is_tensor(leaf):
            if (leaf.is_floating_point() or leaf.is_complex()) and leaf.numel():
                groups.setdefault((leaf.device, leaf.dtype), []).append(leaf.detach())
        elif not _host_finite(leaf):
            return False
    flags: Dict[torch.device, List[torch.Tensor]] = {}
    with torch.no_grad():
        for (device, _), leaves in groups.items():
            norms = torch.stack(torch._foreach_norm(leaves, ord=math.inf))
            flags.setdefault(device, []).append(torch.isfinite(norms).all())
        return all(bool(torch.stack(f).all()) for f in flags.values())


class StepGuard:
    """Admission control for training-step updates.

    ``policy``:

    * ``"raise"`` — any non-finite step raises :class:`NonFiniteError`,
      with the last admitted state written back first.
    * ``"skip"`` — discard the bad update (the pre-step state is written
      back: parameters, moments and step counts) and keep consuming
      batches.
    * ``"rollback"`` — revert to the last admitted snapshot. With
      ``snapshot_every > 1`` it may trail by up to that many steps.

    ``max_consecutive`` bad steps escalate to :class:`NonFiniteError`
    under every policy. ``check`` selects what is inspected
    (``"metrics"``, ``"state"`` or ``"both"``); ``every_n`` inspects only
    every n-th step. An unchecked step is admitted unseen; under
    ``"skip"`` and ``"raise"`` it still refreshes the device copy, so a
    trip lands on the state just before the bad step (the reference's
    ``prev_state``), while ``"rollback"`` goes back to its last checked
    snapshot. The counters (``admitted``, ``skipped``, ``rollbacks``)
    are public.
    """

    def __init__(self, policy: str = "rollback", check: str = "both", max_consecutive: int = 10,
                 snapshot_every: int = 1, every_n: int = 1):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
        if check not in _CHECKS:
            raise ValueError(f"check must be one of {_CHECKS}, got {check!r}")
        if max_consecutive < 1:
            raise ValueError("max_consecutive must be >= 1")
        if snapshot_every < 1 or every_n < 1:
            raise ValueError("snapshot_every and every_n must be >= 1")
        self.policy = policy
        self.check = check
        self.max_consecutive = max_consecutive
        self.snapshot_every = snapshot_every
        self.every_n = every_n
        self.admitted = 0
        self.skipped = 0
        self.rollbacks = 0
        self._bad_streak = 0
        self._good_state: Any = None
        self._good_step: Optional[int] = None

    @classmethod
    def coerce(cls, guard) -> "StepGuard":
        """``"skip"`` → ``StepGuard(policy="skip")``; instances pass through."""
        if isinstance(guard, cls):
            return guard
        if isinstance(guard, str):
            return cls(policy=guard)
        raise TypeError(f"guard must be a StepGuard or policy string {_POLICIES}, "
                        f"got {type(guard).__name__}")

    def seed(self, step: int, state: Any) -> None:
        """Snapshot a known-good baseline (the initial or restored state),
        so the first tripped step has somewhere to land."""
        self._good_state = _tree.snapshot(state, into=self._good_state)
        self._good_step = step

    def _is_bad(self, state: Any, metrics: Any) -> bool:
        inspected = {"metrics": metrics, "state": state, "both": (metrics, state)}[self.check]
        return not tree_all_finite(inspected)  # one wait for the device

    def _restore(self, live: Any, fallback: Any) -> Any:
        if self._good_state is None:
            return fallback
        return _tree.assign(live, self._good_state)

    def admit(self, step: int, new_state: Any, metrics: Any, prev_state: Any) -> Tuple[Any, bool]:
        """Inspect the candidate update for step ``step``.

        Returns ``(state_to_continue_with, admitted)``. Raises
        :class:`NonFiniteError` under ``"raise"`` or after
        ``max_consecutive`` bad steps, in both cases with the last
        admitted snapshot written back into ``new_state`` first."""
        if self.every_n > 1 and step % self.every_n != 0:
            self.admitted += 1
            if self.policy != "rollback":
                # skip and raise land on the state just before the bad
                # step, as the reference's prev_state: refresh the copy
                # even where the check is saved
                self.seed(step, new_state)
            return new_state, True
        if not self._is_bad(new_state, metrics):
            self.admitted += 1
            self._bad_streak = 0
            if self.policy != "rollback" or step % self.snapshot_every == 0:
                self.seed(step, new_state)
            return new_state, True

        self._bad_streak += 1
        _TRIP_COUNTERS[self.policy].inc()
        _flight.record("guard.trip", policy=self.policy, step=step, streak=self._bad_streak,
                       max_consecutive=self.max_consecutive)
        if self.policy == "raise" or self._bad_streak >= self.max_consecutive:
            self._restore(new_state, prev_state)
            err = NonFiniteError(
                f"non-finite loss/state at step {step} "
                f"({self._bad_streak} consecutive; policy={self.policy!r})")
            # guard-raise is a flight dump trigger: the black box carries
            # the steps that led into divergence even if the caller
            # catches the error
            _flight.dump(reason="guard-raise", exc=err)
            raise err
        if self.policy == "skip":
            self.skipped += 1
            logger.warning("StepGuard: non-finite step %d skipped (streak %d/%d)",
                           step, self._bad_streak, self.max_consecutive)
            return self._restore(new_state, prev_state), False
        self.rollbacks += 1
        logger.warning("StepGuard: non-finite step %d rolled back to step %s (streak %d/%d)",
                       step, self._good_step, self._bad_streak, self.max_consecutive)
        return self._restore(new_state, prev_state), False
