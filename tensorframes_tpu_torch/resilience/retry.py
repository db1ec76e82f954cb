"""Retry policies for host-side IO and host → device transfer paths.

:class:`RetryPolicy` is a small value object — attempt budget,
exponential backoff with deterministic jitter, an optional per-attempt
watchdog timeout, a total deadline, and a retryable-exception
classification — and :func:`retry_call` / :func:`retryable` apply it to
any callable, as in the reference package.

The watchdog runs the attempt on a daemon worker thread and abandons it
when its window passes (Python cannot safely interrupt an arbitrary
blocked call); the abandoned attempt may still complete in the
background, so only **idempotent** operations belong under a timeout —
the checkpoint writes and transfers this package wires it into.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from functools import wraps
from typing import Callable, Optional, Tuple, Type

from ..observability import flight as _flight
from ..observability.metrics import counter as _counter
from ..utils import get_logger

logger = get_logger(__name__)

_RETRY_ATTEMPTS = _counter(
    "tftpu_retry_attempts_total",
    "Failed attempts that were backed off and rescheduled",
)
_RETRY_EXHAUSTIONS = _counter(
    "tftpu_retry_exhaustions_total",
    "retry_call budgets exhausted (RetryError raised)",
)
_RETRY_BACKOFF_SECONDS = _counter(
    "tftpu_retry_backoff_seconds_total",
    "Total backoff sleep injected between retry attempts",
)


class AttemptTimeout(TimeoutError):
    """A single attempt exceeded the policy's per-attempt timeout."""


class RetryError(RuntimeError):
    """All attempts exhausted; ``__cause__`` is the last failure."""


#: Exceptions that are transient by default: filesystem/network wobble
#: and watchdog timeouts. Everything else is a real bug and propagates on
#: the first attempt.
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (OSError, ConnectionError, TimeoutError)


@dataclass(frozen=True)
class RetryPolicy:
    """How to retry a transient failure.

    ``backoff`` is the first sleep; attempt *k* sleeps ``min(backoff *
    2**(k-1), backoff_max) * (1 + U[0, jitter))``. With ``seed=None`` the
    jitter PRNG seeds from OS entropy per call, so workers sharing one
    policy back off decorrelated; pass ``seed`` for deterministic drills.
    ``timeout`` (seconds) arms the per-attempt watchdog. ``deadline_s``
    caps the total elapsed wall-clock of one ``retry_call`` — attempts,
    sleeps and watchdog waits included; the running attempt's window and
    every sleep are clipped to what remains of it.
    """

    max_attempts: int = 3
    backoff: float = 0.05
    backoff_max: float = 2.0
    jitter: float = 0.25
    timeout: Optional[float] = None
    retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE
    seed: Optional[int] = None
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff < 0 or self.backoff_max < 0 or self.jitter < 0:
            raise ValueError("backoff, backoff_max and jitter must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")

    def delay(self, attempt: int, rng) -> float:
        """Sleep before retry number ``attempt`` (1-based)."""
        base = min(self.backoff * (2.0 ** (attempt - 1)), self.backoff_max)
        return base * (1.0 + rng.random() * self.jitter)

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable)


class WatchdogExpired(Exception):
    """:func:`run_abandonable`'s call outlived its window. Not a
    ``TimeoutError``, so it is never confused with a timeout the wrapped
    function itself raised."""


def run_abandonable(fn: Callable, args, kwargs, timeout: float,
                    thread_name: str = "tftorch-watchdog-attempt"):
    """Run ``fn(*args, **kwargs)`` on a daemon thread, waiting at most
    ``timeout`` seconds. On expiry raises :class:`WatchdogExpired`; the
    attempt keeps running on its thread. The wrapped function's own
    exceptions re-raise on the caller thread unchanged."""
    outcome: dict = {}
    done = threading.Event()

    def attempt():
        try:
            outcome["value"] = fn(*args, **kwargs)
        except BaseException as e:  # re-raised on the caller thread
            outcome["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=attempt, daemon=True, name=thread_name)
    t.start()
    if not done.wait(timeout):
        raise WatchdogExpired(timeout)
    if "error" in outcome:
        raise outcome["error"]
    return outcome["value"]


def _run_with_watchdog(fn: Callable, args, kwargs, timeout: float):
    try:
        return run_abandonable(fn, args, kwargs, timeout, thread_name="tftorch-retry-attempt")
    except WatchdogExpired:
        raise AttemptTimeout(f"attempt still running after {timeout:.3g}s (abandoned)") from None


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               describe: Optional[str] = None,
               on_retry: Optional[Callable[[int, BaseException], None]] = None, **kwargs):
    """Call ``fn(*args, **kwargs)`` under ``policy``.

    ``policy=None`` means **no retries** — a plain call — so call sites
    thread an optional policy straight through. Retryable failures are
    logged, backed off and re-attempted; others propagate at once. When
    the budget runs out, :class:`RetryError` raises ``from`` the last
    failure. ``on_retry(attempt, exc)`` observes each scheduled retry."""
    if policy is None:
        return fn(*args, **kwargs)
    rng = random.Random(policy.seed)
    name = describe or getattr(fn, "__qualname__", repr(fn))
    t_start = time.monotonic()

    def remaining() -> Optional[float]:
        if policy.deadline_s is None:
            return None
        return policy.deadline_s - (time.monotonic() - t_start)

    last: Optional[BaseException] = None
    deadline_hit = False
    for attempt in range(1, policy.max_attempts + 1):
        try:
            rem = remaining()
            if rem is not None and rem <= 0:
                deadline_hit = True
                break
            window = policy.timeout
            if rem is not None:
                window = rem if window is None else min(window, rem)
            if window is not None:
                return _run_with_watchdog(fn, args, kwargs, window)
            return fn(*args, **kwargs)
        except BaseException as e:
            if not policy.is_retryable(e):
                raise
            last = e
            if attempt == policy.max_attempts:
                break
            rem = remaining()
            if rem is not None and rem <= 0:
                deadline_hit = True
                break
            delay = policy.delay(attempt, rng)
            if rem is not None:
                delay = min(delay, rem)
            _RETRY_ATTEMPTS.inc()
            _RETRY_BACKOFF_SECONDS.inc(delay)
            _flight.record("retry", site=name, attempt=attempt, max_attempts=policy.max_attempts,
                           error=type(e).__name__, message=str(e), backoff_s=round(delay, 4))
            logger.warning("retry %s: attempt %d/%d failed (%s: %s); retrying in %.3fs",
                           name, attempt, policy.max_attempts, type(e).__name__, e, delay)
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                time.sleep(delay)
    deadline_hit = deadline_hit or (
        policy.deadline_s is not None and time.monotonic() - t_start >= policy.deadline_s)
    _RETRY_EXHAUSTIONS.inc()
    _flight.record("retry.exhausted", site=name, max_attempts=policy.max_attempts,
                   deadline_s=policy.deadline_s if deadline_hit else None,
                   error=type(last).__name__ if last else None,
                   message=str(last) if last else None)
    if deadline_hit:
        raise RetryError(
            f"{name}: deadline_s={policy.deadline_s:g} exceeded after "
            f"{time.monotonic() - t_start:.2f}s (gave up at attempt "
            f"{attempt}/{policy.max_attempts})"
        ) from last
    raise RetryError(f"{name}: all {policy.max_attempts} attempts failed") from last


def retryable(policy: Optional[RetryPolicy] = None, **policy_kwargs):
    """Decorator form: ``@retryable(max_attempts=5)`` or
    ``@retryable(policy)``. The wrapped function keeps its signature."""
    if policy is not None and policy_kwargs:
        raise ValueError("pass either a RetryPolicy or keyword fields, not both")
    pol = policy or RetryPolicy(**policy_kwargs)

    def deco(fn: Callable) -> Callable:
        @wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, policy=pol, **kwargs)

        wrapped.retry_policy = pol  # type: ignore[attr-defined]
        return wrapped

    return deco
