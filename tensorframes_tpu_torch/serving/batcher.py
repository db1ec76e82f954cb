"""Admission queue of a serving endpoint: bounded, deadline-aware, FIFO.

The reference package's continuous batcher, in the pull mode the decode
engine uses: no worker thread, the engine drains the queue itself with
:meth:`ContinuousBatcher.poll` and pushes preempted work back with
:meth:`ContinuousBatcher.requeue_front`. The push mode that coalesces
flush endpoints' rows waits with ``Server.register`` (ROADMAP queue 1).

* admission is **bounded**: past ``max_queue_rows`` an offer raises
  :class:`RejectedError` (``reason=queue_full``) instead of queueing;
* per-request **deadlines** are total elapsed wall-clock from submit; a
  dedicated expirer thread fails a request whose deadline lapses while
  it waits, so a full KV pool cannot hold a request past it;
* **drain** keeps queued requests for the consumer to finish; closing
  without drain fails them with :class:`ServingError`.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..observability.metrics import Histogram
from . import metrics as m


class ServingError(RuntimeError):
    """Base class of serving-layer failures."""


class RejectedError(ServingError):
    """Admission refused (backpressure / closed / oversized request).
    ``reason`` is one of :data:`metrics.REJECT_REASONS`."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


class DeadlineExceededError(ServingError, TimeoutError):
    """The request's deadline passed before it was served."""


class ResultFuture:
    """Handle to one request's eventual result: ``result(timeout)`` blocks
    for the output dict or raises the request's failure. A decode
    request's ``ttft_s`` is the time from submit to its first token, set
    when that token exists (``None`` before, and for other requests)."""

    __slots__ = ("_done", "_value", "_exc", "rows", "endpoint", "ttft_s")

    def __init__(self, endpoint: str, rows: int):
        self._done = threading.Event()
        self._value: Optional[Dict[str, np.ndarray]] = None
        self._exc: Optional[BaseException] = None
        self.rows = rows
        self.endpoint = endpoint
        self.ttft_s: Optional[float] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"serving result not ready after {timeout}s (endpoint {self.endpoint!r})"
            )
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"serving result not ready after {timeout}s (endpoint {self.endpoint!r})"
            )
        return self._exc

    def _set(self, value: Dict[str, np.ndarray]) -> None:
        self._value = value
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()


class _Request:
    __slots__ = ("feeds", "rows", "t_submit", "deadline", "future")

    def __init__(self, feeds, rows, deadline_s: Optional[float], future: ResultFuture):
        self.feeds = feeds
        self.rows = rows
        self.t_submit = time.perf_counter()
        self.deadline = None if deadline_s is None else self.t_submit + deadline_s
        self.future = future


class ContinuousBatcher:
    """One endpoint's admission queue, drained by an external consumer
    with :meth:`poll`. Its expirer thread fails queued requests on their
    deadline, independently of the consumer (which may be inside a long
    step). The reference's push-mode arguments (``dispatch``,
    ``max_batch_rows``, ``max_latency_s``) come with flush endpoints."""

    def __init__(self, name: str, max_queue_rows: int):
        if max_queue_rows < 1:
            raise ValueError("max_queue_rows must be >= 1")
        self.name = name
        self.max_queue_rows = int(max_queue_rows)
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._queued_rows = 0
        # this batcher's own admission counters (the registry series are
        # process-wide; Server.stats() reports this endpoint's traffic)
        self._admitted_requests = 0
        self._admitted_rows = 0
        self._rejected = {r: 0 for r in m.REJECT_REASONS}
        self._deadline_expired = 0
        self._latency = Histogram(
            "serving_endpoint_latency_seconds",
            f"request latency for endpoint {name!r} (submit → result)",
            (), threading.Lock(), buckets=m.LATENCY_BUCKETS,
        )
        self._open = False
        self._draining = False
        self._expirer: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        with self._cond:
            if self._open:
                return
            self._open = True
            self._draining = False
            self._expirer = threading.Thread(
                target=self._expire_run, daemon=True,
                name=f"tfs-serving-{self.name}-deadlines",
            )
            self._expirer.start()

    def close(self, drain: bool = True) -> None:
        """Close admission without joining the expirer: with ``drain`` the
        queued requests stay for the consumer, else they fail now."""
        with self._cond:
            if not self._open and not self._queue:
                self._cond.notify_all()
                return
            self._open = False
            if drain:
                self._draining = True
            else:
                while self._queue:
                    req = self._queue.popleft()
                    self._queued_rows -= req.rows
                    m.QUEUE_DEPTH.dec(req.rows)
                    req.future._fail(ServingError(
                        f"server stopped without drain; request to {self.name!r} abandoned"
                    ))
            self._cond.notify_all()

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Close admission and join the expirer (it exits once the queue is
        closed and empty; the consumer drains it)."""
        with self._cond:
            if not self._open and self._expirer is None:
                return
        self.close(drain=drain)
        with self._cond:
            expirer = self._expirer
        if expirer is not None:
            expirer.join(timeout)
        with self._cond:
            if self._expirer is expirer and (expirer is None or not expirer.is_alive()):
                self._expirer = None

    @property
    def queued_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    def counters(self) -> Dict[str, object]:
        """One consistent snapshot of this queue's depth and counters."""
        with self._cond:
            out = {
                "queued_rows": self._queued_rows,
                "admitted_requests": self._admitted_requests,
                "admitted_rows": self._admitted_rows,
                "rejected": dict(self._rejected),
                "deadline_expired": self._deadline_expired,
            }
        out["latency"] = self._latency.quantiles()
        return out

    def observe_latency(self, seconds: float) -> None:
        """Record one finished request's submit-to-result wall time."""
        m.REQUEST_LATENCY.observe(seconds)
        self._latency.observe(seconds)

    # -- admission ----------------------------------------------------------

    def offer(self, feeds, rows: int, deadline_s: Optional[float]) -> ResultFuture:
        future = ResultFuture(self.name, rows)
        req = _Request(feeds, rows, deadline_s, future)
        with self._cond:
            if not self._open:
                m.rejected("closed").inc()
                self._rejected["closed"] += 1
                raise RejectedError(
                    f"endpoint {self.name!r} is not accepting requests "
                    "(server stopped or draining)",
                    reason="closed",
                )
            if self._queued_rows + rows > self.max_queue_rows:
                m.rejected("queue_full").inc()
                self._rejected["queue_full"] += 1
                raise RejectedError(
                    f"serving queue for {self.name!r} is full ({self._queued_rows} rows "
                    f"queued, bound {self.max_queue_rows}) — overload sheds instead of "
                    "hanging; retry with backoff or scale out",
                    reason="queue_full",
                )
            self._queue.append(req)
            self._queued_rows += rows
            self._admitted_requests += 1
            self._admitted_rows += rows
            m.QUEUE_DEPTH.inc(rows)
            self._cond.notify_all()
        m.REQUESTS.inc()
        m.ROWS.inc(rows)
        return future

    # -- pull-mode consumer API ---------------------------------------------

    def poll(self, max_requests: int,
             can_take: Optional[Callable[[_Request], bool]] = None) -> List[_Request]:
        """Take up to ``max_requests`` FIFO requests (expired ones fail
        first, never returned). ``can_take`` gates the HEAD request, so
        admission stays FIFO. Returns ``[]`` when nothing is takeable."""
        out: List[_Request] = []
        with self._cond:
            self._expire_locked(time.perf_counter())
            while self._queue and len(out) < max_requests:
                if can_take is not None and not can_take(self._queue[0]):
                    break
                req = self._queue.popleft()
                self._queued_rows -= req.rows
                m.QUEUE_DEPTH.dec(req.rows)
                out.append(req)
            if out:
                self._cond.notify_all()
        return out

    def requeue_front(self, req: _Request) -> bool:
        """Put an admitted request back at the HEAD (preemption), exempt
        from the queue bound; its deadline keeps running. Returns False
        (failing the future) only when stopped without drain."""
        with self._cond:
            if not self._open and not self._draining:
                req.future._fail(ServingError(
                    f"server stopped without drain; preempted request to {self.name!r} "
                    "abandoned"
                ))
                return False
            self._queue.appendleft(req)
            self._queued_rows += req.rows
            m.QUEUE_DEPTH.inc(req.rows)
            self._cond.notify_all()
        return True

    def wait_for_work(self, timeout: Optional[float]) -> bool:
        """Block until the queue is non-empty, admission closes, or
        ``timeout`` elapses; True iff work is queued."""
        with self._cond:
            if not self._queue and self._open:
                self._cond.wait(timeout)
            return bool(self._queue)

    # -- deadlines ----------------------------------------------------------

    def _expire_locked(self, now: float) -> None:
        """Fail queued requests whose deadline passed (caller holds the
        lock); FIFO order of the survivors is kept."""
        if not any(r.deadline is not None and r.deadline <= now for r in self._queue):
            return
        kept: collections.deque = collections.deque()
        for req in self._queue:
            if req.deadline is not None and req.deadline <= now:
                self._queued_rows -= req.rows
                m.QUEUE_DEPTH.dec(req.rows)
                m.DEADLINE_EXPIRED.inc()
                self._deadline_expired += 1
                req.future._fail(DeadlineExceededError(
                    f"request to {self.name!r} expired after {now - req.t_submit:.4f}s "
                    "in queue (deadline_s: total elapsed wall-clock)"
                ))
            else:
                kept.append(req)
        self._queue = kept

    def _expire_run(self) -> None:
        """The deadline thread: wakes at the earliest pending deadline;
        exits once the batcher is closed and its queue is empty."""
        while True:
            with self._cond:
                if not self._open and not self._queue:
                    return
                now = time.perf_counter()
                self._expire_locked(now)
                if not self._open and not self._queue:
                    return
                wake = min((r.deadline for r in self._queue if r.deadline is not None),
                           default=None)
                self._cond.wait(None if wake is None else max(0.0, wake - now))
