"""Continuous batcher: one endpoint's bounded, deadline-aware FIFO queue.

Two modes, as in the reference package:

* **push** (a ``dispatch`` callable): a worker thread coalesces queued
  requests (a few rows each) into one flush when the pending rows reach
  ``max_batch_rows`` (``reason=full``), when the oldest request has
  waited ``max_latency_s`` (``reason=timer``), or at shutdown
  (``reason=drain``). The flush's feeds concatenate along the rows,
  ``dispatch(feeds, rows)`` runs them (``Endpoint.dispatch``: the
  executor's ``run_rows_bucketed``, which pads to the bucket ladder the
  server warmed), and results scatter back by offset. The program is
  row-independent, so a row's result does not depend on how it was
  coalesced.
* **pull** (``dispatch=None``): no worker thread — the decode engine
  drains the queue with :meth:`ContinuousBatcher.poll` and pushes
  preempted work back with :meth:`ContinuousBatcher.requeue_front`.

In both modes:

* admission is **bounded**: past ``max_queue_rows`` an offer raises
  :class:`RejectedError` (``reason=queue_full``) instead of queueing, and
  a request over ``max_batch_rows`` is ``too_large``;
* per-request **deadlines** are total elapsed wall-clock from submit; a
  dedicated expirer thread fails a request whose deadline lapses while
  it waits — even while the worker is inside a slow flush, or a full KV
  pool holds the decode engine;
* **drain** completes queued requests; closing without drain fails them
  with :class:`ServingError`.

The flush body is fault site ``serving.flush`` (an injected error fails
the batch's requests, an injected ``Delay`` stalls the flush). Flushes,
rejections and deadline expiries leave ``serving.*`` flight records and,
with the tracer on, ``serving.flush``/``serving.request`` spans carrying
the requests' trace ids.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..observability import context as _context
from ..observability import events as _events
from ..observability import flight as _flight
from ..observability.latency import LATENCY_BUCKETS  # noqa: F401 (the reference's name here)
from ..observability.metrics import Histogram
from ..ops.executor import bucket_rows
from ..resilience.faults import delay_point, fault_point, register_site
from ..utils import get_logger
from . import metrics as m

logger = get_logger(__name__)

register_site(
    "serving.flush",
    "continuous-batcher flush body, before the coalesced dispatch — an "
    "injected error fails every request in the batch (counted, "
    "futures resolve); an injected Delay stalls the flush so queued "
    "deadlines expire (the deadline-drill shape)",
)


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
    for the output dict (this request's rows of every output) or raises
    the request's failure. A decode request's ``ttft_s`` is the time from
    submit to its first token, set when that token exists (``None`` before,
    and for other requests)."""

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
    __slots__ = ("feeds", "rows", "t_submit", "deadline", "future", "trace_id")

    def __init__(self, feeds, rows, deadline_s: Optional[float], future: ResultFuture,
                 trace_id: Optional[str] = None):
        self.feeds = feeds
        self.rows = rows
        self.t_submit = time.perf_counter()
        self.deadline = None if deadline_s is None else self.t_submit + deadline_s
        self.future = future
        # the cross-hop request id: a flush serves many requests, so the
        # id lives on the request, not in a thread-local
        self.trace_id = trace_id


class ContinuousBatcher:
    """One endpoint's queue. ``dispatch(feeds, rows)`` is the push mode's
    coalesced entry; ``dispatch=None`` is the pull mode (see the module
    docstring). Its expirer thread fails queued requests on their deadline
    independently of the worker or the consumer."""

    def __init__(
        self,
        name: str,
        dispatch: Optional[Callable[[Dict[str, np.ndarray], int], Dict[str, np.ndarray]]] = None,
        max_batch_rows: int = 1,
        max_latency_s: float = 0.0,
        max_queue_rows: int = 4096,
    ):
        if max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        if max_latency_s < 0:
            raise ValueError("max_latency_s must be >= 0")
        if max_queue_rows < max_batch_rows:
            raise ValueError(
                "max_queue_rows must be >= max_batch_rows (a queue that "
                "cannot hold one full batch deadlocks admission)"
            )
        self.name = name
        self._dispatch = dispatch
        self.max_batch_rows = int(max_batch_rows)
        self.max_latency_s = float(max_latency_s)
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
        self._worker: Optional[threading.Thread] = None
        self._expirer: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def pull_mode(self) -> bool:
        return self._dispatch is None

    def start(self) -> None:
        with self._cond:
            if self._open:
                return
            self._open = True
            self._draining = False
            if not self.pull_mode:
                self._worker = threading.Thread(
                    target=self._run, daemon=True, name=f"tfs-serving-{self.name}",
                )
                self._worker.start()
            self._expirer = threading.Thread(
                target=self._expire_run, daemon=True,
                name=f"tfs-serving-{self.name}-deadlines",
            )
            self._expirer.start()

    def close(self, drain: bool = True) -> None:
        """Close admission without joining the threads: with ``drain`` the
        queued requests stay for the worker or consumer, else they fail
        now."""
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
        """Close admission; with ``drain`` flush everything queued before
        the worker exits, else fail queued requests. Joins the worker and
        the expirer (each bounded by ``timeout``). In pull mode the
        consumer drains the queue."""
        with self._cond:
            if not self._open and self._worker is None and self._expirer is None:
                return
        self.close(drain=drain)
        with self._cond:
            worker = self._worker
            expirer = self._expirer
        if worker is not None:
            worker.join(timeout)
            if worker.is_alive():
                logger.warning("serving batcher %r worker still draining after stop "
                               "timeout", self.name)
        if expirer is not None:
            expirer.join(timeout)
        with self._cond:
            if self._worker is worker and (worker is None or not worker.is_alive()):
                self._worker = None
            if self._expirer is expirer and (expirer is None or not expirer.is_alive()):
                self._expirer = None

    @property
    def queued_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

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

    def offer(self, feeds, rows: int, deadline_s: Optional[float],
              trace_id: Optional[str] = None) -> ResultFuture:
        if rows > self.max_batch_rows:
            m.rejected("too_large").inc()
            with self._cond:
                self._rejected["too_large"] += 1
            raise RejectedError(
                f"request of {rows} rows exceeds max_batch_rows={self.max_batch_rows} "
                f"for endpoint {self.name!r} — split the request or raise "
                "ServingConfig.max_batch_rows",
                reason="too_large",
            )
        future = ResultFuture(self.name, rows)
        req = _Request(feeds, rows, deadline_s, future, trace_id or _context.current_request())
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
                _flight.record("serving.reject", endpoint=self.name, reason="queue_full",
                               rows=rows, queued_rows=self._queued_rows)
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
                _flight.record("serving.deadline", endpoint=self.name, rows=req.rows,
                               waited_s=round(now - req.t_submit, 6))
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

    # -- push-mode worker ---------------------------------------------------

    def _wait_timeout_locked(self, now: float) -> Optional[float]:
        """Seconds until the next actionable instant (the oldest request's
        flush timer or the earliest deadline); None = wait for work."""
        wake = None
        if self._queue:
            wake = self._queue[0].t_submit + self.max_latency_s
        for req in self._queue:
            if req.deadline is not None:
                wake = req.deadline if wake is None else min(wake, req.deadline)
        return None if wake is None else max(0.0, wake - now)

    def _run(self) -> None:
        while True:
            with self._cond:
                while True:
                    now = time.perf_counter()
                    self._expire_locked(now)
                    if self._queue and self._queued_rows >= self.max_batch_rows:
                        batch, reason = self._pop_locked(), "full"
                        break
                    if self._queue and now - self._queue[0].t_submit >= self.max_latency_s:
                        batch, reason = self._pop_locked(), "timer"
                        break
                    if self._draining:
                        if self._queue:
                            batch, reason = self._pop_locked(), "drain"
                            break
                        self._cond.notify_all()  # release the expirer
                        return  # drained and closed: the worker exits
                    if not self._open:
                        self._cond.notify_all()
                        return
                    self._cond.wait(self._wait_timeout_locked(now))
            self._flush(batch, reason)

    def _pop_locked(self) -> List[_Request]:
        """Pop a FIFO prefix of requests totalling <= max_batch_rows
        (always at least one: admission bounds any single request)."""
        batch: List[_Request] = []
        rows = 0
        while self._queue and rows + self._queue[0].rows <= self.max_batch_rows:
            req = self._queue.popleft()
            rows += req.rows
            batch.append(req)
        self._queued_rows -= rows
        m.QUEUE_DEPTH.dec(rows)
        return batch

    def _flush(self, batch: List[_Request], reason: str) -> None:
        t0 = time.perf_counter()
        n = sum(r.rows for r in batch)
        m.FLUSHES[reason].inc()
        m.BATCH_ROWS.observe(n)
        m.PADDING_ROWS.inc(bucket_rows(n) - n)
        for req in batch:
            m.QUEUE_WAIT.observe(t0 - req.t_submit)
        try:
            delay_point("serving.flush")
            fault_point("serving.flush")
            feeds = {
                k: np.concatenate([np.asarray(r.feeds[k]) for r in batch])
                for k in batch[0].feeds
            } if len(batch) > 1 else dict(batch[0].feeds)
            outs = self._dispatch(feeds, n)
        except BaseException as e:
            m.DISPATCH_ERRORS.inc()
            _flight.record("serving.error", endpoint=self.name, reason=reason, rows=n,
                           requests=len(batch), error=type(e).__name__, message=str(e))
            for req in batch:
                req.future._fail(e)
            return
        dt = time.perf_counter() - t0
        m.DISPATCH_SECONDS.observe(dt)
        _flight.record("serving.flush", endpoint=self.name, reason=reason, rows=n,
                       requests=len(batch), seconds=round(dt, 6))
        if _events.TRACER.enabled:
            args = {"endpoint": self.name, "reason": reason, "rows": n,
                    "requests": len(batch)}
            rids = [r.trace_id for r in batch if r.trace_id]
            if rids:
                args["request_ids"] = rids[:16]
            _events.TRACER.emit_complete("serving.flush", t0, dt, args=args, cat="serving")
        off = 0
        done_t = time.perf_counter()
        for req in batch:
            # a copy: a request's result must not pin the whole flush
            # buffer (nor alias its neighbours') for the future's lifetime
            req.future._set({k: np.array(v[off:off + req.rows]) for k, v in outs.items()})
            off += req.rows
            latency = done_t - req.t_submit
            self.observe_latency(latency)
            if _events.TRACER.enabled:
                args = {"endpoint": self.name, "rows": req.rows}
                if req.trace_id:
                    args["request_id"] = req.trace_id
                _events.TRACER.emit_complete("serving.request", req.t_submit, latency,
                                             args=args, cat="serving")
