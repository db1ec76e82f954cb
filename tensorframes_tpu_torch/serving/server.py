"""The in-process serving front: ``Server.submit()`` → futures.

The reference package's ``serving/server.py``. Two kinds of endpoint:

* **flush endpoints** (:meth:`Server.register`): a program over cells
  (``map_rows`` semantics) behind a push-mode
  :class:`~tensorframes_tpu_torch.serving.batcher.ContinuousBatcher`,
  which coalesces small requests into one dispatch through the
  executor's ``run_rows_bucketed`` on the server's device and scatters
  each request's rows back;
* **decode endpoints** (:meth:`Server.register_decode`): a
  :class:`~tensorframes_tpu_torch.serving.DecodeEngine` behind a name,
  ``submit(name, {"prompt": tokens})`` resolving to ``{"tokens": [1,
  max_new_tokens]}``.

Warm-ladder contract: ``start()`` dispatches every flush endpoint once at
each bucket of :func:`~tensorframes_tpu_torch.compilecache.serving_row_buckets`
(the ladder ``ServingConfig.max_batch_rows`` bounds, the one every flush
pads into), and each decode engine warms its slot × phase grid; a warmed
server then dispatches any admissible request mix at keys it has seen
(zero ``tftpu_executor_jit_cache_misses_total``).

Lifecycle: ``start()`` → ``submit()``/``call()`` → ``stop(drain=True)``
or :meth:`Server.drain` (admission closes with counted rejections, queued
work completes, workers join); ``state`` reads ``starting``, ``running``,
``draining`` or ``stopped``. Deadlines are total elapsed wall-clock; an
optional :class:`~tensorframes_tpu_torch.resilience.RetryPolicy` retries
transient dispatch failures (a program is pure, so a retry is safe);
``submit(..., idempotency_key=)`` joins a request already admitted under
the same key instead of running it twice. The server runs on ``device``
(default ``config.device``, ``"cuda"``; asking for CUDA with no GPU
raises). :func:`~tensorframes_tpu_torch.serving.serve_http` puts it on
HTTP.

A third kind, **registered queries** (:meth:`Server.register_query`): a
lazy relational pipeline over a :class:`~.query.QuerySource` (a growing
CSV or Parquet directory, or a frame), answered from a result cache keyed
by (plan fingerprint, content digest), refreshed by folding per-chunk
aggregate partials when the plan allows it (:mod:`.query`). ``start()``
warms each query by executing it once; a restarted server over the same
``compilation_cache_dir`` warms from the persistent result store. Replicas
of a server behind a router make a fleet (:mod:`.router`, :mod:`.fleet`).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..kernels import KERNEL_BUILDS
from ..observability import context as _context
from ..observability import flight as _flight
from ..program import Program
from ..resilience.retry import RetryPolicy, retry_call
from ..shape import Unknown
from ..utils import get_logger
from ..validation import ValidationError
from . import metrics as m
from .batcher import (
    ContinuousBatcher,
    DeadlineExceededError,
    RejectedError,
    ResultFuture,
    ServingError,
)

logger = get_logger(__name__)

__all__ = [
    "ServingConfig", "Endpoint", "Server",
    "ServingError", "RejectedError", "DeadlineExceededError",
    "UnknownEndpointError",
]


class UnknownEndpointError(ValidationError):
    """``submit()`` to an endpoint name that was never registered (a type
    of its own, so the HTTP adapter maps it to 404 without reading
    messages)."""


@dataclasses.dataclass
class ServingConfig:
    """Admission and coalescing knobs, per server (the reference's names
    and defaults).

    ``max_batch_rows`` — flush when pending rows reach this (also the
    largest admissible single request and the top of the warmed bucket
    ladder). ``max_latency_s`` — the flush timer: the oldest queued
    request waits no longer than this before its batch dispatches.
    ``max_queue_rows`` — admission bound; past it ``submit`` raises
    :class:`RejectedError` (``reason=queue_full``). ``default_deadline_s``
    — deadline applied when a request carries none (None = no deadline);
    decode endpoints inherit it at registration. ``donate`` is accepted
    for the reference's signature and has no effect (XLA's buffer
    donation has no PyTorch counterpart); ``donate=True`` logs a warning
    saying so, once a process.
    ``warmup`` — warm every endpoint at ``start()``.
    ``idempotency_cache`` — bound of the idempotency-key dedup cache (0
    disables dedup); entries also expire after ``idempotency_ttl_s``, since
    a completed future pins its result arrays.
    """

    max_batch_rows: int = 64
    max_latency_s: float = 0.005
    max_queue_rows: int = 4096
    default_deadline_s: Optional[float] = None
    donate: bool = False
    warmup: bool = True
    idempotency_cache: int = 4096
    idempotency_ttl_s: float = 60.0

    def __post_init__(self):
        global _DONATE_WARNED
        if self.donate and not _DONATE_WARNED:
            _DONATE_WARNED = True
            logger.warning("ServingConfig(donate=True) has no effect: XLA's buffer "
                           "donation has no PyTorch counterpart")


_DONATE_WARNED = False


class Endpoint:
    """One registered program: feed validation and the coalesced dispatch
    the batcher calls. Inputs are cell-shaped (the ``map_rows``
    convention): a request's feeds carry a leading rows dim on every
    column (a bare cell is one row)."""

    def __init__(self, name: str, program: Program, retry: Optional[RetryPolicy], device):
        self.name = name
        self.program = program
        self.compiled = program.compiled()
        self.device = device
        self._retry = retry

    def validate_feeds(self, feeds) -> Dict[str, np.ndarray]:
        """Normalize one request's feeds: the name set must equal the
        program's inputs, dtypes cast to the input specs, cell dims
        checked against the spec, bare cells promoted to one row. Returns
        dense arrays sharing one lead dim."""
        if not isinstance(feeds, dict) or not feeds:
            raise ValidationError(
                f"endpoint {self.name!r}: feeds must be a non-empty dict of column "
                "name -> array"
            )
        want = set(self.program.input_names)
        got = set(feeds)
        if got != want:
            missing = sorted(want - got)
            extra = sorted(got - want)
            raise ValidationError(
                f"endpoint {self.name!r}: feeds {sorted(got)} do not match program "
                f"inputs {sorted(want)}"
                + (f"; missing {missing}" if missing else "")
                + (f"; unexpected {extra}" if extra else "")
            )
        out: Dict[str, np.ndarray] = {}
        lead: Optional[int] = None
        lead_of: Optional[str] = None
        for spec in self.program.inputs:
            try:
                arr = np.asarray(feeds[spec.name], dtype=spec.dtype.np_dtype)
            except (TypeError, ValueError) as e:
                raise ValidationError(
                    f"endpoint {self.name!r}: feed {spec.name!r} does not convert to "
                    f"{spec.dtype.name}: {e}"
                ) from None
            cell = list(spec.shape.dims)
            if arr.ndim == len(cell):
                arr = arr[None]  # a bare cell is one row
            if arr.ndim != len(cell) + 1:
                raise ValidationError(
                    f"endpoint {self.name!r}: feed {spec.name!r} has rank {arr.ndim}, "
                    f"expected cell rank {len(cell)} (one row) or {len(cell) + 1} "
                    "(rows-leading batch)"
                )
            for got_d, want_d in zip(arr.shape[1:], cell):
                if want_d != Unknown and int(got_d) != int(want_d):
                    raise ValidationError(
                        f"endpoint {self.name!r}: feed {spec.name!r} cell shape "
                        f"{tuple(arr.shape[1:])} does not match spec {tuple(cell)}"
                    )
            if lead is None:
                lead, lead_of = int(arr.shape[0]), spec.name
            elif int(arr.shape[0]) != lead:
                raise ValidationError(
                    f"endpoint {self.name!r}: feed {spec.name!r} has {arr.shape[0]} rows "
                    f"but {lead_of!r} has {lead} — every column of one request must "
                    "share the lead dim"
                )
            out[spec.name] = arr
        if lead == 0:
            raise ValidationError(f"endpoint {self.name!r}: zero-row request")
        return out

    def dispatch(self, feeds: Dict[str, np.ndarray], rows: int) -> Dict[str, np.ndarray]:
        """One coalesced flush through the executor's bucket-ladder entry
        on the server's device, under the server's retry policy."""
        return retry_call(self.compiled.run_rows_bucketed, feeds, self.device,
                          policy=self._retry, describe=f"serving.dispatch[{self.name}]")

    def warm(self, buckets: List[int]) -> Dict[str, object]:
        """Dispatch the program once at every bucket of ``buckets`` (zero
        feeds; results discarded), so each flush lands on a seen key."""
        t0 = time.perf_counter()
        misses0 = _JIT_MISSES.value
        for b in buckets:
            feeds = {
                s.name: np.zeros((b, *(int(d) for d in s.shape.dims)), s.dtype.np_dtype)
                for s in self.program.inputs
            }
            self.compiled.run_rows_bucketed(feeds, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"buckets": list(buckets), "new_keys": int(_JIT_MISSES.value - misses0),
                "seconds": round(time.perf_counter() - t0, 6)}


class Server:
    """The serving front: ``register()``/``register_decode()``,
    ``start()``, ``submit()``.

    ``register()`` takes an analyzed :class:`Program` (cell-shaped inputs,
    what ``compile_program(fetches, frame, block=False)`` returns) or any
    ``map_rows``-style fetches plus a frame or schema to normalize them
    against."""

    def __init__(self, config: Optional[ServingConfig] = None,
                 retry: Optional[RetryPolicy] = None, device=None):
        from ..compilecache import serving_row_buckets

        self.config = config or ServingConfig()
        # checked for warmup=False servers too: flushes above the ladder
        # would dispatch at exact shapes no warmup covers
        serving_row_buckets(self.config.max_batch_rows)
        self.device = resolve_device(device)
        self._retry = retry
        self._endpoints: Dict[str, Endpoint] = {}
        self._batchers: Dict[str, ContinuousBatcher] = {}
        self._decode: Dict[str, object] = {}  # name -> DecodeEngine
        self._queries: Dict[str, object] = {}  # name -> QueryEndpoint
        self._lock = threading.Lock()
        self._running = False
        self._starting = False
        self._draining = False
        self._stop_requested = False
        # idempotency-key dedup: (endpoint, key) -> (future, inserted_at),
        # FIFO eviction at config.idempotency_cache plus TTL expiry;
        # scoped per endpoint
        self._idem: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
        self.warmup_reports: Dict[str, object] = {}

    # -- registration -------------------------------------------------------

    @staticmethod
    def _check_name(name: str) -> None:
        if not name or "/" in name:
            raise ValueError(f"endpoint name must be non-empty and '/'-free, got {name!r}")

    def register(self, name: str, fetches, frame_or_schema=None, feed_dict=None) -> Endpoint:
        """Register ``fetches`` as flush endpoint ``name``. Non-Program
        fetches need ``frame_or_schema`` (a TensorFrame or Schema) to
        resolve column dtypes and cell shapes, as ``map_rows`` does. On a
        live server the endpoint warms and opens at once; a failed warm
        leaves no trace of it."""
        from ..ops.verbs import _apply_feed_dict, _normalize_program

        self._check_name(name)
        schema = getattr(frame_or_schema, "schema", frame_or_schema)
        if not (isinstance(fetches, Program) and fetches.outputs) and schema is None:
            raise ValueError(
                "register() needs frame_or_schema to normalize non-Program fetches "
                "(or pass a compile_program result)"
            )
        program, _ = _normalize_program(fetches, schema, block=False, device=self.device,
                                        feed_dict=feed_dict)
        program = _apply_feed_dict(program, feed_dict)
        for spec in program.inputs:
            if any(d == Unknown for d in spec.shape.dims):
                # requests with different extents would poison each
                # other's flush concatenate, and no warmup covers them
                raise ValueError(
                    f"endpoint {name!r}: input {spec.name!r} has cell shape "
                    f"{tuple(spec.shape.dims)} with an Unknown dim — serving endpoints "
                    "need concrete cell shapes (only the row/lead dim may vary); pad or "
                    "split the column to a fixed extent"
                )
        ep = Endpoint(name, program, self._retry, self.device)
        with self._lock:
            if self._taken_locked(name):
                raise ValueError(f"endpoint {name!r} already registered")
            self._endpoints[name] = ep
            batcher = ContinuousBatcher(
                name, ep.dispatch,
                max_batch_rows=self.config.max_batch_rows,
                max_latency_s=self.config.max_latency_s,
                max_queue_rows=self.config.max_queue_rows,
            )
            self._batchers[name] = batcher
            # _starting counts as live: start()'s last loop opens every
            # batcher, so a registration racing it must warm its own
            live = self._running or self._starting
        if live:
            if self.config.warmup:
                try:
                    self.warmup_reports[name] = self._warm(ep)
                except BaseException:
                    # a failed warm leaves no zombie: the name can be
                    # registered again with a fixed program
                    with self._lock:
                        self._endpoints.pop(name, None)
                        self._batchers.pop(name, None)
                    batcher.stop(drain=False)
                    raise
            with self._lock:
                if self._running:
                    batcher.start()
        return ep

    def register_decode(self, name: str, model_cfg, params, decode_config=None):
        """Register an iterative decode endpoint: a
        :class:`~tensorframes_tpu_torch.serving.DecodeEngine` over
        ``model_cfg``/``params`` with a paged int8 KV pool, on the server's
        device. On a running server the engine warms and starts at once."""
        from .decode import DecodeConfig, DecodeEngine

        self._check_name(name)
        cfg = decode_config or DecodeConfig()
        if cfg.default_deadline_s is None:
            cfg = dataclasses.replace(cfg, default_deadline_s=self.config.default_deadline_s)
        cfg = dataclasses.replace(cfg, warmup=cfg.warmup and self.config.warmup)
        engine = DecodeEngine(name, model_cfg, params, cfg, device=self.device)
        with self._lock:
            if self._taken_locked(name):
                raise ValueError(f"endpoint {name!r} already registered")
            self._decode[name] = engine
            live = self._running or self._starting
        if live:
            try:
                engine.start()
            except BaseException:
                with self._lock:
                    self._decode.pop(name, None)
                engine.stop(drain=False)
                raise
        return engine

    def _taken_locked(self, name: str) -> bool:
        return name in self._endpoints or name in self._decode or name in self._queries

    def register_query(self, name: str, source, build):
        """Register a relational pipeline as endpoint ``name``: ``source``
        is a :class:`~.query.QuerySource` (a scan directory or a frame),
        ``build`` maps the source frame to a lazy verb chain.
        ``submit(name, {})`` answers with the pipeline's result over the
        source's current contents, fronted by the result cache with
        counted invalidation; algebraic scan-rooted aggregates refresh
        incrementally (only new chunks re-read and re-executed,
        bit-identical to full recompute). Registration probes the plan at
        once, so a broken build or an empty source fails here, and records
        a decline row (:func:`~.query.query_cache_events`) when the plan
        declines either cache level. On a live server the query warms and
        opens at once; a failed warm leaves no trace of it."""
        from .query import QueryEndpoint, QuerySource, _withdraw_events

        self._check_name(name)
        if not isinstance(source, QuerySource):
            raise ValueError(
                f"register_query() needs a QuerySource, got {type(source).__name__}"
            )
        with self._lock:
            if self._taken_locked(name):
                raise ValueError(f"endpoint {name!r} already registered")
        # the probe reads a chunk and records the plan: outside the lock,
        # with a concurrent duplicate caught again on insert
        q = QueryEndpoint(name, source, build)
        with self._lock:
            if self._taken_locked(name):
                raise ValueError(f"endpoint {name!r} already registered")
            self._queries[name] = q
            live = self._running or self._starting
        if live:
            if self.config.warmup:
                try:
                    self.warmup_reports[name] = q.warm()
                except BaseException:
                    with self._lock:
                        self._queries.pop(name, None)
                    _withdraw_events(name)
                    raise
            with self._lock:
                if self._running:
                    q.open()
        return q

    def endpoints(self) -> List[str]:
        with self._lock:
            return sorted(set(self._endpoints) | set(self._decode) | set(self._queries))

    def _warm(self, ep: Endpoint) -> Dict[str, object]:
        """Dispatch the endpoint at every bucket of the serving ladder, so
        the first flush already lands on a seen key."""
        from ..compilecache import serving_row_buckets

        report = ep.warm(serving_row_buckets(self.config.max_batch_rows))
        logger.info("serving warmup[%s]: %s", ep.name, report)
        return report

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Server":
        """Warm every endpoint, then open admission. A ``stop()`` that
        arrives during warm-up wins: admission stays closed."""
        with self._lock:
            if self._running or self._starting:
                return self
            self._starting = True
            eps = list(self._endpoints.values())
            engines = list(self._decode.values())
            queries = list(self._queries.values())
        t0 = time.perf_counter()
        try:
            if self.config.warmup:
                for ep in eps:
                    self.warmup_reports[ep.name] = self._warm(ep)
                # a query warms by executing once, so the first request is
                # a cache hit; with the persistent result store armed a
                # restarted server warms from the store without a chunk read
                for q in queries:
                    self.warmup_reports[q.name] = q.warm()
            for eng in engines:
                eng.start()
        finally:
            with self._lock:
                self._starting = False
        with self._lock:
            if self._stop_requested:
                self._stop_requested = False
                _flight.record("serving.start_aborted", endpoints=sorted(self._endpoints),
                               warmup_s=round(time.perf_counter() - t0, 6))
                for eng in engines:
                    eng.stop(drain=True)
                return self
            # batchers open before the running flag flips: healthz never
            # says running while submits would shed as 'closed'
            for b in self._batchers.values():
                b.start()
            for q in self._queries.values():
                q.open()
            self._running = True
        _flight.record("serving.start", endpoints=self.endpoints(),
                       warmup_s=round(time.perf_counter() - t0, 6),
                       max_batch_rows=self.config.max_batch_rows,
                       max_latency_s=self.config.max_latency_s)
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Close admission and shut the batchers and engines down.
        ``drain=True`` completes every queued request first;
        ``drain=False`` fails them with :class:`ServingError`. Submits
        during and after shutdown get a counted ``closed`` rejection.
        While a graceful stop completes queued work, :attr:`state` reads
        ``draining``."""
        try:
            with self._lock:
                if self._starting:
                    self._stop_requested = True
                if (not self._running and not self._batchers and not self._decode
                        and not self._queries):
                    return
                self._running = False
                if drain:
                    self._draining = True
                batchers = list(self._batchers.values())
                engines = list(self._decode.values())
                queries = list(self._queries.values())
            # queries execute in the submitting thread: closing admission
            # is their whole drain
            for q in queries:
                q.close()
            pending = sum(b.queued_rows for b in batchers)
            _flight.record("serving.drain" if drain else "serving.stop",
                           endpoints=self.endpoints(), queued_rows=pending)
            for b in batchers:
                b.stop(drain=drain, timeout=timeout)
            for eng in engines:
                eng.stop(drain=drain, timeout=timeout)
        finally:
            with self._lock:
                self._draining = False
                # a stopped server keeps no dedup state: cached futures
                # pin result arrays, and nothing can redrive into it
                self._idem.clear()

    def drain(self, wait: bool = False, timeout: Optional[float] = None) -> None:
        """Gracefully retire this server: close admission (new submits
        shed as ``closed``), complete every queued request, then read
        ``state == "stopped"``. ``POST /admin/drain`` on the HTTP adapter
        calls it. ``wait=False`` returns at once; poll :attr:`state` (or
        ``/healthz``) for ``draining`` → ``stopped``."""
        if wait:
            self.stop(drain=True, timeout=timeout)
            return
        with self._lock:
            if self._draining:
                return  # one drain is already completing the queue
            self._draining = True
        threading.Thread(target=self.stop, kwargs={"drain": True, "timeout": timeout},
                         daemon=True, name="tfs-serving-drain").start()

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    @property
    def running(self) -> bool:
        return self._running

    @property
    def state(self) -> str:
        """``starting`` (warm-up, admission closed), ``running``
        (admission open), ``draining`` (admission closed, queued work
        completing) or ``stopped``."""
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._starting:
            return "starting"
        if self._draining:
            return "draining"
        return "running" if self._running else "stopped"

    # -- request path -------------------------------------------------------

    def submit(self, endpoint: str, feeds, deadline_s: Optional[float] = None,
               idempotency_key: Optional[str] = None) -> ResultFuture:
        """Admit one request; returns a :class:`ResultFuture` resolving to
        this request's rows of every output (or a decode endpoint's
        tokens). Raises :class:`RejectedError` on backpressure, closed or
        oversize (never blocks), :class:`ValidationError` on malformed
        feeds and :class:`UnknownEndpointError` on an unknown name.

        ``idempotency_key``: a second submit with a key this server has
        already admitted (for the same endpoint, within the TTL) joins the
        original request's future, counted by
        ``tftpu_serving_idempotent_dedup_total``, instead of running it
        again. The request's trace id is the thread's bound request id
        (``observability.context.request_scope``), else the key."""
        ikey = None
        if idempotency_key is not None and self.config.idempotency_cache:
            ikey = (endpoint, str(idempotency_key))
            with self._lock:
                self._prune_idem_locked(time.monotonic())
                entry = self._idem.get(ikey)
            if entry is not None:
                m.IDEMPOTENT_DEDUP.inc()
                _flight.record("serving.idempotent_dedup", endpoint=endpoint,
                               key=str(idempotency_key))
                return entry[0]
        trace_id = _context.current_request()
        if trace_id is None and idempotency_key is not None:
            trace_id = str(idempotency_key)
        fut = self._submit_new(endpoint, feeds, deadline_s, trace_id)
        if ikey is not None:
            with self._lock:
                # first writer wins: a racing duplicate that also missed
                # the cache keeps its own future
                self._idem.setdefault(ikey, (fut, time.monotonic()))
                while len(self._idem) > self.config.idempotency_cache:
                    self._idem.popitem(last=False)
        return fut

    def _prune_idem_locked(self, now: float) -> None:
        """Expire dedup entries past the TTL (insertion order, so the
        expired ones are a prefix)."""
        ttl = self.config.idempotency_ttl_s
        if ttl is None or ttl <= 0:
            return
        while self._idem:
            _, (_, inserted) = next(iter(self._idem.items()))
            if now - inserted <= ttl:
                break
            self._idem.popitem(last=False)

    def _submit_new(self, endpoint: str, feeds, deadline_s: Optional[float],
                    trace_id: Optional[str] = None) -> ResultFuture:
        eng = self._decode.get(endpoint)
        if eng is not None:
            with _context.request_scope(trace_id):
                return eng.submit(feeds, deadline_s=deadline_s)
        q = self._queries.get(endpoint)
        if q is not None:
            # a query executes in this thread under its endpoint lock: a
            # cache hit's latency is the lookup
            with _context.request_scope(trace_id):
                return q.submit(feeds, deadline_s=deadline_s, trace_id=trace_id)
        try:
            ep = self._endpoints[endpoint]
        except KeyError:
            raise UnknownEndpointError(
                f"unknown endpoint {endpoint!r}; registered: {self.endpoints()}"
            ) from None
        arrs = ep.validate_feeds(feeds)
        rows = int(next(iter(arrs.values())).shape[0])
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0 (got {deadline_s}) — the same contract as "
                "RetryPolicy.deadline_s"
            )
        return self._batchers[endpoint].offer(arrs, rows, deadline_s, trace_id=trace_id)

    def call(self, endpoint: str, feeds, deadline_s: Optional[float] = None,
             timeout: Optional[float] = None):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(endpoint, feeds, deadline_s).result(timeout)

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Queue depths, THIS server's admission counters, per-endpoint
        latency quantiles and decode state — the healthz body. ``process``
        carries the process-wide dispatch accounting under the reference's
        keys: ``xla_compiles`` and ``compile_cache_misses`` are dispatches
        at a feed-shape key seen for the first time
        (``tftpu_executor_jit_cache_misses_total``, the port's counterpart
        of a compile), ``compile_cache_hits`` dispatches at a seen key;
        ``kernel_builds`` counts the CUDA kernel library's ``nvcc`` builds
        this process ran (0 where it loaded an existing build)."""
        with self._lock:
            batchers = dict(self._batchers)
            engines = dict(self._decode)
            queries = dict(self._queries)
            running = self._running
            state = self._state_locked()
            # healthz is scraped continuously: expiry of the dedup cache
            # does not wait for further keyed submits
            self._prune_idem_locked(time.monotonic())
        queues: Dict[str, int] = {}
        latency: Dict[str, Dict[str, float]] = {}
        decode: Dict[str, Dict[str, int]] = {}
        totals = {
            "admitted_requests": 0,
            "admitted_rows": 0,
            "rejected": {r: 0 for r in m.REJECT_REASONS},
            "deadline_expired": 0,
        }

        def _tally(name, snap):
            queues[name] = snap["queued_rows"]
            totals["admitted_requests"] += snap["admitted_requests"]
            totals["admitted_rows"] += snap["admitted_rows"]
            for r, c in snap["rejected"].items():
                totals["rejected"][r] += c
            totals["deadline_expired"] += snap["deadline_expired"]
            if snap.get("latency"):
                latency[name] = snap["latency"]

        for name, b in batchers.items():
            _tally(name, b.counters())
        # registered queries tally like any endpoint; their result-cache
        # rows ride a section of their own
        query_rows: Dict[str, Dict[str, object]] = {}
        for name, q in queries.items():
            _tally(name, q.counters())
            query_rows[name] = q.cache_stats()
        for name, eng in engines.items():
            snap = eng.counters()
            _tally(name, snap)
            decode[name] = {k: snap[k] for k in (
                "running_slots", "free_pages", "allocatable_pages", "shared_pages",
                "swap_outs", "swap_resumes", "swap_fallbacks", "prefix_hits",
                "prefix_misses")}
        out = {
            "running": running,
            "state": state,
            "endpoints": sorted(queues),
            "queued_rows": queues,
            "latency": latency,
            **totals,
            "process": {
                "xla_compiles": int(_JIT_MISSES.value),
                "compile_cache_hits": int(_JIT_HITS.value),
                "compile_cache_misses": int(_JIT_MISSES.value),
                "kernel_builds": int(KERNEL_BUILDS.value),
            },
        }
        if decode:
            out["decode"] = decode
        if query_rows:
            out["queries"] = query_rows
        return out


# the executor registered these at import; acquiring them by name returns
# the same instruments
from ..observability.metrics import counter as _acquire_counter  # noqa: E402

_JIT_HITS = _acquire_counter("tftpu_executor_jit_cache_hits_total")
_JIT_MISSES = _acquire_counter("tftpu_executor_jit_cache_misses_total")
