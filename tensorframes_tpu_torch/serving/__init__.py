"""Online serving: flush endpoints and the iterative decode engine behind
an in-process server, with an HTTP adapter.

:class:`Server` puts two kinds of endpoint behind names:

* :meth:`Server.register` — a program over cells whose small requests a
  push-mode :class:`ContinuousBatcher` coalesces into one dispatch through
  the executor's power-of-two row buckets (the ladder ``start()`` warms,
  so a warmed server dispatches any admissible mix at keys it has seen),
  scattering each request's rows back;
* :meth:`Server.register_decode` — a :class:`DecodeEngine`: token-level
  continuous batching over a block-paged int8 KV pool
  (:class:`PagedKVPool`), where sequence slots join and leave the running
  batch every step, the pool preempts (evict, requeue, bit-identical
  replay, or restore from a swap segment with ``kv_swap=True``) when it
  runs out of pages, and ``prefix_cache=True`` shares prompt-prefix pages
  across requests;
* :meth:`Server.register_query` — a lazy relational pipeline over a
  :class:`QuerySource` (a growing CSV/Parquet directory or a frame),
  answered from a result cache and refreshed by folding per-chunk
  aggregate partials (:mod:`.query`).

:func:`serve_http` serves a :class:`Server` over HTTP (``POST
/v1/<endpoint>``, ``GET /healthz``, ``POST /admin/drain``).

Scale-out: :class:`ServingFleet` supervises N replica processes, each a
``serve_replica(Server(...))`` (:mod:`.replica`: heartbeats and an
address card in a shared rendezvous dir), behind one :class:`Router`
ingress that routes by queue depth and redrives a request whose replica
died to a survivor under its original deadline and idempotency key.

Guarantees, as in the reference package: a coalesced request's rows equal
its solo dispatch exactly, and a batched, prefix-hit or swap-resumed
sequence's tokens equal its solo cold run exactly; admission is bounded
(counted ``queue_full`` rejections), deadlines are total elapsed
wall-clock, shutdown drains, and an idempotency key joins a request
already admitted instead of running it twice; through the router every
admitted request gets exactly one response.
"""

from __future__ import annotations

from . import metrics  # noqa: F401  (registers tftpu_serving_* at import)
from .batcher import (  # noqa: F401
    ContinuousBatcher,
    DeadlineExceededError,
    RejectedError,
    ResultFuture,
    ServingError,
)
from .decode import DecodeConfig, DecodeEngine, prefix_cache_events  # noqa: F401
from .fleet import FleetDegradedError, ServingFleet  # noqa: F401
from .http import serve_http  # noqa: F401
from .kvpool import PagedKVPool, PoolAccountingError, PoolExhaustedError  # noqa: F401
from .query import (  # noqa: F401
    QUERY_DECLINE_REASONS,
    QueryEndpoint,
    QuerySource,
    query_cache_events,
)
from .replica import serve_replica  # noqa: F401
from .router import Router, RouterConfig  # noqa: F401
from .server import Endpoint, Server, ServingConfig, UnknownEndpointError  # noqa: F401

__all__ = [
    "Server",
    "ServingConfig",
    "Endpoint",
    "ContinuousBatcher",
    "ResultFuture",
    "ServingError",
    "RejectedError",
    "DeadlineExceededError",
    "UnknownEndpointError",
    "DecodeConfig",
    "DecodeEngine",
    "prefix_cache_events",
    "QuerySource",
    "QueryEndpoint",
    "query_cache_events",
    "QUERY_DECLINE_REASONS",
    "PagedKVPool",
    "PoolAccountingError",
    "PoolExhaustedError",
    "serve_http",
    "serve_replica",
    "Router",
    "RouterConfig",
    "ServingFleet",
    "FleetDegradedError",
    "metrics",
]
