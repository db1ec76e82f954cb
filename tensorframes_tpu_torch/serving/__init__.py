"""Online serving: the iterative decode engine behind an in-process server.

:class:`Server` with :meth:`Server.register_decode` puts a
:class:`DecodeEngine` behind a name: token-level continuous batching over
a block-paged int8 KV pool (:class:`PagedKVPool`), where sequence slots
join and leave the running batch every step, and the pool preempts
(evict, requeue, bit-identical replay) when it runs out of pages.

Guarantees, as in the reference package: a batched request's tokens equal
its solo run exactly; a preempted request resumes with exactly its
recorded tokens or fails loudly; admission is bounded (counted
``queue_full`` rejections) and deadlines are total elapsed wall-clock
(a full pool cannot hold a request past its deadline); shutdown drains.
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
from .decode import DecodeConfig, DecodeEngine  # noqa: F401
from .kvpool import PagedKVPool, PoolAccountingError, PoolExhaustedError  # noqa: F401
from .server import Server, ServingConfig, UnknownEndpointError  # noqa: F401

__all__ = [
    "Server",
    "ServingConfig",
    "ContinuousBatcher",
    "ResultFuture",
    "ServingError",
    "RejectedError",
    "DeadlineExceededError",
    "UnknownEndpointError",
    "DecodeConfig",
    "DecodeEngine",
    "PagedKVPool",
    "PoolAccountingError",
    "PoolExhaustedError",
    "metrics",
]
