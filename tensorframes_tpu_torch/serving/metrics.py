"""Serving-layer instruments (``tftpu_serving_*``, ``tftpu_decode_*``),
registered at import under the reference package's names, so one
dashboard reads both. Label value sets are closed and every series is
pre-registered: a server that never shed load still exports
``rejected_total{reason=...} = 0``."""

from __future__ import annotations

from typing import Dict, Tuple

from ..observability.metrics import Counter
from ..observability.metrics import counter as _counter
from ..observability.metrics import gauge as _gauge
from ..observability.metrics import histogram as _histogram

#: Latency histogram bounds, in seconds (the reference's
#: ``observability/latency.py`` ladder).
LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

#: Why an admission was refused (closed set).
REJECT_REASONS: Tuple[str, ...] = ("queue_full", "closed", "too_large")

REQUESTS = _counter(
    "tftpu_serving_requests_total",
    "Requests admitted into the serving queue",
)
ROWS = _counter(
    "tftpu_serving_rows_total",
    "Rows admitted into the serving queue",
)
REJECTED: Dict[str, Counter] = {
    r: _counter(
        "tftpu_serving_rejected_total",
        "Requests refused at admission, by reason (queue_full = "
        "backpressure shed, closed = server stopped/draining, "
        "too_large = request exceeds the endpoint's bound)",
        labels={"reason": r},
    )
    for r in REJECT_REASONS
}
QUEUE_DEPTH = _gauge(
    "tftpu_serving_queue_depth_rows",
    "Rows currently waiting in serving queues (all endpoints)",
)
REQUEST_LATENCY = _histogram(
    "tftpu_serving_request_latency_seconds",
    "Request wall-clock from submit to result ready",
    buckets=LATENCY_BUCKETS,
)
DEADLINE_EXPIRED = _counter(
    "tftpu_serving_deadline_expired_total",
    "Requests failed because their deadline passed while queued",
)
DISPATCH_ERRORS = _counter(
    "tftpu_serving_dispatch_errors_total",
    "Dispatches that raised, and resumed sequences that diverged from "
    "their recorded tokens (every affected request fails)",
)

# -- iterative decode (tftpu_decode_*) ---------------------------------------

#: Engine phases (closed set).
DECODE_PHASES: Tuple[str, ...] = ("prefill", "decode")

DECODE_TOKENS = _counter(
    "tftpu_decode_tokens_total",
    "Newly generated tokens across all decode endpoints (replayed tokens "
    "of a preempted sequence's resume are not counted); rate = tokens/s",
)
DECODE_STEPS: Dict[str, Counter] = {
    p: _counter(
        "tftpu_decode_steps_total",
        "Engine step dispatches by phase (prefill = one sequence's prompt "
        "chunk, decode = one batched token step over the running slots)",
        labels={"phase": p},
    )
    for p in DECODE_PHASES
}
DECODE_TTFT = _histogram(
    "tftpu_decode_ttft_seconds",
    "Time to first token: submit to the prompt's prefill completing",
    buckets=LATENCY_BUCKETS,
)
DECODE_SLOTS = _gauge(
    "tftpu_decode_slot_occupancy",
    "Sequence slots currently running in the iterative decode batch",
)
DECODE_FREE_PAGES = _gauge(
    "tftpu_decode_free_pages",
    "Free pages across decode KV pools (the headroom preemption defends)",
)
DECODE_PREEMPTIONS = _counter(
    "tftpu_decode_preemptions_total",
    "Running sequences preempted because the KV pool had no free page "
    "(evicted, requeued at the head, resumed bit-identically later)",
)
DECODE_EVICTIONS = _counter(
    "tftpu_decode_evictions_total",
    "KV pages evicted by preemption (freed from a preempted sequence's table)",
)


def rejected(reason: str) -> Counter:
    """The pre-registered rejection counter for ``reason``."""
    return REJECTED[reason]
