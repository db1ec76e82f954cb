"""Serving-layer instruments (``tftpu_serving_*``, ``tftpu_decode_*``,
``tftpu_kvswap_*``, ``tftpu_prefix_cache_*``, ``tftpu_result_cache_*``,
``tftpu_router_*``),
registered at import under
the reference package's names, so one dashboard reads both. Label value sets are closed and every series is
pre-registered: a server that never shed load still exports
``rejected_total{reason=...} = 0``."""

from __future__ import annotations

from typing import Dict, Tuple

from ..observability.latency import LATENCY_BUCKETS
from ..observability.metrics import Counter
from ..observability.metrics import counter as _counter
from ..observability.metrics import gauge as _gauge
from ..observability.metrics import histogram as _histogram


#: Why an admission was refused (closed set).
REJECT_REASONS: Tuple[str, ...] = ("queue_full", "closed", "too_large")

#: Why a batch left the queue (closed set).
FLUSH_REASONS: Tuple[str, ...] = ("full", "timer", "drain")

#: Rows-per-flush buckets: the power-of-two ladder serving pads into.
_BATCH_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
)

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
FLUSHES: Dict[str, Counter] = {
    r: _counter(
        "tftpu_serving_flushes_total",
        "Coalesced batches dispatched, by flush reason (full = bucket "
        "target reached, timer = max-latency flush, drain = shutdown)",
        labels={"reason": r},
    )
    for r in FLUSH_REASONS
}
BATCH_ROWS = _histogram(
    "tftpu_serving_batch_rows",
    "Rows per coalesced flush (pre-padding)",
    buckets=_BATCH_BUCKETS,
)
PADDING_ROWS = _counter(
    "tftpu_serving_padding_rows_total",
    "Rows added padding flushes up to the power-of-two bucket ladder",
)
REQUEST_LATENCY = _histogram(
    "tftpu_serving_request_latency_seconds",
    "Request wall-clock from submit to result ready",
    buckets=LATENCY_BUCKETS,
)
QUEUE_WAIT = _histogram(
    "tftpu_serving_queue_wait_seconds",
    "Request wall-clock from submit to its flush leaving the queue",
    buckets=LATENCY_BUCKETS,
)
DISPATCH_SECONDS = _histogram(
    "tftpu_serving_dispatch_seconds",
    "Wall-clock of one coalesced flush's executor dispatch",
    buckets=LATENCY_BUCKETS,
)
REQUEST_TRACE = _counter(
    "tftpu_serving_request_trace_total",
    "Requests whose trace context crossed a process hop (the "
    "X-Tftpu-Trace header was adopted) — the cross-hop tracing "
    "coverage signal",
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


# -- KV memory hierarchy (tftpu_kvswap_*, tftpu_prefix_cache_*) -------------
# preemptions_total counts every eviction, kvswap_out_total the subset
# whose pages went to disk; resume against fallback says whether the swap
# paid off or corruption pushed the request back onto the replay path.
# The prefix counters are the cache's hit rate and residency.

KVSWAP_OUTS = _counter(
    "tftpu_kvswap_out_total",
    "Preempted sequences whose KV pages were host-swapped to the "
    "block store (CRC-checked segment) instead of discarded",
)
KVSWAP_RESUMES = _counter(
    "tftpu_kvswap_resume_total",
    "Sequences resumed by restoring host-swapped pages bit-identically "
    "(no prefill or teacher-forced replay ran)",
)
KVSWAP_FALLBACKS = _counter(
    "tftpu_kvswap_fallback_total",
    "Swap-in attempts abandoned for the recompute-replay path (segment "
    "corruption or store failure — the request still completes; the "
    "store's quarantine counters name the root cause)",
)
KVSWAP_BYTES = _counter(
    "tftpu_kvswap_bytes_total",
    "Bytes of KV page payload written to the block store by "
    "per-sequence swap-out",
)
PREFIX_HITS = _counter(
    "tftpu_prefix_cache_hits_total",
    "Prompt admissions that reused at least one shared prefix page "
    "(those prefill chunks were skipped entirely)",
)
PREFIX_MISSES = _counter(
    "tftpu_prefix_cache_misses_total",
    "Prompt admissions that found no shared prefix page (cold prefill "
    "ran for the whole prompt; only counted when the cache is armed)",
)
PREFIX_SHARED_PAGES = _gauge(
    "tftpu_prefix_cache_shared_pages",
    "Pages currently published read-only in the content-addressed "
    "prefix cache (any refcount, including cached-but-unreferenced)",
)
PREFIX_EVICTIONS = _counter(
    "tftpu_prefix_cache_evictions_total",
    "Shared prefix pages reclaimed to the free list under allocation "
    "pressure (only refcount-0 pages are eligible, LRU-first)",
)


def rejected(reason: str) -> Counter:
    """The pre-registered rejection counter for ``reason``."""
    return REJECTED[reason]


# -- hardened HTTP ingress (tftpu_serving_rejections_total) -----------------
# Transport-level refusals happen before a request reaches admission
# control, so they ride their own counter: rejected_total spikes mean
# the batcher is full, rejections_total spikes the transport.

#: Why the HTTP layer refused a connection/body (closed set).
HTTP_REJECT_REASONS: Tuple[str, ...] = ("body_too_large", "read_timeout", "conn_limit")

HTTP_REJECTIONS: Dict[str, Counter] = {
    r: _counter(
        "tftpu_serving_rejections_total",
        "HTTP ingress refusals before admission, by reason "
        "(body_too_large = request body over the ingress byte limit "
        "[413], read_timeout = connection read stalled past the "
        "per-connection timeout [408/close], conn_limit = concurrent "
        "connection bound reached [503])",
        labels={"reason": r},
    )
    for r in HTTP_REJECT_REASONS
}

IDEMPOTENT_DEDUP = _counter(
    "tftpu_serving_idempotent_dedup_total",
    "Submissions deduplicated by idempotency key (a redriven or "
    "retried dispatch joined the original request's future instead of "
    "executing again)",
)


def http_rejected(reason: str) -> Counter:
    """The pre-registered ingress rejection counter for ``reason``."""
    return HTTP_REJECTIONS[reason]


# -- fleet router (``tftpu_router_*``) ---------------------------------------
# The router is the one place that sees the whole fleet: how many
# replicas are routable, how often a dispatch had to be redriven to a
# survivor, and the client's latency through failures. Per-replica
# series stay out of the registry: ranks ride the router.* flight
# records and the router's healthz body.

#: Why the router refused an ingress request (closed set).
ROUTER_REJECT_REASONS: Tuple[str, ...] = ("no_replica", "deadline")

ROUTER_REQUESTS = _counter(
    "tftpu_router_requests_total",
    "Ingress requests admitted by the fleet router",
)
ROUTER_REDRIVES = _counter(
    "tftpu_router_redrives_total",
    "Dispatches redriven to a surviving replica after the chosen "
    "replica failed mid-request (same idempotency key, original "
    "deadline)",
)
ROUTER_REJECTED: Dict[str, Counter] = {
    r: _counter(
        "tftpu_router_rejected_total",
        "Ingress requests the router refused, by reason (no_replica = "
        "no live non-draining replica, deadline = the request's budget "
        "lapsed before any dispatch succeeded)",
        labels={"reason": r},
    )
    for r in ROUTER_REJECT_REASONS
}
ROUTER_REPLICAS_LIVE = _gauge(
    "tftpu_router_replicas_live",
    "Replicas the router currently considers routable (state=running, "
    "fresh heartbeat, healthz reachable)",
)
ROUTER_REPLICA_DEAD = _counter(
    "tftpu_router_replica_dead_total",
    "Replicas newly marked dead by the router/fleet (process exit, "
    "stale heartbeat, or repeated scrape failure)",
)
ROUTER_REPLICA_RESTARTS = _counter(
    "tftpu_router_replica_restarts_total",
    "Replica processes respawned by the serving fleet supervisor "
    "after a death",
)
ROUTER_DISPATCH_SECONDS = _histogram(
    "tftpu_router_dispatch_seconds",
    "Wall-clock of one router->replica dispatch attempt (successful "
    "or failed; redrives observe once per attempt)",
    buckets=LATENCY_BUCKETS,
)
ROUTER_REQUEST_LATENCY = _histogram(
    "tftpu_router_request_latency_seconds",
    "Ingress request wall-clock through the router (admission to "
    "relayed reply, including any redrives) — the fleet bench's p99 "
    "gate reads this",
    buckets=LATENCY_BUCKETS,
)


def router_rejected(reason: str) -> Counter:
    """The pre-registered router rejection counter for ``reason``."""
    return ROUTER_REJECTED[reason]


# -- registered-query result cache (``tftpu_result_cache_*``) ---------------
# Process-wide series; Server.stats() carries the per-endpoint rows.

#: Why a registered query ran a counted full recompute (closed set):
#: cold = first sight of this input partition; invalidated = a seen part
#: changed or disappeared; ineligible = the plan declined caching or
#: incremental maintenance; corrupt_partial = a cached chunk partial
#: failed its CRC and that chunk re-executed.
RECOMPUTE_REASONS: Tuple[str, ...] = (
    "cold", "invalidated", "ineligible", "corrupt_partial",
)

RESULT_CACHE_HITS = _counter(
    "tftpu_result_cache_hits_total",
    "Registered-query requests served from the result cache (memo or "
    "persistent store) — no plan execution, no chunk read",
)
RESULT_CACHE_MISSES = _counter(
    "tftpu_result_cache_misses_total",
    "Registered-query requests whose (plan fingerprint, content "
    "digest) key was absent from the result cache",
)
RESULT_CACHE_INVALIDATIONS = _counter(
    "tftpu_result_cache_invalidations_total",
    "Input-partition digest changes observed by registered queries "
    "(the previous cached result can no longer serve; appends refresh "
    "incrementally, rewrites/removals force full recompute)",
)
RESULT_CACHE_BYTES = _counter(
    "tftpu_result_cache_bytes_total",
    "Bytes of result/partial tables published into the persistent "
    "result store by registered queries",
)
RESULT_CACHE_CHUNKS_FOLDED = _counter(
    "tftpu_result_cache_chunks_folded_total",
    "Scan chunks whose CACHED aggregate partials were folded into a "
    "registered query's refresh instead of being re-read and "
    "re-executed (the incremental-maintenance payoff counter)",
)
RESULT_CACHE_RECOMPUTES: Dict[str, Counter] = {
    r: _counter(
        "tftpu_result_cache_recomputes_total",
        "Registered-query executions that could not serve from cached "
        "results/partials, by reason (cold = first sight of the input "
        "partition, invalidated = a seen part changed/disappeared, "
        "ineligible = the plan declined caching/incremental [TFG114 "
        "names the stage], corrupt_partial = a damaged cached partial "
        "was quarantined and its chunk re-executed)",
        labels={"reason": r},
    )
    for r in RECOMPUTE_REASONS
}


def result_recompute(reason: str) -> Counter:
    """The pre-registered recompute counter for ``reason``."""
    return RESULT_CACHE_RECOMPUTES[reason]
