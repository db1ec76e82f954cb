"""Runtime configuration for tensorframes_tpu_torch.

The knobs the ported verbs read — row-bucketing ladder, the default
partition count, the verbs' block pipeline, the generic aggregate's
buffer, the plan layer's fusion and re-optimization switches, verified
UDF lifting, the persistent caches' directory and the dispatch-key store's bound, the
donation switch the static analyzer reads, the block store's budget and the fleet's
heartbeat cadence and timeout, the dispatch deadline, the batch axis
and the multi-rank relational budget — plus the execution ``device``. Every knob but the device can
be overridden via environment variables (``TFTPU_*``, the reference's
names and defaults);
every field can be set programmatically via :func:`configure`. The device
is chosen only in code: ``configure(device=...)``, or the ``device=``
argument every verb takes, which overrides the configured one for that
call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if v in (None, "") else float(v)


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    # map_rows lead-dim bucketing: pad the vmapped row count up to
    # min_bucket * 2**k (k <= max_bucket_doublings) so the per-shape
    # cache stays O(log n) across varying block sizes; padded rows are
    # sliced off. Only row-independent semantics pad — map_blocks
    # programs see the true block.
    min_bucket: int = _env_int("TFTPU_MIN_BUCKET", 8)
    max_bucket_doublings: int = _env_int("TFTPU_MAX_BUCKET_DOUBLINGS", 30)
    # Default number of blocks when partitioning un-blocked input.
    default_num_blocks: int = _env_int("TFTPU_DEFAULT_NUM_BLOCKS", 4)
    # aggregate(): rows buffered before compaction in the generic keyed
    # aggregator (≙ TensorFlowUDAF bufferSize=10, DebugRowOps.scala:580).
    aggregate_buffer_size: int = _env_int("TFTPU_AGG_BUFFER", 10)
    # map_blocks keeps this many extra blocks in flight before reading
    # the oldest one's outputs back (0 = one block at a time), and the
    # ragged map_rows this many groups' outputs.
    map_pipeline_depth: int = _env_int("TFTPU_MAP_PIPELINE_DEPTH", 2)
    # map_blocks on a host frame of more than one block: a worker thread
    # stages up to this many blocks' feeds on the device ahead of the
    # block being computed (io.prefetch_to_device; 0 = off).
    map_prefetch_depth: int = _env_int("TFTPU_MAP_PREFETCH_DEPTH", 2)
    # Lazy verb-chain fusion (tensorframes_tpu_torch/plan): chained
    # map_blocks/map_rows/select/filter/join/aggregate record a logical
    # plan that lowers to one composed program per block at force time.
    # TFTPU_FUSION=0 is the escape hatch: every verb runs eagerly,
    # stage by stage, with bit-identical results.
    plan_fusion: bool = _env_bool("TFTPU_FUSION", True)
    # Adaptive query optimizer: aggregate pushdown below joins,
    # multi-join reordering, and re-optimization from the per-plan stats
    # sidecar under TFTPU_COMPILE_CACHE. TFTPU_REOPT=0 keeps the static
    # cost model: no rewrite, no reordering, no stats recorded or read.
    plan_reopt: bool = _env_bool("TFTPU_REOPT", True)
    # Verified UDF lifting (analysis/lifting + plan/lift): a numpy UDF
    # captured by numpy_udf is inspected, synthesized into a torch
    # Program and verified bit-exactly, on the device the stage runs on,
    # before it replaces the host stage; a verified lift fuses like any
    # other stage. Anything that does not verify stays a counted host
    # stage with its decline reason in TFG112. TFTPU_LIFT=0 runs every
    # UDF as the host stage: the bit-identity oracle.
    udf_lifting: bool = _env_bool("TFTPU_LIFT", True)
    # Root directory of persistent caches: the plan-stats sidecar lives
    # in <dir>/planstats, the registered queries' results in
    # <dir>/results, the dispatch-key store (compilecache/store.py) in
    # <dir>/aot. Empty: all three stay in memory or off.
    compilation_cache_dir: str = os.environ.get("TFTPU_COMPILE_CACHE", "")
    # Byte bound of the dispatch-key store's entries (LRU eviction).
    compile_cache_max_bytes: int = _env_int("TFTPU_COMPILE_CACHE_MAX_MB", 2048) * (1 << 20)
    # Resident-bytes budget of a BlockStore built without one (the
    # chunked readers' ingest, the streaming partitioner): blocks past it
    # spill to disk least-recently-used.
    block_budget_bytes: int = _env_int("TFTPU_BLOCK_BUDGET_MB", 512) * (1 << 20)
    # Parent directory of block stores' private spill directories (empty:
    # the system temp dir). Point at fast local disk in production.
    blockstore_dir: str = os.environ.get("TFTPU_BLOCKSTORE_DIR", "")
    # Fleet heartbeat cadence: a serving replica in a rendezvous dir
    # (TFTPU_FLEET_DIR; ServingFleet arms it for its children) publishes
    # a beat this often ...
    heartbeat_interval_s: float = _env_float("TFTPU_HEARTBEAT_INTERVAL_S", 0.25)
    # ... and one whose newest beat is older than this is declared dead.
    # Must comfortably exceed the longest host-side stall a healthy
    # process can hit (GC, a kernel build, a model's warm-up).
    heartbeat_timeout_s: float = _env_float("TFTPU_HEARTBEAT_TIMEOUT_S", 5.0)
    # Hung-dispatch watchdog (resilience/fleet.py): a collective, a
    # process-group handshake or a fleet barrier past this many seconds
    # raises HungDispatchError with a flight-recorder postmortem naming
    # the unresponsive ranks instead of blocking forever. 0 disables it
    # (a barrier then waits max(4 x heartbeat_timeout_s, 20 s)).
    dispatch_deadline_s: float = _env_float("TFTPU_DISPATCH_DEADLINE_S", 0.0)
    # The mesh axis a sharded frame splits its rows over.
    batch_axis: str = os.environ.get("TFTPU_BATCH_AXIS", "dp")
    # Multi-rank sort_values / join: a frame whose replicated side would
    # exceed this many bytes on every rank takes the hash/range
    # exchange (ops/exchange.py, O(global/P) rows a rank) instead of the
    # replicating plan (allgather sort / broadcast join).
    relational_broadcast_bytes: int = _env_int(
        "TFTPU_RELATIONAL_BROADCAST_MB", 64) * (1 << 20)
    # Kill-switch of that exchange: off, an over-budget replicated plan
    # raises instead.
    relational_exchange: bool = _env_bool("TFTPU_RELATIONAL_EXCHANGE", True)
    # Where verbs execute: "cuda" (the default) or "cpu". With no GPU
    # present, "cuda" raises at the verb call instead of running on the
    # CPU; the CPU is used only when asked for.
    device: str = "cuda"


_config = Config()


def get_config() -> Config:
    return _config


def configure(**kwargs) -> Config:
    """Update global config fields by keyword; returns the live config."""
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"No such config field: {k!r}")
        setattr(_config, k, v)
    return _config


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a verb runs on: the explicit ``device`` argument, else
    ``config.device``. A CUDA device with no GPU present is an error —
    execution never moves to the CPU unless the caller asked for it."""
    dev = torch.device(device if device is not None else _config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False (no GPU visible to this process). Pass device='cpu' to the "
            "verb, or configure(device='cpu'), to run on the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev
