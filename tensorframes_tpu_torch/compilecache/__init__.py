"""The serving bucket ladders, stated once; program fingerprints and the
content digests a registered query's result cache keys on
(:mod:`.fingerprint`); the persistent dispatch-key store (:mod:`.store`);
warmup (:mod:`.warmup`); and ``python -m tensorframes_tpu_torch.compilecache``
(:mod:`.cli`: stats / warm / prune / verify).

The store is off by default; ``TFTPU_COMPILE_CACHE=/dir`` (or
``configure(compilation_cache_dir=...)``) turns it on, under ``<dir>/aot``.

The reference package's ``compilecache/warmup.py:138-214``: the
power-of-two lead-dim buckets a serving flush, a decode step's slot count
and a prefill chunk's prompt length pad into. PyTorch compiles nothing
per shape, but the decode engine keeps the ladder: its ``start()`` warms
every point of :func:`decode_warmup_grid` once (paying the kernel build
and the library handles before the first request), and padded shapes
keep a step's work independent of the exact slot count. All three
delegate to :func:`~tensorframes_tpu_torch.ops.executor.bucket_rows` /
:func:`~tensorframes_tpu_torch.ops.executor.bucket_table`, so the ladders
cannot drift apart.
"""

from __future__ import annotations

from typing import Dict, List

from ..ops.executor import bucket_rows, bucket_table


def serving_row_buckets(max_rows: int) -> List[int]:
    """Every ladder bucket up to ``bucket_rows(max_rows)``. Refuses a
    ``max_rows`` above the ladder's top, where ``bucket_rows`` returns
    exact counts that no warmup covers."""
    max_rows = int(max_rows)
    if max_rows < 1:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}")
    table = bucket_table()
    if max_rows > table[-1]:
        raise ValueError(
            f"max_rows={max_rows} exceeds the bucket ladder's top "
            f"({table[-1]}): flush sizes above the ladder dispatch at "
            "exact, unwarmable shapes. Raise TFTPU_MAX_BUCKET_DOUBLINGS"
            "/configure(max_bucket_doublings=) or lower "
            "ServingConfig.max_batch_rows"
        )
    top = bucket_rows(max_rows)
    return [b for b in table if b <= top]


def decode_slot_buckets(max_slots: int) -> List[int]:
    """The slot-count buckets a batched decode step dispatches at: by
    construction :func:`serving_row_buckets`, checked against
    ``bucket_rows`` for every slot count so a fork of either policy fails
    here."""
    buckets = serving_row_buckets(max_slots)
    for n in range(1, int(max_slots) + 1):
        if bucket_rows(n) not in buckets:
            raise AssertionError(
                f"bucket policy drift: bucket_rows({n}) = {bucket_rows(n)} is "
                f"not in the warmed ladder {buckets}"
            )
    return buckets


def decode_warmup_grid(max_slots: int, max_prompt_len: int) -> Dict[str, List[int]]:
    """The slot-count × phase grid a decode engine warms: one decode-step
    shape per slot bucket, one prefill shape per prompt-length bucket."""
    return {
        "decode": decode_slot_buckets(max_slots),
        "prefill": serving_row_buckets(max_prompt_len),
    }


from .fingerprint import FORMAT_VERSION, program_fingerprint  # noqa: E402,F401
from .store import CompileCacheStore, active_store, store_for  # noqa: E402,F401
from .warmup import (  # noqa: E402,F401
    WarmupReport,
    partitioner_row_counts,
    warm_program,
    warmup,
)

__all__ = [
    "FORMAT_VERSION",
    "CompileCacheStore",
    "WarmupReport",
    "active_store",
    "decode_slot_buckets",
    "decode_warmup_grid",
    "partitioner_row_counts",
    "program_fingerprint",
    "serving_row_buckets",
    "store_for",
    "warm_program",
    "warmup",
]
