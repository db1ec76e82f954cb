"""Streaming partitioner: run a lazy verb chain over a frame larger than
host RAM, block by block, with bounded peak RSS.

The reference package's ``blockstore/partitioner.py``. ``stream_chain``
walks a **block source** (the chunked ``io.scan_csv``/``io.scan_parquet``
generators, a :class:`SpilledFrame`, a materialized ``TensorFrame``, or
any iterable of ``{column: array|list}`` blocks) through the
double-buffered ``io.pipeline_iter``, applies the caller's lazy chain to a
one-block frame per chunk — the plan layer fuses each chunk's
map/filter/aggregate run into one program as it does in memory, and the
chain runs on the verbs' device (``config.device``, the card by default)
— and **spills each result block to the block store as it completes**.
Peak RSS is bounded by pipeline depth × chunk bytes + the store's
resident budget, never by the frame size.

Each chunk's chain carries fresh stage programs, so the plan layer's
fused-program cache cannot hit across chunks. The reference clears that
cache every 16 chunks; the port's cache is a bounded LRU of 64 entries
(``plan/lower.py``), which caps the entries a long walk leaves behind by
itself, so nothing is cleared here.

Aggregating chains pass ``fold_fn``: each chunk's chain result is a small
partial table (spilled as it lands); after the walk the partials union
into one frame and ``fold_fn`` merges them — the re-apply-the-combiner
contract (sum / min / max / count; compose a mean from sum and count).
With exactly representable values (integers, integer-valued floats) the
result equals the same chain over the materialized frame bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..utils import get_logger
from .store import BlockRef, BlockStore, _block_rows as _rows_of

logger = get_logger(__name__)


def _host_block(block) -> dict:
    """Bring tensors back to host numpy so the store can encode them
    (lists — host and ragged cells — pass through)."""
    return {
        k: (v if isinstance(v, (list, np.memmap))
            else dt.to_numpy(v) if torch.is_tensor(v) else np.asarray(v))
        for k, v in block.items()
    }


def _empty_block(schema) -> dict:
    return {
        info.name: (
            np.empty((0,), info.dtype.np_dtype) if info.is_device else []
        )
        for info in schema
    }


@dataclass
class SpilledFrame:
    """A frame whose blocks live in a :class:`BlockStore` — the
    out-of-core result handle. ``iter_blocks`` streams blocks back
    (CRC-checked reloads); ``to_frame`` rebuilds a ``TensorFrame``
    (``mmap=True`` maps spilled segments without reading them, so the OS
    page cache owns residency). ``recompute`` optionally maps block ids to
    lineage thunks: a quarantined segment then heals through
    :meth:`BlockStore.get_or_recompute` instead of raising."""

    store: BlockStore
    refs: List[BlockRef]
    schema: object
    owns_store: bool = False
    recompute: dict = field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return sum(r.num_rows for r in self.refs)

    @property
    def num_blocks(self) -> int:
        return len(self.refs)

    def _load(self, ref: BlockRef, mmap: bool) -> dict:
        fn = self.recompute.get(ref.block_id)
        if fn is not None:
            return self.store.get_or_recompute(ref, fn, mmap=mmap)
        return self.store.get(ref, mmap=mmap)

    def iter_blocks(self, mmap: bool = False):
        for ref in self.refs:
            yield self._load(ref, mmap)

    def iter_frames(self, mmap: bool = False):
        """One single-block TensorFrame per stored block."""
        from ..frame import TensorFrame

        for block in self.iter_blocks(mmap=mmap):
            yield TensorFrame([block], self.schema)

    def to_frame(self, mmap: bool = True):
        """Rebuild one TensorFrame over every stored block."""
        from ..frame import TensorFrame

        blocks = [self._load(r, mmap) for r in self.refs]
        return TensorFrame(blocks or [_empty_block(self.schema)], self.schema)

    def drop(self) -> None:
        for ref in self.refs:
            self.store.drop(ref)
        self.refs = []
        if self.owns_store:
            self.store.close()


def stream_chain(
    source: Iterable,
    chain_fn: Optional[Callable] = None,
    fold_fn: Optional[Callable] = None,
    store: Optional[BlockStore] = None,
    prefetch: int = 2,
):
    """Stream ``source`` through ``chain_fn`` chunk by chunk, spilling
    results as they complete.

    ``source`` yields blocks (``{column: array|list}``), or is a
    ``TensorFrame`` or :class:`SpilledFrame`. ``chain_fn(frame) -> frame``
    applies the lazy verb chain to each one-block chunk frame (None =
    identity). Without ``fold_fn`` returns a :class:`SpilledFrame` of the
    result blocks in chunk order. With ``fold_fn`` the per-chunk results
    are partial tables and ``fold_fn(union_frame) -> frame`` merges them
    once at the end; the result comes back forced, the partials dropped.
    A store built here (``store=None``) has ``config.block_budget_bytes``.
    """
    from ..frame import TensorFrame, frame_from_arrays
    from ..io import pipeline_iter

    owns = store is None
    store = store or BlockStore()
    refs: List[BlockRef] = []
    schema = None
    chunks = rows_in = 0

    if isinstance(source, SpilledFrame):
        blocks_iter: Iterable = source.iter_blocks(mmap=True)
    elif hasattr(source, "blocks") and hasattr(source, "schema"):
        blocks_iter = iter(source.blocks())
    else:
        blocks_iter = iter(source)

    try:
        for chunk in pipeline_iter(blocks_iter, size=prefetch,
                                   thread_name="tftorch-stream"):
            f = frame_from_arrays(chunk, num_blocks=1)
            g = chain_fn(f) if chain_fn is not None else f
            out_blocks = g.blocks()
            schema = g.schema
            chunks += 1
            rows_in += _rows_of(chunk)
            for b in out_blocks:
                if _rows_of(b) == 0:
                    continue
                refs.append(store.put(_host_block(b)))
            del f, g, out_blocks, chunk  # release before the next chunk
    except BaseException:
        if owns:
            store.close()
        raise

    if schema is None:
        if owns:
            store.close()
        raise ValueError("stream_chain: source yielded no chunks")
    logger.info(
        "stream_chain: %d chunk(s), %d rows in, %d result block(s), "
        "resident=%d spilled=%d",
        chunks, rows_in, len(refs), store.resident_bytes,
        store.spilled_bytes,
    )

    if fold_fn is None:
        return SpilledFrame(store, refs, schema, owns_store=owns)

    # aggregate epilogue: union the (small) partial tables and merge
    partial_blocks = [store.get(r) for r in refs]
    union = TensorFrame(
        partial_blocks or [_empty_block(schema)], schema
    )
    result = fold_fn(union)
    result.blocks()  # force before the partials are dropped
    for r in refs:
        store.drop(r)
    if owns:
        store.close()
    return result


__all__ = ["SpilledFrame", "stream_chain"]
