"""Block-paged KV cache pool: fixed-size pages, per-sequence page tables.

The memory manager half of the iterative decode engine. Device state is
the columnar pool from :func:`~tensorframes_tpu_torch.models.generation.init_paged_kv`
(int8 k/v plus f32 per-slot scales, page-major ``[num_pages, layers,
heads, page_size, head_dim]``), so the pool IS a set of frame columns with
pages as rows (:meth:`PagedKVPool.as_frame`). This class owns the host
side: the free list, per-sequence page ownership, and the page tables the
step functions read through.

Accounting contract: every page except the reserved null page 0 is at all
times in exactly one state — free, or owned by one sequence — and
:meth:`PagedKVPool.check` asserts that partition. Page 0 belongs to
nobody: padding slots and masked prefill positions write their garbage
there, and the attention masks guarantee it is never read unmasked.

The reference's shared prefix pages and host swap wait with the prefix
cache and KV swap (ROADMAP queue 1).
"""

from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np

from . import metrics as m

__all__ = ["PagedKVPool", "PoolAccountingError", "PoolExhaustedError"]


class PoolAccountingError(RuntimeError):
    """A page alloc/free invariant was violated (double free, freeing a
    page the sequence does not own, a corrupted free list) — always a bug,
    never load."""


class PoolExhaustedError(RuntimeError):
    """``alloc`` asked for more pages than are free; the decode engine
    turns this into preemption, never an unbounded wait."""


class PagedKVPool:
    """Fixed-size KV pages and per-sequence page tables over the columnar
    pool state. ``columns`` holds the device tensors (the step functions
    update them in place); everything else is host bookkeeping on the
    engine's scheduling thread (the pool is not itself locked). The
    columns live on ``device`` (default ``config.device``)."""

    def __init__(self, cfg, num_pages: int, page_size: int, max_pages_per_seq: int,
                 device=None):
        from ..models.generation import init_paged_kv

        if max_pages_per_seq < 1:
            raise ValueError(f"max_pages_per_seq must be >= 1, got {max_pages_per_seq}")
        if num_pages < 1 + max_pages_per_seq:
            # the null page plus one full horizon is the floor: below it
            # the OLDEST sequence could fault with nothing left to evict
            raise ValueError(
                f"num_pages={num_pages} cannot hold the null page plus one full "
                f"sequence ({max_pages_per_seq} pages) — an undersized pool could "
                "stall its own oldest sequence; raise num_pages or lower the "
                "decode horizon"
            )
        self.cfg = cfg
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.columns = init_paged_kv(cfg, self.num_pages, self.page_size, device=device)
        self._free: collections.deque = collections.deque(range(1, self.num_pages))
        self._owned: Dict[int, List[int]] = {}
        self._closed = False
        # the free-pages gauge aggregates by delta across live pools
        m.DECODE_FREE_PAGES.inc(len(self._free))

    # -- capacity -----------------------------------------------------------

    @property
    def usable_pages(self) -> int:
        """Allocatable pages (everything but the null page)."""
        return self.num_pages - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocatable(self) -> int:
        """Pages :meth:`alloc` can satisfy right now (the free list; the
        reference adds reclaimable shared prefix pages, which the port
        does not have yet)."""
        return len(self._free)

    def pages_needed(self, n_positions: int) -> int:
        """Pages covering ``n_positions`` KV slots."""
        return -(-int(n_positions) // self.page_size)

    # -- alloc / free -------------------------------------------------------

    def alloc(self, seq: int, n: int) -> List[int]:
        """Give ``n`` pages to sequence ``seq`` (appended to its table).
        Raises :class:`PoolExhaustedError` when fewer are free (nothing is
        partially allocated)."""
        n = int(n)
        if n < 0:
            raise ValueError(f"alloc of {n} pages")
        held = self._owned.setdefault(int(seq), [])
        if len(held) + n > self.max_pages_per_seq:
            raise PoolAccountingError(
                f"sequence {seq} would hold {len(held) + n} pages, over "
                f"max_pages_per_seq={self.max_pages_per_seq}"
            )
        if n > len(self._free):
            raise PoolExhaustedError(
                f"need {n} pages, {len(self._free)} free (of {self.usable_pages} usable)"
            )
        got = [self._free.popleft() for _ in range(n)]
        held.extend(got)
        if not self._closed:
            m.DECODE_FREE_PAGES.dec(n)
        return got

    def free_seq(self, seq: int) -> int:
        """Return every page of ``seq`` to the free list; the count freed
        (0 for a sequence holding nothing). A double free raises
        :class:`PoolAccountingError`."""
        pages = self._owned.pop(int(seq), None)
        if pages is None:
            return 0
        free_set = set(self._free)
        for p in pages:
            if p in free_set or p == 0:
                self._owned[int(seq)] = pages  # restore for postmortem
                raise PoolAccountingError(
                    f"double free: page {p} of sequence {seq} is already free or the "
                    "null page"
                )
        self._free.extend(pages)
        if not self._closed:
            m.DECODE_FREE_PAGES.inc(len(pages))
        return len(pages)

    def seq_pages(self, seq: int) -> List[int]:
        """The sequence's table in position order."""
        return list(self._owned.get(int(seq), ()))

    def table(self, seq: int) -> np.ndarray:
        """The sequence's page table as the step functions take it: int32
        ``[max_pages_per_seq]``, unused tail entries = null page 0."""
        t = np.zeros(self.max_pages_per_seq, np.int32)
        pages = self.seq_pages(seq)
        t[:len(pages)] = pages
        return t

    def null_table(self) -> np.ndarray:
        """An all-null page table — what padding slots carry."""
        return np.zeros(self.max_pages_per_seq, np.int32)

    def close(self) -> None:
        """Withdraw this pool from the process-wide free-pages gauge (the
        engine calls it at stop); accounting keeps working."""
        if not self._closed:
            self._closed = True
            m.DECODE_FREE_PAGES.dec(len(self._free))

    def reopen(self) -> None:
        """Re-enroll in the free-pages gauge (engine restart)."""
        if self._closed:
            self._closed = False
            m.DECODE_FREE_PAGES.inc(len(self._free))

    # -- invariants ---------------------------------------------------------

    def check(self) -> None:
        """Assert the accounting partition: free ∪ owned = pages
        1..num_pages-1, no page in two places, no table over its cap."""
        free = list(self._free)
        free_set = set(free)
        if len(free) != len(free_set):
            raise PoolAccountingError("free list holds a duplicate page")
        owned_all: List[int] = []
        for seq, pages in self._owned.items():
            if len(pages) > self.max_pages_per_seq:
                raise PoolAccountingError(
                    f"sequence {seq} holds {len(pages)} pages > "
                    f"max_pages_per_seq={self.max_pages_per_seq}"
                )
            owned_all.extend(pages)
        owned_set = set(owned_all)
        if len(owned_all) != len(owned_set):
            raise PoolAccountingError("a page is owned by two sequences (or twice by one)")
        if free_set & owned_set:
            raise PoolAccountingError(
                f"pages both free and owned: {sorted(free_set & owned_set)}"
            )
        want = set(range(1, self.num_pages))
        have = free_set | owned_set
        if have != want:
            raise PoolAccountingError(
                f"leaked pages: {sorted(want - have)}; phantom pages: {sorted(have - want)}"
            )

    # -- frame view ---------------------------------------------------------

    def as_frame(self):
        """The pool as a TensorFrame (one row per page, one column per pool
        tensor) — a host snapshot for the data plane and debugging."""
        from ..frame import frame_from_arrays

        return frame_from_arrays(
            {k: v.detach().cpu().numpy() for k, v in self.columns.items()}, num_blocks=1
        )

    def __repr__(self) -> str:  # pragma: no cover - convenience
        return (
            f"PagedKVPool(pages={self.num_pages}, page_size={self.page_size}, "
            f"free={self.num_free}, seqs={len(self._owned)})"
        )
