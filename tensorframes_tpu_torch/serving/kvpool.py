"""Block-paged KV cache pool: fixed-size pages, per-sequence page tables.

The memory manager half of the iterative decode engine. Device state is
the columnar pool from :func:`~tensorframes_tpu_torch.models.generation.init_paged_kv`
(int8 k/v plus f32 per-slot scales, page-major ``[num_pages, layers,
heads, page_size, head_dim]``), so the pool IS a set of frame columns with
pages as rows (:meth:`PagedKVPool.as_frame`). This class owns the host
side: the free list, per-sequence page ownership, the page tables the step
functions read through, and the two extra page lifecycles of the KV
memory hierarchy:

* **shared prefix pages** — read-only pages published into a
  content-addressed index (a hash chain over page-granular token
  prefixes) with per-page refcounts. A sequence whose prompt prefix
  matches a published chain references those pages instead of
  prefilling them again; a page whose refcount drops to 0 stays cached
  (LRU) until :meth:`PagedKVPool.alloc` reclaims it under demand.
* **host-swapped sequences** — :meth:`PagedKVPool.swap_out_seq` moves one
  evicted sequence's page payloads into a
  :class:`~tensorframes_tpu_torch.blockstore.BlockStore` segment (CRC and
  quarantine included) and :meth:`PagedKVPool.swap_in_seq` brings them
  back, so a preempted sequence resumes by restoring its pages instead
  of recomputing them.

Accounting contract: every page except the reserved null page 0 is at all
times in exactly one of three states — free, exclusively owned by one
sequence, or shared with a refcount — and :meth:`PagedKVPool.check`
asserts that partition after any interleaving of join, extend, evict,
share, copy-on-extend and swap. Page 0 belongs to nobody: padding slots
and masked prefill positions write their garbage there, and the attention
masks guarantee it is never read unmasked.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import metrics as m

__all__ = ["PagedKVPool", "PoolAccountingError", "PoolExhaustedError"]


class PoolAccountingError(RuntimeError):
    """A page alloc/free invariant was violated (double free, freeing a
    page the sequence does not own, a corrupted free list) — always a bug,
    never load."""


class PoolExhaustedError(RuntimeError):
    """``alloc`` asked for more pages than are free; the decode engine
    turns this into preemption, never an unbounded wait."""


def _chain_key(prev: bytes, tokens: np.ndarray) -> bytes:
    """One link of the page-granular content address: the hash of a
    page's tokens chained onto the hash of everything before it, so a key
    names the page's tokens and its whole prefix lineage."""
    h = hashlib.sha1(prev)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


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
        # prefix-cache state: a sequence's table is refs (its shared
        # prefix chain) then owned (exclusive pages), in position order
        self._refs: Dict[int, List[int]] = {}
        self._shared_ref: Dict[int, int] = {}          # page -> refcount
        self._shared_lru: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        self._prefix_index: Dict[bytes, int] = {}      # chain key -> page
        # page -> (parent chain key, own chain key, page tokens)
        self._prefix_meta: Dict[int, Tuple[bytes, bytes, bytes]] = {}
        self._prefix_children: Dict[bytes, List[int]] = {}
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
        """Pages :meth:`alloc` can satisfy right now: the free list plus
        cached shared pages nobody references (reclaimable on demand). The
        engine's admission budget and preemption trigger read this."""
        return len(self._free) + len(self._shared_lru)

    @property
    def num_shared(self) -> int:
        """Pages in the shared prefix cache (any refcount)."""
        return len(self._shared_ref)

    def pages_needed(self, n_positions: int) -> int:
        """Pages covering ``n_positions`` KV slots."""
        return -(-int(n_positions) // self.page_size)

    # -- alloc / free -------------------------------------------------------

    def alloc(self, seq: int, n: int) -> List[int]:
        """Give ``n`` exclusive pages to sequence ``seq`` (appended to its
        table after any shared prefix). Reclaims refcount-0 shared pages
        LRU-first when the free list alone cannot cover ``n``; raises
        :class:`PoolExhaustedError` when even that cannot (nothing is
        partially allocated)."""
        n = int(n)
        if n < 0:
            raise ValueError(f"alloc of {n} pages")
        held = self._owned.setdefault(int(seq), [])
        total = len(held) + len(self._refs.get(int(seq), ())) + n
        if total > self.max_pages_per_seq:
            raise PoolAccountingError(
                f"sequence {seq} would hold {total} pages, over "
                f"max_pages_per_seq={self.max_pages_per_seq}"
            )
        if n > len(self._free):
            self._reclaim_shared(n - len(self._free))
        if n > len(self._free):
            raise PoolExhaustedError(
                f"need {n} pages, {len(self._free)} free + {len(self._shared_lru)} "
                f"reclaimable (of {self.usable_pages} usable)"
            )
        got = [self._free.popleft() for _ in range(n)]
        held.extend(got)
        if not self._closed:
            m.DECODE_FREE_PAGES.dec(n)
        return got

    def free_seq(self, seq: int) -> int:
        """Return every exclusive page of ``seq`` to the free list and drop
        its references on shared prefix pages (a shared page at refcount 0
        stays cached until reclaimed). Returns the exclusive count freed
        (0 for a sequence holding nothing). A double free raises
        :class:`PoolAccountingError`."""
        self._release_refs(int(seq))
        pages = self._owned.pop(int(seq), None)
        if pages is None:
            return 0
        free_set = set(self._free)
        for p in pages:
            if p in free_set or p == 0 or p in self._shared_ref:
                self._owned[int(seq)] = pages  # restore for postmortem
                raise PoolAccountingError(
                    f"double free: page {p} of sequence {seq} is already free, "
                    "shared, or the null page"
                )
        self._free.extend(pages)
        if not self._closed:
            m.DECODE_FREE_PAGES.inc(len(pages))
        return len(pages)

    def owned(self, seq: int) -> List[int]:
        """The sequence's exclusive pages in position order."""
        return list(self._owned.get(int(seq), ()))

    def seq_pages(self, seq: int) -> List[int]:
        """The sequence's whole table in position order: shared prefix
        pages first, then its exclusive pages."""
        return list(self._refs.get(int(seq), ())) + list(self._owned.get(int(seq), ()))

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
        """Withdraw this pool from the process-wide gauges (the engine
        calls it at stop); accounting and ``check()`` keep working."""
        if not self._closed:
            self._closed = True
            m.DECODE_FREE_PAGES.dec(len(self._free))
            m.PREFIX_SHARED_PAGES.dec(len(self._shared_ref))

    def reopen(self) -> None:
        """Re-enroll in the process-wide gauges (engine restart)."""
        if self._closed:
            self._closed = False
            m.DECODE_FREE_PAGES.inc(len(self._free))
            m.PREFIX_SHARED_PAGES.inc(len(self._shared_ref))

    # -- content-addressed prefix cache -------------------------------------

    def prefix_match(self, tokens: np.ndarray) -> Tuple[List[int], int, Optional[int], int]:
        """Longest published chain matching ``tokens``' page-granular
        prefix. Returns ``(pages, covered, cow_page, cow_tokens)``:
        ``pages`` are the matched shared pages (covering ``covered``
        tokens), capped so at least one token is always left to compute
        (the engine needs the logits at the last prompt position, and
        computing them writes KV — never into a shared page).

        ``cow_page``, when not None, is a published page whose first
        ``cow_tokens`` tokens equal the whole remaining prompt tail — the
        copy-on-extend candidate: the caller copies it into a fresh
        exclusive page (:meth:`copy_on_extend`) and teacher-forces only the
        final token instead of prefilling the tail."""
        tokens = np.asarray(tokens, np.int32)
        plen = int(tokens.shape[0])
        ps = self.page_size
        limit = max(0, (plen - 1) // ps)
        pages: List[int] = []
        key = b""
        for i in range(limit):
            nxt = _chain_key(key, tokens[i * ps:(i + 1) * ps])
            page = self._prefix_index.get(nxt)
            if page is None:
                break
            pages.append(page)
            key = nxt
        covered = len(pages) * ps
        tail = tokens[covered:]
        r = plen - covered
        cow = None
        if 0 < r <= ps:
            want = np.ascontiguousarray(tail, np.int32).tobytes()
            for cand in self._prefix_children.get(key, ()):
                if self._prefix_meta[cand][2][:len(want)] == want:
                    cow = cand
                    break
        return pages, covered, cow, r

    def prefix_acquire(self, seq: int, pages: List[int]) -> None:
        """Reference ``pages`` (a matched chain, in position order) as
        sequence ``seq``'s shared prefix. Must run before the sequence
        allocates any exclusive page (the table is refs-then-owned)."""
        seq = int(seq)
        if self._refs.get(seq) or self._owned.get(seq):
            raise PoolAccountingError(
                f"sequence {seq} already holds pages; a shared prefix must be "
                "acquired before any alloc"
            )
        if len(pages) > self.max_pages_per_seq:
            raise PoolAccountingError(
                f"prefix of {len(pages)} pages exceeds "
                f"max_pages_per_seq={self.max_pages_per_seq}"
            )
        for p in pages:
            if p not in self._shared_ref:
                raise PoolAccountingError(f"page {p} is not in the shared prefix cache")
            if self._shared_ref[p] == 0:
                self._shared_lru.pop(p, None)
            self._shared_ref[p] += 1
        self._refs[seq] = list(pages)

    def _release_refs(self, seq: int) -> None:
        for p in self._refs.pop(seq, ()):
            c = self._shared_ref.get(p)
            if c is None or c < 1:
                raise PoolAccountingError(
                    f"sequence {seq} released shared page {p} with refcount {c}"
                )
            self._shared_ref[p] = c - 1
            if c == 1:
                # unreferenced but still cached: later prompts can hit it
                # until alloc pressure reclaims it, LRU-first
                self._shared_lru[p] = None

    def publish_prefix(self, seq: int, tokens: np.ndarray) -> int:
        """Turn sequence ``seq``'s freshly prefilled full prompt pages
        into shared prefix-cache pages (the sequence keeps referencing
        them; its ragged tail page, where decode writes land, stays
        exclusive). Publishing stops at the first chain key another
        lineage already indexes: the shared prefix stays contiguous at the
        head of the table. Returns the number of pages published."""
        seq = int(seq)
        tokens = np.asarray(tokens, np.int32)
        ps = self.page_size
        refs = self._refs.setdefault(seq, [])
        owned = self._owned.get(seq, [])
        full = int(tokens.shape[0]) // ps
        key = b""
        for i in range(len(refs)):
            key = _chain_key(key, tokens[i * ps:(i + 1) * ps])
        published = 0
        for i in range(len(refs), full):
            if not owned:
                break
            page_toks = tokens[i * ps:(i + 1) * ps]
            nxt = _chain_key(key, page_toks)
            if nxt in self._prefix_index:
                break
            page = owned.pop(0)
            refs.append(page)
            self._shared_ref[page] = 1
            self._prefix_index[nxt] = page
            self._prefix_meta[page] = (
                key, nxt, np.ascontiguousarray(page_toks, np.int32).tobytes(),
            )
            self._prefix_children.setdefault(key, []).append(page)
            key = nxt
            published += 1
        if published and not self._closed:
            m.PREFIX_SHARED_PAGES.inc(published)
        return published

    def copy_on_extend(self, seq: int, src: int) -> int:
        """Allocate a fresh exclusive page for ``seq`` as the copy target
        of shared page ``src`` (the caller copies the device payload, then
        writes freely into the copy). Accounting only — returns the
        destination page."""
        if src not in self._shared_ref:
            raise PoolAccountingError(f"copy-on-extend source page {src} is not shared")
        return self.alloc(seq, 1)[0]

    def _reclaim_shared(self, n: int) -> int:
        """Evict up to ``n`` refcount-0 shared pages (LRU-first) back to the
        free list, unpublishing them from the content index."""
        evicted = 0
        while evicted < n and self._shared_lru:
            page, _ = self._shared_lru.popitem(last=False)
            if self._shared_ref.pop(page, 0) != 0:
                raise PoolAccountingError(
                    f"shared page {page} on the LRU with a live refcount"
                )
            parent, key, _toks = self._prefix_meta.pop(page)
            self._prefix_index.pop(key, None)
            kids = self._prefix_children.get(parent)
            if kids:
                try:
                    kids.remove(page)
                except ValueError:
                    pass
                if not kids:
                    del self._prefix_children[parent]
            self._free.append(page)
            evicted += 1
        if evicted and not self._closed:
            m.PREFIX_EVICTIONS.inc(evicted)
            m.PREFIX_SHARED_PAGES.dec(evicted)
            m.DECODE_FREE_PAGES.inc(evicted)
        return evicted

    # -- invariants ---------------------------------------------------------

    def check(self) -> None:
        """Assert the accounting partition: free ∪ exclusively owned ∪
        shared = pages 1..num_pages-1 with no page in two states,
        refcounts equal to the references the sequences hold, and the
        content index bijective with the shared set."""
        free = list(self._free)
        free_set = set(free)
        if len(free) != len(free_set):
            raise PoolAccountingError("free list holds a duplicate page")
        owned_all: List[int] = []
        for seq, pages in self._owned.items():
            held = len(pages) + len(self._refs.get(seq, ()))
            if held > self.max_pages_per_seq:
                raise PoolAccountingError(
                    f"sequence {seq} holds {held} pages > "
                    f"max_pages_per_seq={self.max_pages_per_seq}"
                )
            owned_all.extend(pages)
        owned_set = set(owned_all)
        if len(owned_all) != len(owned_set):
            raise PoolAccountingError("a page is owned by two sequences (or twice by one)")
        shared_set = set(self._shared_ref)
        counts: Dict[int, int] = {p: 0 for p in shared_set}
        for seq, pages in self._refs.items():
            for p in pages:
                if p not in shared_set:
                    raise PoolAccountingError(
                        f"sequence {seq} references page {p} which is not in the "
                        "shared set"
                    )
                counts[p] += 1
        for p, want in counts.items():
            if self._shared_ref[p] != want:
                raise PoolAccountingError(
                    f"shared page {p} refcount {self._shared_ref[p]} != {want} "
                    "references held"
                )
        lru_set = set(self._shared_lru)
        zero_set = {p for p, c in self._shared_ref.items() if c == 0}
        if lru_set != zero_set:
            raise PoolAccountingError(
                f"LRU set {sorted(lru_set)} != refcount-0 shared pages {sorted(zero_set)}"
            )
        index_pages = sorted(self._prefix_index.values())
        if index_pages != sorted(set(index_pages)):
            raise PoolAccountingError("the prefix index maps two keys to one page")
        if set(index_pages) != shared_set or set(self._prefix_meta) != shared_set:
            raise PoolAccountingError("prefix index/meta out of step with the shared set")
        overlaps = (free_set & owned_set) | (free_set & shared_set) | (owned_set & shared_set)
        if overlaps:
            raise PoolAccountingError(f"pages in two partition states: {sorted(overlaps)}")
        want = set(range(1, self.num_pages))
        have = free_set | owned_set | shared_set
        if have != want:
            raise PoolAccountingError(
                f"leaked pages: {sorted(want - have)}; phantom pages: {sorted(have - want)}"
            )

    # -- host-swap tier (blockstore-backed) ---------------------------------

    def spill(self, store, swaps: Optional[Dict[str, Dict]] = None,
              swap_store=None) -> Dict[str, object]:
        """Snapshot the whole pool into a
        :class:`~tensorframes_tpu_torch.blockstore.BlockStore`: the device
        columns land as one spilled block (pushed to disk at once: a pool
        snapshot is cold and must not take the store's resident budget),
        the host bookkeeping in the returned snapshot dict.
        :meth:`restore` brings it back bit for bit. Per-sequence swap is
        :meth:`swap_out_seq`.

        ``swaps`` folds per-sequence swap segments into the snapshot so
        they outlive the engine: a mapping of cross-restart identity (the
        request's trace id) → :meth:`swap_out_seq` snapshot. Each segment
        is read (CRC-checked) from ``swap_store`` and published again into
        ``store``; the manifest rides the snapshot's ``"swapped"`` key and
        :meth:`adopt_swapped` re-homes it into a fresh engine's swap store.
        A segment that comes back corrupt is skipped (quarantined and
        counted by the store): its sequence replays on redrive."""
        swapped: Dict[str, Dict] = {}
        if swaps and swap_store is not None:
            for tid, snap in dict(swaps).items():
                try:
                    seg = swap_store.get(snap["ref"])
                except Exception:
                    continue
                entry = {k: v for k, v in snap.items() if k != "ref"}
                entry["ref"] = store.put_spilled(seg)
                swapped[str(tid)] = entry
        block = {k: v.detach().cpu().numpy() for k, v in self.columns.items()}
        ref = store.put(block)
        store.spill(ref)
        return {
            "swapped": swapped,
            "ref": ref,
            "free": list(self._free),
            "owned": {int(s): list(p) for s, p in self._owned.items()},
            # prefix-cache state rides the snapshot: a restored pool keeps
            # every published page addressable
            "refs": {int(s): list(p) for s, p in self._refs.items()},
            "shared_ref": dict(self._shared_ref),
            "shared_lru": list(self._shared_lru),
            "prefix_index": dict(self._prefix_index),
            "prefix_meta": dict(self._prefix_meta),
            "prefix_children": {k: list(v) for k, v in self._prefix_children.items()},
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "max_pages_per_seq": self.max_pages_per_seq,
        }

    def restore(self, store, snapshot: Dict[str, object], swap_store=None) -> Dict[str, Dict]:
        """Rehydrate pool state from a :meth:`spill` snapshot: the column
        block reloads CRC-checked (corruption raises
        ``BlockCorruptionError``, counted and quarantined by the store,
        never served), is copied back onto the pool's device, and the page
        accounting is restored exactly. Geometry mismatches raise before
        anything is touched. Folded per-sequence swap segments are
        re-homed into ``swap_store`` by :meth:`adopt_swapped`, whose
        manifest is returned (``{}`` without a swap store)."""
        for field in ("num_pages", "page_size", "max_pages_per_seq"):
            if int(snapshot[field]) != int(getattr(self, field)):
                raise PoolAccountingError(
                    f"restore into a pool with different {field}: snapshot "
                    f"{snapshot[field]}, pool {getattr(self, field)}"
                )
        block = store.get(snapshot["ref"])
        if set(block) != set(self.columns):
            raise PoolAccountingError(
                f"snapshot columns {sorted(block)} != pool columns {sorted(self.columns)}"
            )
        for k, v in block.items():
            col = self.columns[k]
            col.copy_(torch.as_tensor(np.asarray(v)).to(device=col.device, dtype=col.dtype))
        old_free = len(self._free)
        old_shared = len(self._shared_ref)
        self._free = collections.deque(int(p) for p in snapshot["free"])
        self._owned = {int(s): [int(p) for p in pages]
                       for s, pages in dict(snapshot["owned"]).items()}
        self._refs = {int(s): [int(p) for p in pages]
                      for s, pages in dict(snapshot.get("refs", {})).items()}
        self._shared_ref = {int(p): int(c)
                            for p, c in dict(snapshot.get("shared_ref", {})).items()}
        self._shared_lru = collections.OrderedDict(
            (int(p), None) for p in snapshot.get("shared_lru", ())
        )
        self._prefix_index = dict(snapshot.get("prefix_index", {}))
        self._prefix_meta = {int(p): tuple(v)
                             for p, v in dict(snapshot.get("prefix_meta", {})).items()}
        self._prefix_children = {k: list(v)
                                 for k, v in dict(snapshot.get("prefix_children", {})).items()}
        self.check()
        if not self._closed:
            m.DECODE_FREE_PAGES.inc(len(self._free) - old_free)
            m.PREFIX_SHARED_PAGES.inc(len(self._shared_ref) - old_shared)
        return self.adopt_swapped(store, snapshot, swap_store)

    def adopt_swapped(self, store, snapshot: Dict[str, object], swap_store) -> Dict[str, Dict]:
        """Re-home a :meth:`spill` snapshot's folded per-sequence swap
        segments into a live swap store without touching page state:
        swapped sequences hold no pages (``swap_out_seq`` released them),
        so they are the one part of an engine's KV state that can move
        between engines. Returns ``{trace_id: swap-in snapshot}``, the
        restored engine's parking manifest, consumed as each request is
        redriven. Corrupt segments are skipped (quarantined and counted by
        the store; that redrive replays)."""
        manifest: Dict[str, Dict] = {}
        if swap_store is None:
            return manifest
        for tid, entry in dict(snapshot.get("swapped", {})).items():
            try:
                seg = store.get(entry["ref"])
            except Exception:
                continue
            new = {k: v for k, v in entry.items() if k != "ref"}
            new["ref"] = swap_store.put_spilled(seg)
            if int(new.get("page_size", self.page_size)) != self.page_size:
                swap_store.drop(new["ref"])
                continue
            manifest[str(tid)] = new
        return manifest

    def swap_out_seq(self, store, seq: int, block: Dict[str, np.ndarray]) -> Dict[str, object]:
        """Per-sequence swap-out: publish ``block`` — the sequence's page
        payloads in table order — straight to a CRC-checked disk segment
        (``put_spilled``: a swap segment is cold by definition), then
        release every page the sequence holds (shared refs drop, exclusive
        pages free). Returns the snapshot :meth:`swap_in_seq` needs;
        ``freed`` is the exclusive-page count, for eviction accounting."""
        seq = int(seq)
        pages = self.seq_pages(seq)
        if not pages:
            raise PoolAccountingError(f"swap_out_seq: sequence {seq} holds no pages")
        ref = store.put_spilled(block)
        freed = self.free_seq(seq)
        return {"ref": ref, "pages": len(pages), "freed": freed, "page_size": self.page_size}

    def swap_in_seq(self, store, snapshot: Dict[str, object],
                    seq: int) -> Tuple[List[int], Dict[str, object]]:
        """Per-sequence swap-in: CRC-checked reload of the swap segment
        (corruption quarantines and raises ``BlockCorruptionError`` after
        the snapshot's ref is dropped, so the caller's counted fallback to
        replay starts clean), fresh exclusive pages allocated to ``seq``,
        the segment dropped. Returns ``(pages, block)``; the caller
        scatters the payloads into the pages. The restored sequence owns
        everything exclusively (shared references are not re-acquired:
        re-sharing would need a content re-proof)."""
        from ..blockstore.store import BlockCorruptionError

        if int(snapshot["page_size"]) != self.page_size:
            raise PoolAccountingError(
                f"swap_in_seq: snapshot page_size {snapshot['page_size']} != pool "
                f"page_size {self.page_size}"
            )
        try:
            block = store.get(snapshot["ref"])
        except BlockCorruptionError:
            store.drop(snapshot["ref"])
            raise
        pages = self.alloc(int(seq), int(snapshot["pages"]))
        store.drop(snapshot["ref"])
        return pages, block

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
            f"free={self.num_free}, shared={self.num_shared}, seqs={len(self._owned)})"
        )
