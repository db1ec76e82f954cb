"""Group-key encoding shared by the host aggregate path and the sharded
device plans: key columns → dense group ids in lexicographic group order
(the ordering Catalyst's groupBy output sort matched,
DebugRowOps.scala:583).

Two strategies:

* **dense span** — all-integer keys with a small mixed-radix span use
  pure O(n) arithmetic + bincount; no sort of any kind;
* **dictionary** — anything else encodes via ``np.unique`` per column,
  then a composite code. NaN float keys collapse into ONE group — the
  Catalyst/Spark groupBy convention (NaNs compare equal for grouping).

All arithmetic is performed in int64 regardless of the key column dtype
(an int8 key spanning -128..127 must not wrap its 255-wide offset).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

# max dense bucket count for the arithmetic strategy
DENSE_SPAN_LIMIT = 1 << 20


def group_ids(
    arrs: Sequence[np.ndarray],
) -> Tuple[np.ndarray, List[np.ndarray], int]:
    """Encode parallel key columns into dense group ids.

    Returns ``(seg_ids, group_key_cols, num_groups)`` where ``seg_ids``
    is int64 of row length, ``group_key_cols`` holds one array per input
    column with the key values of each group (lexicographic order), and
    ``num_groups`` is the distinct-group count.
    """
    arrs = [np.asarray(a) for a in arrs]
    if all(np.issubdtype(a.dtype, np.integer) for a in arrs):
        mins = [int(a.min()) for a in arrs]
        ranges = [int(a.max()) - m + 1 for a, m in zip(arrs, mins)]
        K = 1
        for r in ranges:  # python ints: no overflow past the gate
            K *= r
        if K <= DENSE_SPAN_LIMIT:
            comb = arrs[0].astype(np.int64) - mins[0]
            for a, m, r in zip(arrs[1:], mins[1:], ranges[1:]):
                comb = comb * np.int64(r) + (a.astype(np.int64) - m)
            counts = np.bincount(comb, minlength=K)
            present = np.flatnonzero(counts)
            remap = np.empty(K, np.int64)
            remap[present] = np.arange(len(present))
            seg_ids = remap[comb]
            strides = mixed_radix_strides(ranges)
            group_key_cols = [
                ((present // strides[i]) % ranges[i] + mins[i]).astype(
                    arrs[i].dtype
                )
                for i in range(len(arrs))
            ]
            return seg_ids, group_key_cols, len(present)
    if len(arrs) == 1:
        # single key column (the overwhelmingly common group_by shape):
        # the per-column encode IS the final answer — its codes are
        # already dense and lexicographically ordered, so the composite
        # re-unique below would be a redundant O(n log n) sort
        uniq, c = _unique_inverse(arrs[0])
        return c.astype(np.int64), [uniq], len(uniq)
    comb = None
    for a in arrs:
        _, c = _unique_inverse(a)
        c = c.astype(np.int64)
        if comb is None:
            comb = c
        else:
            # comb is densified each step (< n), so comb*radix+c stays
            # within int64 up to ~3e9 rows — no mixed-radix overflow
            _, comb = np.unique(comb, return_inverse=True)
            comb = comb.astype(np.int64) * np.int64(int(c.max()) + 1) + c
    _, first_idx, seg_ids = np.unique(
        comb, return_index=True, return_inverse=True
    )
    # each group's key values = the key tuple at its first occurrence
    group_key_cols = [a[first_idx] for a in arrs]
    return seg_ids.astype(np.int64), group_key_cols, len(first_idx)


def _unique_inverse(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(a, return_inverse=True)`` with a first-appearance
    hash encode for string/object columns: codes remap through an
    argsort of the K uniques (tiny) so the lexicographic-order contract
    holds. Float columns keep numpy for its NaN-collapse convention.
    Object columns encode in the native hash pass (``native.dict_encode``)
    unless ``TFS_TPU_DISABLE_NATIVE=1``; the pure-Python branch has the
    same semantics."""
    if a.dtype == object or a.dtype.kind in ("U", "S"):
        if a.dtype != object:
            # U/S fixed-width strings have no NaN/mixed-type hazards —
            # numpy's sort-based unique is semantically identical
            return np.unique(a, return_inverse=True)
        # Catalyst's grouping convention: NaN keys compare EQUAL (one
        # group). Canonicalize float-NaN cells to one singleton so the
        # dict encode below (which resolves the singleton by identity)
        # sees one key
        mask = a != a  # elementwise: only NaN cells are != themselves
        if np.any(mask):
            a = a.copy()
            a[mask] = math.nan
        from .. import native

        cells = a.tolist()
        enc = native.dict_encode(cells)
        if enc is not None:
            # one native hash pass, the same first-appearance semantics
            codes, uniques = enc
        else:
            # first-appearance encode (np.unique is no substitute here:
            # object-dtype unique compares by == so NaNs never collapse,
            # and mixed-type keys raise on '<')
            table: Dict[object, int] = {}
            codes = np.empty(len(cells), np.int64)
            uniques = []
            for i, v in enumerate(cells):
                code = table.get(v)
                if code is None:
                    code = len(uniques)
                    table[v] = code
                    uniques.append(v)
                codes[i] = code
        k = len(uniques)
        uniq_arr = np.empty(k, dtype=object)
        uniq_arr[:] = uniques
        try:
            order = np.argsort(uniq_arr, kind="stable")
        except TypeError:
            # mixed-type keys (e.g. NaN float among strings) have no
            # '<' order; fall back to a deterministic total order by
            # (type name, repr) — np.unique would just raise here
            order = np.asarray(
                sorted(
                    range(k),
                    key=lambda i: (
                        type(uniques[i]).__name__, repr(uniques[i])
                    ),
                ),
                np.int64,
            )
        rank = np.empty(k, np.int64)
        rank[order] = np.arange(k)
        return uniq_arr[order], rank[codes]
    return np.unique(a, return_inverse=True)


def frame_group_ids(
    frame, keys: Sequence[str]
) -> Tuple[np.ndarray, List[np.ndarray], int]:
    """:func:`group_ids` over ``frame``'s key columns, with a per-frame
    **dictionary cache**: the encode (for string keys, a full hash pass
    over 1M python objects — the measured 6-10x gap between string and
    numeric aggregation) runs ONCE per (frame, key set) and every later
    aggregate/join epilogue on the same materialized frame reuses the
    codes. Frames are immutable once materialized, so the cache can
    never go stale; lazy frames are forced by ``column_values`` first
    and only cached when they ended up materialized. Callers must have
    ruled out the zero-row case (group_ids cannot encode it)."""
    ck = tuple(keys)
    hit = frame_cache_get(frame, ck)
    if hit is not None:
        return hit
    res = group_ids([frame.column_values(k) for k in keys])
    frame_cache_put(frame, ck, res)
    return res


def frame_cache_get(frame, key):
    """Read one entry of a frame's group-ids dictionary cache (None on
    miss / cache absent)."""
    cache = getattr(frame, "_group_ids_cache", None)
    return cache.get(key) if cache is not None else None


def frame_cache_put(frame, key, value) -> None:
    """Store one entry in a frame's group-ids dictionary cache — the
    ONE create/bound/evict policy for every writer (the host encode
    here and the device dictionary plan in ops/device_agg.py), so the
    staleness rule cannot diverge between them: only materialized
    frames cache (their blocks are immutable), and retained encodings
    per frame are bounded."""
    if not getattr(frame, "is_materialized", False):
        return
    cache = getattr(frame, "_group_ids_cache", None)
    if cache is None:
        try:
            cache = frame._group_ids_cache = {}
        except AttributeError:  # pragma: no cover - exotic frames
            return
    if len(cache) >= 8:  # bound retained encodings per frame
        cache.clear()
    cache[key] = value


def mixed_radix_strides(ranges: Sequence[int]) -> List[int]:
    """Strides with the FIRST key most significant, so composite codes
    order lexicographically by key tuple."""
    strides = [1] * len(ranges)
    for i in range(len(ranges) - 2, -1, -1):
        strides[i] = strides[i + 1] * ranges[i + 1]
    return strides
