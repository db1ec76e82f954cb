"""On-device keyed aggregation for sharded frames.

The host ``aggregate`` path (verbs.py) gathers a frame's value columns to
one device and encodes its keys on the host. For a sharded frame, whose
rows live on several ranks' devices, this module keeps the values where
they are (the reference's plan, ``tensorframes_tpu/ops/device_agg.py``):

    per-rank dense segment reduction  →  one all-reduce per (op, dtype)

Each rank reduces its local rows into a dense ``[K, ...]`` bucket table
through the port's own keyed reduction (the fused ``segment_reduce``
kernel on a CUDA rank with K ≤ ``MAX_SEGMENTS``, else the documented
``index_add_``/scatter route; :func:`..ops.verbs._segment_tables_device`),
then ``dist.all_reduce`` (SUM, MIN, MAX) merges the tables across ranks.
Sums and means travel as raw accumulator tables with a count table; a
mean divides only after the merge. Empty buckets drop by the merged
counts, and only the small merged table is read back.

Two plans, tried in order:

* **dense span** — integer keys whose mixed-radix span is small
  (``K <= 1<<20`` buckets, ``K × feature-elems <= 1<<24``): bucket ids
  come from device arithmetic on the rank's own key tensors, offset by the
  global minimum (one MIN and one MAX all-reduce), so keys never leave the
  device.
* **dictionary encoding** — other keys (strings, huge-span ints,
  composites): every rank encodes its local key rows on the host, the
  ranks' dictionaries union through one allgather, and the merged dense
  ids feed the same per-rank tables with ``K = #distinct groups``.

Anything else (non-algebraic fetches, ragged values) declines to the
caller's next plan. A host tail block (``to_device``'s remainder rows,
held alike by every rank) folds into the merged table on the host.
"""

from __future__ import annotations

import math
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..parallel.collectives import uniform_ok  # noqa: F401  (the reference's home of the vote)
from ..utils import get_logger
from .keys import group_ids, mixed_radix_strides

logger = get_logger(__name__)

_KEY_LIMIT = 1 << 20          # max dense bucket count
_TABLE_ELEM_LIMIT = 1 << 24   # max K × per-row feature elements

_MERGE_OP = {"reduce_sum": "sum", "reduce_mean": "sum", "reduce_min": "min",
             "reduce_max": "max"}


def _allgather_dicts(local_cols: List[np.ndarray]) -> Tuple[List[np.ndarray], int]:
    """Union every rank's group-key dictionary columns.

    Pickles this rank's dictionary (one array per key column, one row per
    LOCAL distinct group), allgathers it in two phases (sizes, then padded
    payloads), and returns ``(union_cols, offset)``: ``union_cols``
    concatenates every rank's dictionary in rank order and ``offset`` is
    where this rank's entries start."""
    from ..blockstore.store import HOSTGATHER_BYTES
    from ..parallel.collectives import allgather_bytes
    from ..parallel.distributed import process_index

    bufs = allgather_bytes(pickle.dumps(local_cols, protocol=pickle.HIGHEST_PROTOCOL))
    # every rank received every rank's dictionary: the host-gather volume
    # the file shuffle exists to eliminate
    HOSTGATHER_BYTES.inc(float(len(bufs) * max(len(b) for b in bufs)))
    dicts = [pickle.loads(b) for b in bufs]
    me = process_index()
    offset = int(sum(len(d[0]) for d in dicts[:me]))
    union = [
        np.concatenate([np.asarray(d[i]) for d in dicts])
        for i in range(len(local_cols))
    ]
    return union, offset


def extract_local_rows(v):
    """This rank's rows of one block column as host numpy: a host list
    becomes an object array, a tensor comes back from its device. Shared by
    the dictionary plan, the generic multi-rank aggregate and the
    relational verbs."""
    if isinstance(v, list):
        return np.asarray(v, dtype=object) if v else np.empty(0, dtype=object)
    if torch.is_tensor(v):
        return dt.to_numpy(v)
    return np.asarray(v)


def local_blocks(frame) -> list:
    """The blocks whose rows this rank contributes to a fleet-wide union:
    a sharded frame's main block, and its host tail (held alike by every
    rank) on rank 0 only; every block of any other frame."""
    from ..parallel.distributed import process_index

    blocks = frame.blocks()
    if frame.is_sharded and process_index() != 0:
        return blocks[:1]
    return blocks


def gather_local_columns(frame, names) -> Optional[Dict[str, np.ndarray]]:
    """This rank's rows of every named column, concatenated across its
    :func:`local_blocks` — the local half of the distributed relational
    verbs. Returns None when a column cannot be brought to the host here;
    callers MUST vote on that with :func:`uniform_ok` before entering any
    collective."""
    cols: Dict[str, np.ndarray] = {}
    blocks = local_blocks(frame)
    for name in names:
        parts = []
        for b in blocks:
            try:
                parts.append(extract_local_rows(b[name]))
            except Exception:
                return None
        if not parts:
            return None
        if len(parts) == 1:
            cols[name] = parts[0]
        elif any(p.dtype == object for p in parts):
            merged = np.empty(sum(len(p) for p in parts), dtype=object)
            merged[:] = [x for p in parts for x in p]
            cols[name] = merged
        else:
            cols[name] = np.concatenate(parts)
    return cols


def assemble_key_cols(frame, keys, group_key_cols, sel=None):
    """Result key columns from per-key group arrays: optional group
    selection, device keys cast back to their schema dtype (host keys —
    strings — pass through)."""
    key_cols = {}
    for i, k in enumerate(keys):
        vals = group_key_cols[i] if sel is None else group_key_cols[i][sel]
        info = frame.schema[k]
        key_cols[k] = vals.astype(info.dtype.np_dtype) if info.is_device else vals
    return key_cols


def _merge_tables(ops, out_names, tables, counts):
    """All-reduce the ranks' raw tables: one collective per (op, dtype)
    group, the group's tables flattened into one buffer."""
    from ..parallel.collectives import all_reduce

    groups: Dict[tuple, list] = {}
    for x in out_names:
        groups.setdefault((_MERGE_OP[ops[x]], tables[x].dtype), []).append(x)
    groups.setdefault(("sum", counts.dtype), []).append("__count__")
    merged = {}
    for (op, _), names in groups.items():
        ts = [counts if x == "__count__" else tables[x] for x in names]
        flat = torch.cat([t.reshape(-1) for t in ts])
        flat = all_reduce(flat, op)
        lo = 0
        for x, t in zip(names, ts):
            merged[x] = flat[lo:lo + t.numel()].reshape(t.shape)
            lo += t.numel()
    counts = merged.pop("__count__")
    return merged, counts


def _run_tables(frame, ops, out_names, K, ids_dev, main, tail, ids_tail, device):
    """Shared tail of both plans: per-rank tables, the cross-rank merge,
    host fold of the tail block, empty-bucket drop, mean divide. Returns
    ``(sel, out_cols)`` — the surviving bucket ids (ascending, i.e.
    lexicographic key order) and the finished output columns."""
    from .verbs import _on, _segment_tables_device

    ops_key = tuple((x, ops[x]) for x in out_names)
    vals = {x: _on(main[x], device).contiguous() for x in out_names}
    raw, counts = _segment_tables_device(ops_key, K, vals, ids_dev, device)
    raw, counts = _merge_tables(ops, out_names, raw, counts)
    count = dt.to_numpy(counts).astype(np.int64)
    tables = {x: dt.to_numpy(raw[x]) for x in out_names}

    # -- fold the host tail block in (≤ dp-1 rows, the same on every rank)
    if tail is not None and ids_tail is not None and len(ids_tail):
        np.add.at(count, ids_tail, 1)
        for x in out_names:
            v = np.asarray(tail[x]).astype(tables[x].dtype)
            if ops[x] in ("reduce_sum", "reduce_mean"):
                np.add.at(tables[x], ids_tail, v)
            elif ops[x] == "reduce_min":
                np.minimum.at(tables[x], ids_tail, v)
            else:
                np.maximum.at(tables[x], ids_tail, v)

    sel = np.flatnonzero(count > 0)
    out_cols: Dict[str, np.ndarray] = {}
    for x in out_names:
        want = frame.schema[x].dtype.np_dtype
        t = tables[x][sel]
        if ops[x] == "reduce_mean":
            c = count[sel].reshape((-1,) + (1,) * (t.ndim - 1))
            t = t / c
        out_cols[x] = t.astype(want)
    return sel, out_cols


def _local_minmax(cols) -> Tuple[List[int], List[int]]:
    """Each key column's global (min, max): this rank's on its device, then
    a MIN and a MAX all-reduce (an empty rank contributes the identities)."""
    from ..parallel.collectives import all_reduce

    big = torch.iinfo(torch.int64)
    los, his = [], []
    for c in cols:
        if c.numel():
            los.append(c.min().to(torch.int64))
            his.append(c.max().to(torch.int64))
        else:
            los.append(torch.tensor(big.max, dtype=torch.int64, device=c.device))
            his.append(torch.tensor(big.min, dtype=torch.int64, device=c.device))
    lo = all_reduce(torch.stack(los), "min").tolist()
    hi = all_reduce(torch.stack(his), "max").tolist()
    return [int(v) for v in lo], [int(v) for v in hi]


def _aggregate_multiprocess_dict(frame, keys, ops, out_names, main, feat, device):
    """Dictionary plan across ranks: local encode → dictionary allgather
    and merge → global dense ids → the shared table plan. Key columns may
    be process-local host lists (strings) or device tensors; value columns
    stay on their devices throughout."""
    key_local: List[np.ndarray] = []
    ok = True
    for k in keys:
        try:
            key_local.append(extract_local_rows(main[k]))
        except Exception:
            ok = False
            break
    n_local = len(key_local[0]) if ok and key_local else 0
    if ok and any(len(a) != n_local for a in key_local):
        # a host key column whose local rows disagree with this rank's
        # device rows cannot be aligned
        ok = False
    if not uniform_ok(ok):
        return None
    if n_local:
        ids_local, local_dict, k_local = group_ids(key_local)
    else:
        ids_local = np.zeros(0, np.int64)
        local_dict, k_local = [a[:0] for a in key_local], 0
    union_cols, offset = _allgather_dicts(list(local_dict))
    union_ids, group_key_cols, K = group_ids(union_cols)
    if K * feat > _TABLE_ELEM_LIMIT:
        logger.debug(
            "device aggregate: %d groups ×%d feat exceeds the table limit "
            "(multi-rank)", K, feat,
        )
        return None
    gids_local = union_ids[offset:offset + k_local][ids_local].astype(np.int32)
    ids_dev = dt.to_torch(gids_local, device)
    sel, out_cols = _run_tables(frame, ops, out_names, K, ids_dev, main, None, None, device)
    return assemble_key_cols(frame, keys, group_key_cols, sel), out_cols


def try_aggregate_device(
    frame,
    keys: Sequence[str],
    seg_info,
    out_names: Sequence[str],
    device,
) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]:
    """Attempt the sharded device plans (dense span, then dictionary
    encoding). Returns ``(key_cols, out_cols)`` with groups in
    lexicographic key order (the host path's ordering), or None when
    ineligible. Every rank takes the same branch: each gate reads the
    schema or a value every rank agrees on."""
    from ..parallel.distributed import process_count

    if not frame.is_sharded or frame.num_rows == 0:
        return None
    ops = {name: op for name, op, _ in seg_info}
    if any(ops[x] not in _MERGE_OP for x in out_names):
        return None
    blocks = frame.blocks()
    main, tail = blocks[0], (blocks[1] if len(blocks) > 1 else None)
    for x in out_names:
        if isinstance(main[x], list):
            return None
    for k in keys:
        # ragged device key columns can't form ids; host-resident key
        # columns (strings, …) are fine — the dictionary plan takes them
        if isinstance(main[k], list) and frame.schema[k].is_device:
            return None
    tail_rows = len(tail[out_names[0] if out_names else keys[0]]) if tail is not None else 0
    if frame.num_rows - tail_rows == 0:
        return None  # everything in the tail → the host path is already optimal
    feat = 0
    for x in out_names:
        cell = tuple(main[x].shape[1:])
        feat = max(feat, int(np.prod(cell)) if cell else 1)

    dense_eligible = all(
        frame.schema[k].is_device
        and np.issubdtype(frame.schema[k].dtype.np_dtype, np.integer)
        for k in keys
    )
    if dense_eligible:
        # -- plan A: dense mixed-radix span (keys never leave the device) --
        from .verbs import _on

        key_dev = [_on(main[k], device) for k in keys]
        mins, maxs = _local_minmax(key_dev)
        ranges = []
        for i, k in enumerate(keys):
            lo, hi = mins[i], maxs[i]
            if tail is not None and len(tail[k]):
                t = np.asarray(tail[k])
                lo, hi = min(lo, int(t.min())), max(hi, int(t.max()))
            mins[i] = lo
            ranges.append(int(hi - lo + 1))
        # python ints: spans near the int64 limits must not wrap the
        # product and sneak past the eligibility gate
        K = math.prod(ranges)
        if K <= _KEY_LIMIT and K * feat <= _TABLE_ELEM_LIMIT:
            # keys[0] most significant → bucket order == lexicographic order
            strides = mixed_radix_strides(ranges)
            # widen BEFORE the offset subtraction: an int8 key spanning
            # -128..127 must not wrap its 255-wide offset
            ids = None
            for i, kd in enumerate(key_dev):
                part = (kd.to(torch.int64) - mins[i]) * strides[i]
                ids = part if ids is None else ids + part
            ids_dev = ids.to(torch.int32).contiguous()
            ids_tail = None
            if tail is not None:
                ids_tail = np.zeros(len(tail[keys[0]]), np.int64)
                for i, k in enumerate(keys):
                    ids_tail += (np.asarray(tail[k]).astype(np.int64) - mins[i]) * strides[i]
            sel, out_cols = _run_tables(frame, ops, out_names, K, ids_dev, main,
                                        tail, ids_tail, device)
            key_cols: Dict[str, np.ndarray] = {}
            for i, k in enumerate(keys):
                comp = (sel // strides[i]) % ranges[i] + mins[i]
                key_cols[k] = comp.astype(frame.schema[k].dtype.np_dtype)
            return key_cols, out_cols
        logger.debug(
            "device aggregate: key span %d (×%d feat) too large for the "
            "dense plan; trying dictionary encoding", K, feat,
        )

    # -- plan B: dictionary encoding — one host pass over the KEY columns
    # only (values stay on their devices); K = distinct groups ------------
    if process_count() > 1:
        if tail_rows:
            # the multi-rank plan has no tail fold; declining is uniform
            # (every rank holds the same tail)
            return None
        return _aggregate_multiprocess_dict(frame, keys, ops, out_names, main, feat, device)
    key_host: List[np.ndarray] = []
    for k in keys:
        arr = extract_local_rows(main[k])
        if tail is not None and len(tail[k]):
            tarr = extract_local_rows(tail[k])
            if arr.dtype == object or tarr.dtype == object:
                both = np.empty(len(arr) + len(tarr), dtype=object)
                both[:len(arr)] = list(arr)
                both[len(arr):] = list(tarr)
                arr = both
            else:
                arr = np.concatenate([arr, tarr])
        key_host.append(arr)
    ids_all, group_key_cols, K = group_ids(key_host)
    if K * feat > _TABLE_ELEM_LIMIT:
        logger.debug(
            "device aggregate: %d groups ×%d feat exceeds the table limit; "
            "host path", K, feat,
        )
        return None
    main_rows = frame.num_rows - tail_rows
    ids_tail = ids_all[main_rows:] if tail is not None else None
    ids_dev = dt.to_torch(ids_all[:main_rows].astype(np.int32), device)
    sel, out_cols = _run_tables(frame, ops, out_names, K, ids_dev, main, tail, ids_tail, device)
    return assemble_key_cols(frame, keys, group_key_cols, sel), out_cols
