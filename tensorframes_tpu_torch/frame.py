"""The TensorFrame: a block-partitioned columnar container.

The replacement for the reference's Spark ``DataFrame`` (+ the tensor
metadata it smuggles into ``StructField``\\ s). A frame is a list of
*blocks* (≙ Spark partitions); each block maps column name →

* a dense ``numpy.ndarray`` with leading row dim (device columns), or
* a Python list of per-row cells (ragged columns awaiting ``analyze`` /
  per-row execution, and host-only string/binary columns,
  ≙ datatypes.scala:571-622).

Frames are host-resident: blocks move to the device when a verb dispatches
them, and results come back to the host. A *sharded* frame
(:meth:`TensorFrame.to_device`,
:func:`~tensorframes_tpu_torch.parallel.frame_from_process_local`) is the
exception: its first block holds each rank's rows as tensors on the rank's
device (one process, one device, over ``torch.distributed``), an optional
second block the host tail every rank holds alike, and its verbs run
across ranks. Verbs are **lazy**, like the
reference's map verbs under Spark (core.py:232-233): ``map_*`` returns a
frame carrying a pending computation; ``collect()`` / ``blocks()`` forces
it once and caches. With ``plan_fusion`` on (the default), chained verbs
and ``select``/``filter``/``join`` record a logical plan (``_plan``,
:mod:`.plan`) that lowers at force time, so a chain runs as one composed
program per block.

Shape discovery parity:

* ``analyze``  ≙ ExperimentalOperations.deepAnalyzeDataFrame
  (ExperimentalOperations.scala:89-132): full scan, per-cell recursive
  shapes, pointwise merge (disagreement → Unknown), block sizes prepended.
* ``append_shape`` ≙ ExperimentalOperations.appendShape (:53-68).
* ``print_schema`` / ``explain`` ≙ DebugRowOps.explain (:535-552).
* scalar columns need no analysis (ColumnInformation.extractFromRow,
  ColumnInformation.scala:124-138); list columns start with Unknown dims —
  the ArrayType recursion prepending Unknown.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import dtypes as dt
from .config import get_config
from .schema import ColumnInfo, Schema
from .shape import Shape, Unknown, shape_of_nested
from .utils import profiling

# One block: column name -> dense ndarray (lead dim = rows) or list of cells.
Block = Dict[str, Union[np.ndarray, list]]


def _block_num_rows(block: Block) -> int:
    for v in block.values():
        return len(v)
    return 0


def _nested_depth(x) -> int:
    d = 0
    while isinstance(x, (list, tuple)) or (isinstance(x, np.ndarray) and x.ndim > 0):
        if isinstance(x, np.ndarray):
            return d + x.ndim
        if len(x) == 0:
            return d + 1
        d += 1
        x = x[0]
    return d


def _leaf_value(x):
    while isinstance(x, (list, tuple)) and len(x) > 0:
        x = x[0]
    if isinstance(x, np.ndarray):
        while x.ndim > 0:
            if x.shape[0] == 0:
                return x.dtype.type(0)
            x = x[0]
        return x
    return x


def _is_multirank() -> bool:
    from .parallel.distributed import process_count

    return process_count() > 1


def _host_col(v):
    """A block column in host form: tensors come back as numpy."""
    return dt.to_numpy(v) if torch.is_tensor(v) else v


def carry_layout(src, dst, rows_changed: bool = True) -> None:
    """Give ``dst`` the sharded layout of ``src`` (mesh, batch axis,
    process-local columns). A frame whose rows may differ drops the cached
    global row count."""
    mesh = getattr(src, "_mesh", None)
    if mesh is None:
        return
    dst._mesh = mesh
    dst._axis = getattr(src, "_axis", None)
    dst._process_local_cols = frozenset(
        n for n in getattr(src, "_process_local_cols", ()) if n in dst.schema.names
    )
    if not rows_changed and getattr(src, "_global_rows", None) is not None:
        dst._global_rows = src._global_rows


def _spans_error(op_name: str) -> RuntimeError:
    return RuntimeError(
        f"{op_name}: columns span processes — one process cannot "
        f"materialize the global frame. {op_name} before "
        "frame_from_process_local, or reduce with a verb (verbs "
        "run as collectives)."
    )


def _gathered_local_or_raise(frame, names, op_name: str):
    """This rank's rows of ``names`` with the fleet-wide eligibility VOTE
    (one collective): every rank must gather successfully or every rank
    raises — one rank bailing out of a later collective its peers already
    entered would deadlock the fleet. Shared by the exchange-planning ops
    (sort_values / drop_duplicates / repartition_by_key)."""
    from .ops.device_agg import gather_local_columns, uniform_ok

    local = gather_local_columns(frame, names)
    if not uniform_ok(local is not None):
        raise RuntimeError(
            f"{op_name}: some process holds no addressable shard of a "
            "column — re-shard so every process holds rows "
            "(frame_from_process_local)"
        )
    return {n: (list(v) if v.dtype == object else v) for n, v in local.items()}


def _replicated_fleetwide(cols: Dict[str, Union[np.ndarray, list]]) -> bool:
    """True when EVERY rank holds byte-identical local columns (a
    full-content 128-bit blake2b over every column — values, dtypes,
    shapes — allgathered and compared). Judged on ALL columns, not just
    keys: a process-local frame whose key column coincides fleet-wide is
    not replicated. Every rank enters the one allgather, including ranks
    whose local hash failed (their signature marks not-ok). Alone, a
    frame is trivially replicated. Used by drop_duplicates for
    replicated-in → replicated-out semantics."""
    if not _is_multirank():
        return True
    import hashlib

    from .parallel.collectives import allgather_bytes

    def _hash_col(h, v) -> None:
        cells = v if isinstance(v, list) else [v]
        for c in cells:
            a = np.asarray(c)
            h.update(str((a.dtype.str, a.shape)).encode())
            h.update(
                str(a.tolist()).encode() if a.dtype == object
                else np.ascontiguousarray(a).tobytes()
            )

    h, ok = hashlib.blake2b(digest_size=16), b"1"
    try:
        for name in sorted(cols):
            h.update(name.encode())
            _hash_col(h, cols[name])
    except Exception:  # unhashable layout: the exchange is the safe path
        ok = b"0"
    sigs = allgather_bytes(ok + h.digest())
    return all(s[:1] == b"1" for s in sigs) and len(set(sigs)) == 1


def _spanned(name: str, compute, rows_fn):
    """Wrap a pending thunk so forcing it records a profiling span;
    ``rows_fn()`` supplies the INPUT row count at force time, as the
    verbs count rows."""

    def run():
        t0 = time.perf_counter()
        blocks = compute()
        profiling.record(name, time.perf_counter() - t0, rows_fn())
        return blocks

    return run


def _merged_global_columns(frame, names, op_name: str = "collect") -> Dict[str, object]:
    """Concatenate every block of ``names`` into single host columns (a
    list where any block stores the column as cells; device tensors come
    back). A sharded frame across ranks raises the spans-processes
    error: no rank can materialize it."""
    if frame.is_sharded and _is_multirank():
        raise _spans_error(op_name)
    out: Dict[str, object] = {}
    blocks = frame.blocks()
    for name in names:
        vals = [_host_col(b[name]) for b in blocks]
        if any(isinstance(v, list) for v in vals):
            out[name] = [x for v in vals for x in v]
        elif not vals:
            out[name] = np.empty((0,), dtype=frame.schema[name].dtype.np_dtype)
        else:
            arrs = [np.asarray(v) for v in vals]
            out[name] = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
    return out


def _apply_mask(block: Block, names: Sequence[str], mask_name: str) -> Block:
    """Row-subset one block by its computed mask column: bool[rows] masks
    only, loud row-count mismatches, host columns compressed."""
    mask = block[mask_name]
    m = np.asarray(_host_col(mask))
    if m.dtype != np.bool_ or m.ndim != 1:
        raise ValueError(
            f"filter predicate output {mask_name!r} must be bool[rows]; "
            f"got {m.dtype} with shape {m.shape}"
        )
    rows = _block_num_rows({n: block[n] for n in names})
    if m.shape[0] != rows:
        raise ValueError(
            f"filter predicate output {mask_name!r} has {m.shape[0]} "
            f"rows for a block of {rows}"
        )
    out: Block = {}
    for name in names:
        v = block[name]
        if isinstance(v, list):
            out[name] = [x for x, keep in zip(v, m) if keep]
        elif torch.is_tensor(v):
            # a sharded frame's rows stay on their device
            out[name] = v[mask.to(v.device) if torch.is_tensor(mask)
                          else dt.to_torch(m, v.device)]
        else:
            out[name] = np.asarray(v)[m]
    return out


def _take_rows(col, idx):
    if isinstance(col, list):
        return [col[i] for i in idx]
    return col[idx]


# ---------------------------------------------------------------------------
# hash-join core (≙ the reference's _JoinSpec / _key_union_col /
# _hash_join_cols, frame.py:303-530)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _JoinSpec:
    """Normalized description of one hash join, detached from the frames.

    ``lname``/``rname`` map each side's non-key columns to their output
    names (clash suffixes already applied); pair order is output order."""

    keys: Tuple[str, ...]
    how: str  # 'inner' | 'left' | 'outer' ('right' mirrors to 'left')
    lname: Tuple[Tuple[str, str], ...]  # (original, output) left pairs
    rname: Tuple[Tuple[str, str], ...]
    fill_value: object = None

    def fill_for(self, col_name):
        if isinstance(self.fill_value, dict):
            if col_name not in self.fill_value:
                raise ValueError(
                    f"how={self.how!r}: fill_value has no entry for "
                    f"column {col_name!r}"
                )
            return self.fill_value[col_name]
        return self.fill_value

    def checked_fill(self, col_name, np_dtype):
        """The fill cast must be EXACT — a lossy fill (e.g. -1.5 into an
        int column) would corrupt silently."""
        fv = self.fill_for(col_name)
        try:
            cast = np.asarray(fv, np_dtype)
        except (ValueError, TypeError, OverflowError):
            raise ValueError(
                f"how={self.how!r}: fill_value {fv!r} is not exactly "
                f"representable in column {col_name!r}'s dtype "
                f"{np_dtype}"
            ) from None
        same = (
            cast != cast and fv != fv  # NaN fill into a float col
        ) or cast == np.asarray(fv)
        if not bool(same):
            raise ValueError(
                f"how={self.how!r}: fill_value {fv!r} is not exactly "
                f"representable in column {col_name!r}'s dtype "
                f"{np_dtype}"
            )
        return cast


def _key_union_col(lv, rv):
    """One key column's two sides concatenated into the array form the
    group encoder accepts (host list / object columns promote to object
    arrays)."""
    if isinstance(lv, list) or isinstance(rv, list) or (
        getattr(lv, "dtype", None) == object
        or getattr(rv, "dtype", None) == object
    ):
        u = np.empty(len(lv) + len(rv), dtype=object)
        u[: len(lv)] = list(lv)
        u[len(lv):] = list(rv)
        return u
    return np.concatenate([np.asarray(lv), np.asarray(rv)])


def _filled(col, n: int, spec: _JoinSpec, col_name: str):
    """``n`` rows of ``col_name``'s fill, in ``col``'s storage form."""
    if isinstance(col, list):
        return [spec.fill_for(col_name)] * n
    return np.full((n,) + col.shape[1:], spec.checked_fill(col_name, col.dtype),
                   col.dtype)


def _hash_join_cols(lcols: Dict[str, object], rcols: Dict[str, object],
                    spec: _JoinSpec) -> Block:
    """Join two gathered column dicts per ``spec``. Keys encode through
    ``ops/keys.group_ids``; the match expansion is vectorized. Result
    order is pandas-like: left-row order, ties in the right frame's
    stable order; ``outer`` appends unmatched right rows in right
    order."""
    from .ops.keys import group_ids

    keys, how = list(spec.keys), spec.how
    lname = {c: o for c, o in spec.lname if c in lcols}
    rname = {c: o for c, o in spec.rname if c in rcols}
    nl = _block_num_rows({k: lcols[k] for k in keys})
    nr = _block_num_rows({k: rcols[k] for k in keys})
    if (nl == 0 and how != "outer") or (nr == 0 and how == "inner") or (
            nl == 0 and nr == 0):
        # group_ids cannot encode zero rows: an empty inner join
        out0: Block = {k: lcols[k][:0] for k in keys}
        for c, o in lname.items():
            out0[o] = lcols[c][:0]
        for c, o in rname.items():
            out0[o] = rcols[c][:0]
        return out0
    if nl == 0:  # outer join, right rows only: left columns filled
        out0 = {k: rcols[k] for k in keys}
        for c, o in lname.items():
            out0[o] = _filled(lcols[c], nr, spec, c)
        for c, o in rname.items():
            out0[o] = rcols[c]
        return out0
    if nr == 0:  # every left row, right columns filled
        out0 = {k: lcols[k] for k in keys}
        for c, o in lname.items():
            out0[o] = lcols[c]
        for c, o in rname.items():
            out0[o] = _filled(rcols[c], nl, spec, c)
        return out0
    codes, _, num_codes = group_ids(
        [_key_union_col(lcols[k], rcols[k]) for k in keys])
    l_codes, r_codes = codes[:nl], codes[nl:]
    order_r = np.argsort(r_codes, kind="stable")
    counts = np.bincount(r_codes, minlength=num_codes)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    cnt_l = counts[l_codes]
    keep_left = how in ("left", "outer")
    # an unmatched left row of a left/outer join still emits ONE output
    # row, marked ri = -1 so the right columns take the fill
    cnt_eff = np.maximum(cnt_l, 1) if keep_left else cnt_l
    li = np.repeat(np.arange(nl), cnt_eff)
    total = int(cnt_eff.sum())
    offs = np.arange(total) - np.repeat(np.cumsum(cnt_eff) - cnt_eff, cnt_eff)
    base = np.repeat(starts[l_codes], cnt_eff) + offs
    if keep_left:
        matched = np.repeat(cnt_l > 0, cnt_eff)
        safe = np.where(matched, np.clip(base, 0, max(nr - 1, 0)), 0)
        ri = np.where(matched, order_r[safe], -1)
    else:
        ri = order_r[base]  # inner: every expansion matched

    def gather_right(col, col_name):
        if not keep_left:
            return _take_rows(col, ri)
        if isinstance(col, list):
            fv = spec.fill_for(col_name)
            return [col[i] if i >= 0 else fv for i in ri]
        cond = (ri >= 0).reshape((-1,) + (1,) * (col.ndim - 1))
        return np.where(cond, col[np.clip(ri, 0, None)],
                        spec.checked_fill(col_name, col.dtype))

    out: Block = {}
    for k in keys:
        out[k] = _take_rows(lcols[k], li)
    for c, o in lname.items():
        out[o] = _take_rows(lcols[c], li)
    for c, o in rname.items():
        out[o] = gather_right(rcols[c], c)
    if how == "outer":
        # the right rows no left row matched follow, in right order,
        # left columns filled (pandas' sort=False outer)
        matched_r = np.zeros(nr, bool)
        matched_r[ri[ri >= 0]] = True
        extra = np.flatnonzero(~matched_r)
        if len(extra):
            def cat(a, b):
                if isinstance(a, list) or isinstance(b, list):
                    return list(a) + list(b)
                return np.concatenate([a, b])

            for k in keys:
                out[k] = cat(out[k], _take_rows(rcols[k], extra))
            for c, o in lname.items():
                out[o] = cat(out[o], _filled(lcols[c], len(extra), spec, c))
            for c, o in rname.items():
                out[o] = cat(out[o], _take_rows(rcols[c], extra))
    return out


class TensorFrame:
    """A lazy, block-partitioned columnar frame."""

    def __init__(
        self,
        blocks: Optional[List[Block]],
        schema: Schema,
        pending: Optional[Callable[[], List[Block]]] = None,
    ):
        if blocks is None and pending is None:
            raise ValueError("TensorFrame needs blocks or a pending computation")
        self._blocks = blocks
        self._pending = pending
        self.schema = schema
        # serializes first materialization: concurrent consumers force the
        # pending computation exactly once
        self._force_lock = threading.Lock()

    # -- materialization ----------------------------------------------------
    def blocks(self) -> List[Block]:
        """Force and cache the frame's blocks (thread-safe, exactly once)."""
        if self._blocks is None:
            with self._force_lock:
                if self._blocks is None:
                    self._blocks = self._pending()
                    self._pending = None
                    # a recorded plan is spent once the blocks exist:
                    # drop it so the node chain (and through it the
                    # source frame's buffers) is not pinned. Downstream
                    # lazy chains hold their own node references and
                    # re-root here via is_materialized.
                    self._plan = None
        return self._blocks

    @property
    def is_materialized(self) -> bool:
        return self._blocks is not None

    # -- basic accessors ----------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return len(self.blocks())

    @property
    def num_rows(self) -> int:
        """The row count — global for a sharded frame (one all-reduce of
        the ranks' main-block rows, cached; the host tail counted once)."""
        blocks = self.blocks()
        if not self.is_sharded or not _is_multirank():
            return sum(_block_num_rows(b) for b in blocks)
        cached = getattr(self, "_global_rows", None)
        if cached is None:
            from .parallel.collectives import all_reduce

            local = torch.tensor([_block_num_rows(blocks[0]) if blocks else 0],
                                 dtype=torch.int64)
            cached = int(all_reduce(local, "sum")[0]) + sum(
                _block_num_rows(b) for b in blocks[1:])
            self._global_rows = cached
        return cached

    @property
    def estimated_rows(self) -> Optional[int]:
        """Row-count estimate that NEVER forces a lazy frame: exact for
        materialized frames; a lazy chain rooted on a materialized source
        estimates the source's rows when no recorded node can change the
        row count (maps and selects preserve it; filters, joins and
        aggregates are data-dependent). None when unknowable before the
        force. The join-order decision records it."""
        if self.is_materialized:
            return self.num_rows
        node = getattr(self, "_plan", None)
        if node is None:
            return None
        from .plan.ir import resolve_chain

        source, nodes = resolve_chain(node)
        if any(n.kind not in ("map", "select") for n in nodes):
            return None
        if getattr(source, "is_materialized", False):
            return source.num_rows
        return None

    @property
    def estimated_bytes(self) -> Optional[int]:
        """Host-byte estimate of materializing this frame (never forces a
        lazy chain): ``estimated_rows`` × the schema's per-row dense width
        (Unknown cell dims count as 1 — a lower bound). None when the row
        count is unknowable before the force."""
        from .plan.lower import estimate_materialized_bytes

        return estimate_materialized_bytes(self)

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    def __repr__(self) -> str:
        state = "materialized" if self.is_materialized else "lazy"
        return f"TensorFrame({state}, {self.schema!r})"

    # -- conversions --------------------------------------------------------
    def column_values(self, name: str) -> np.ndarray:
        """Concatenate one column across blocks (dense columns only)."""
        info = self.schema[name]
        self._check_global(name)
        parts = []
        for b in self.blocks():
            v = _host_col(b[name])
            if isinstance(v, list):
                v = np.asarray(v, dtype=object) if not info.is_device else np.asarray(v)
            parts.append(v)
        if not parts:
            return np.empty((0,), dtype=info.dtype.np_dtype)
        return np.concatenate(parts, axis=0)

    def _check_global(self, name: str) -> None:
        """Raise the reference's texts where one rank cannot materialize a
        column of a sharded frame across ranks."""
        if not self.is_sharded or not _is_multirank():
            return
        if name in getattr(self, "_process_local_cols", ()):
            raise RuntimeError(
                f"Column {name!r} is process-local (host-only column of a "
                "multi-process frame); one process cannot materialize the "
                "global column. Aggregate by it (the dictionary plan "
                "merges per-process key dictionaries with a collective), "
                "or persist per process with io.save_frame_sharded."
            )
        raise RuntimeError(
            f"Column {name!r} spans processes (multi-host global "
            "array); one process cannot materialize it. Reduce it "
            "with a verb (reduce_blocks/reduce_rows/aggregate run "
            "as collectives without a host gather), or persist per "
            "process with io.save_frame_sharded."
        )

    def collect(self) -> List[Dict[str, object]]:
        """Materialize as a list of row dicts (≙ ``DataFrame.collect``).

        Vector cells come back as numpy arrays; scalars as Python scalars.
        """
        from . import native

        for name in self.schema.names:
            self._check_global(name)
        rows: List[Dict[str, object]] = []
        for b in self.blocks():
            n = _block_num_rows(b)
            cols = {name: _host_col(b[name]) for name in self.schema.names}
            if all(
                isinstance(v, np.ndarray)
                and v.ndim == 1
                and native.supported_dtype(v.dtype)
                for v in cols.values()
            ):
                # all-scalar blocks of the native pass's dtypes materialize
                # as row dicts in one C++ pass (≙ convertBackFast0,
                # DataOps.scala:20-61)
                native_rows = native.columns_to_rows(
                    list(cols.keys()), list(cols.values())
                )
                if native_rows is not None:
                    rows.extend(native_rows)
                    continue
            for i in range(n):
                row = {}
                for name, v in cols.items():
                    cell = v[i]
                    if isinstance(cell, np.ndarray) and cell.ndim == 0:
                        cell = cell.item()
                    elif isinstance(cell, np.generic):
                        cell = cell.item()
                    row[name] = cell
                rows.append(row)
        return rows

    def take(self, n: int) -> List[Dict[str, object]]:
        """First ``n`` rows as dicts without materializing later blocks'
        columns to rows (≙ ``DataFrame.take``)."""
        out: List[Dict[str, object]] = []
        for b in self.blocks():
            m = _block_num_rows(b)
            if m == 0:
                continue
            take_here = min(n - len(out), m)
            small = TensorFrame(
                [{k: _host_col(v[:take_here]) for k, v in b.items()}], self.schema
            )
            out.extend(small.collect())
            if len(out) >= n:
                break
        return out

    def first(self) -> Dict[str, object]:
        for b in self.blocks():
            if _block_num_rows(b) > 0:
                row = {}
                for name in self.schema.names:
                    cell = _host_col(b[name][:1])[0]
                    if not isinstance(cell, (list, str, bytes)):
                        cell = np.asarray(cell)
                        cell = cell.item() if cell.ndim == 0 else cell
                    row[name] = cell
                return row
        raise ValueError("Frame is empty")

    def to_pandas(self):
        import pandas as pd

        data = {}
        for name in self.schema.names:
            self._check_global(name)
            vals = []
            for b in self.blocks():
                vals.extend(list(_host_col(b[name])))
            data[name] = vals
        return pd.DataFrame(data)

    # -- relational transforms (host frames, one process) -----------------
    def select(self, names: Sequence[str]) -> "TensorFrame":
        schema = self.schema.select(names)
        if self.is_materialized:
            out = TensorFrame([{n: b[n] for n in names} for b in self._blocks], schema)
            carry_layout(self, out, rows_changed=False)
            return out
        from .plan import ir as _plan_ir

        if _plan_ir.fusion_enabled() and not self.is_sharded:
            # a pending frame: record the projection on the logical plan
            # — pushdown then prunes dead upstream outputs (and whole
            # stages), so dropped columns are never computed or moved
            node = _plan_ir.PlanNode(
                "select",
                parent=_plan_ir.node_for_parent(self),
                names=list(names),
                schema=schema,
            )

            def pending():
                from .plan.lower import execute_plan

                return execute_plan(node)

            out = TensorFrame(None, schema, pending=pending)
            node.bind(out)
            out._plan = node
            return out
        parent = self
        out = TensorFrame(
            None, schema, pending=lambda: [{n: b[n] for n in names} for b in parent.blocks()]
        )
        carry_layout(self, out)
        return out

    def filter(self, predicate, device=None) -> "TensorFrame":
        """Keep the rows where ``predicate`` is true.

        ``predicate`` is a program like any verb's — a python function
        over block columns (parameter names select columns), DSL nodes,
        or a Program — producing ONE boolean output of shape ``[rows]``.
        The mask computes on the device through ``map_blocks``: only the
        predicate's inputs go up and only the bool mask comes back, and
        the host columns compress by it. Lazy: the mask computes when the
        frame is forced."""
        from .ops.verbs import map_blocks

        masked = map_blocks(predicate, self, device=device)
        out_names = [c.name for c in masked.schema if c.name not in self.schema.names]
        if len(out_names) != 1:
            raise ValueError(
                f"filter predicate must produce exactly one output; got "
                f"{out_names}"
            )
        mname = out_names[0]
        names = list(self.schema.names)
        parent = self
        if getattr(masked, "_plan", None) is not None:
            from .plan import ir as _plan_ir

            # the mask program fuses into the upstream run (one dispatch
            # computes upstream outputs AND the mask); the row subsetting
            # itself splits the plan — its output row count is
            # data-dependent
            node = _plan_ir.PlanNode(
                "filter",
                parent=masked._plan,
                mask_name=mname,
                schema=self.schema,
            )

            def plan_pending():
                from .plan.lower import execute_plan

                return execute_plan(node)

            out = TensorFrame(None, self.schema, pending=plan_pending)
            node.bind(out)
            out._plan = node
            return out

        def compute() -> List[Block]:
            return [_apply_mask(b, names, mname) for b in masked.blocks()]

        out = TensorFrame(
            None, self.schema,
            pending=_spanned("filter", compute, lambda: parent.num_rows),
        )
        # a sharded frame filters each rank's rows on its device: the
        # result stays sharded, its global row count re-reduced
        carry_layout(self, out)
        return out

    def sort_values(self, by, ascending=True) -> "TensorFrame":
        """Rows ordered by one or more key columns (stable: ties keep
        their input order, ascending or descending; multiple keys sort
        lexicographically, first key primary; ``ascending`` one bool or
        one per key). Global across blocks: the result is one block.
        Keys encode to dense codes as ``ops/keys`` groups them (NaNs one
        value, after every number; -0.0 equal to 0.0), and ``np.lexsort``
        orders the codes, negated for a descending key. Lazy."""
        keys = [by] if isinstance(by, str) else list(by)
        for k in keys:
            self.schema[k]  # unknown column: raise now, not at force
        if isinstance(ascending, bool):
            asc = [ascending] * len(keys)
        else:
            asc = [bool(a) for a in ascending]
            if len(asc) != len(keys):
                raise ValueError(
                    f"ascending has {len(asc)} entries for {len(keys)} "
                    "sort keys"
                )
        names = list(self.schema.names)
        parent = self

        def compute() -> List[Block]:
            from .ops.keys import _unique_inverse

            merged = None
            if parent.is_sharded and _is_multirank():
                merged = _sort_exchanged(parent, names, keys, asc)
            elif parent.is_sharded:
                blocks = parent.blocks()
                if len(blocks) == 1 and all(torch.is_tensor(blocks[0][n]) for n in names) \
                        and all(_device_key_ok(blocks[0][k]) for k in keys):
                    # every column on the device, every key numeric: order
                    # and gather there (≙ the reference's device lexsort)
                    return [_device_sorted(blocks[0], names, keys, asc)]
            if merged is None:
                merged = _merged_global_columns(parent, names, "sort_values")
            key_arrs = []
            # lexsort: the LAST key is primary
            for k, k_asc in zip(reversed(keys), reversed(asc)):
                v = merged[k]
                arr = np.asarray(v, dtype=object) if isinstance(v, list) else np.asarray(v)
                if arr.ndim > 1:
                    raise ValueError(
                        f"sort_values: key column {k!r} has non-scalar "
                        f"cells (shape {arr.shape[1:]}); sort keys must "
                        "be scalar columns"
                    )
                # negated dense codes sort descending and keep ties stable
                codes = _unique_inverse(arr)[1]
                key_arrs.append(codes if k_asc else -codes)
            order = np.lexsort(key_arrs)
            return [{name: _take_rows(merged[name], order) for name in names}]

        out = TensorFrame(
            None, self.schema,
            pending=_spanned("sort_values", compute, lambda: parent.num_rows),
        )
        if self.is_sharded and not _is_multirank():
            carry_layout(self, out, rows_changed=False)
        return out

    def limit(self, n: int) -> "TensorFrame":
        """The first ``n`` rows, as a frame (``take`` returns rows). Lazy."""
        if n < 0:
            raise ValueError(f"limit must be >= 0, got {n}")
        names = list(self.schema.names)
        parent = self

        def compute() -> List[Block]:
            if parent.is_sharded and _is_multirank():
                raise RuntimeError(
                    "limit: columns span processes — one process "
                    "cannot materialize the global head. Limit "
                    "before frame_from_process_local."
                )
            remaining = n
            out_blocks: List[Block] = []
            for b in parent.blocks():
                if remaining <= 0:
                    break
                take_n = min(_block_num_rows(b), remaining)
                # slice first: a device column moves only the kept rows
                out_blocks.append({name: _host_col(b[name][:take_n]) for name in names})
                remaining -= take_n
            if not out_blocks:
                out_blocks = [{name: _host_col(b[name][:0]) for name in names}
                              for b in parent.blocks()[:1]]
            return out_blocks

        return TensorFrame(None, self.schema, pending=compute)

    def join(
        self,
        other: "TensorFrame",
        on,
        how: str = "inner",
        suffixes: Tuple[str, str] = ("_x", "_y"),
        fill_value=None,
    ) -> "TensorFrame":
        """Hash join on one or more key columns. Keys encode through
        ``ops/keys`` (any key type joins) and the match expansion is
        vectorized. Result order is pandas-like: left-row order, ties in
        the right frame's stable order. Non-key columns sharing a name
        take ``suffixes``.

        ``how="left"`` keeps unmatched left rows; their right-side columns
        take ``fill_value`` (a scalar, or a dict keyed by the right
        column's ORIGINAL name) — explicit fills instead of NaN, which
        would retype integer columns. ``how="right"`` mirrors it.
        ``how="outer"`` keeps both: matched and unmatched-left rows in
        left order, then unmatched right rows in right order;
        ``fill_value`` must cover the non-key columns of BOTH sides.
        Lazy; returns one block."""
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(
                f"join supports how='inner'/'left'/'right'/'outer' "
                f"(got {how!r})"
            )
        keys = [on] if isinstance(on, str) else list(on)
        if how == "right":
            # the left join with the sides (and suffix roles) swapped;
            # select() restores keys + left + right column order. The fill
            # is checked here so errors name how='right' and this frame's
            # columns
            if fill_value is None:
                raise ValueError(
                    "how='right' needs fill_value (scalar or "
                    "{column: value}) for unmatched rows' LEFT-side "
                    "columns — explicit fills instead of NaN, which "
                    "would retype integer columns"
                )
            if isinstance(fill_value, dict):
                missing_r = [c for c in self.schema.names
                             if c not in keys and c not in fill_value]
                if missing_r:
                    raise ValueError(
                        f"how='right': fill_value has no entry for "
                        f"LEFT-side column(s) {missing_r} (unmatched "
                        "right rows fill the left frame's columns)"
                    )
            swapped = other.join(self, on=on, how="left",
                                 suffixes=(suffixes[1], suffixes[0]),
                                 fill_value=fill_value)
            l_only = [c for c in self.schema.names if c not in keys]
            r_only = [c for c in other.schema.names if c not in keys]
            clash = set(l_only) & set(r_only)
            return swapped.select(
                keys
                + [c + suffixes[0] if c in clash else c for c in l_only]
                + [c + suffixes[1] if c in clash else c for c in r_only]
            )
        if how in ("left", "outer") and fill_value is None:
            raise ValueError(
                f"how={how!r} needs fill_value (scalar or "
                "{column: value}) for unmatched rows' columns — "
                "explicit fills instead of NaN, which would retype "
                "integer columns"
            )
        for k in keys:
            self.schema[k]
            other.schema[k]
        left_only = [c for c in self.schema.names if c not in keys]
        right_only = [c for c in other.schema.names if c not in keys]
        clashes = set(left_only) & set(right_only)
        lname = {c: (c + suffixes[0] if c in clashes else c) for c in left_only}
        rname = {c: (c + suffixes[1] if c in clashes else c) for c in right_only}
        need_fill = []  # (column, info) an unmatched row fills
        if how in ("left", "outer"):
            need_fill = [(c, other.schema[c]) for c in right_only]
            if how == "outer":
                need_fill += [(c, self.schema[c]) for c in left_only]
        if isinstance(fill_value, dict):
            missing_fills = [c for c, _ in need_fill if c not in fill_value]
            if missing_fills:
                raise ValueError(
                    f"how={how!r}: fill_value has no entry for "
                    f"column(s) {missing_fills}"
                )
        schema = Schema(
            [self.schema[k] for k in keys]
            + [self.schema[c].with_name(lname[c]) for c in left_only]
            + [other.schema[c].with_name(rname[c]) for c in right_only]
        )
        spec = _JoinSpec(
            keys=tuple(keys), how=how,
            lname=tuple((c, lname[c]) for c in left_only),
            rname=tuple((c, rname[c]) for c in right_only),
            fill_value=fill_value,
        )
        # a lossy fill fails at the call, for every device column it fills
        for c, info in need_fill:
            if info.is_device and info.dtype.np_dtype is not None:
                spec.checked_fill(c, np.dtype(info.dtype.np_dtype))
        left, right = self, other
        from .plan import ir as _plan_ir

        if _plan_ir.fusion_enabled() and not left.is_sharded and not right.is_sharded:
            # the hash join ENTERS the plan: upstream probe-side maps
            # fuse into the probe dispatch, and the needed-columns pass
            # prunes through the join on both sides (a column no
            # downstream select/aggregate reads is never computed,
            # gathered or match-expanded)
            node = _plan_ir.PlanNode(
                "join",
                parent=_plan_ir.node_for_parent(self),
                right=other,
                spec=spec,
                schema=schema,
            )

            def plan_pending():
                from .plan.lower import execute_plan

                return execute_plan(node)

            out = TensorFrame(None, schema, pending=plan_pending)
            node.bind(out)
            out._plan = node
            return out

        def compute() -> List[Block]:
            if _is_multirank() and (left.is_sharded or right.is_sharded):
                return [_join_across_ranks(left, right, keys, how, spec)]
            return [_hash_join_cols(
                _merged_global_columns(left, left.schema.names, "join"),
                _merged_global_columns(right, right.schema.names, "join"), spec)]

        return TensorFrame(
            None, schema,
            pending=_spanned("join", compute, lambda: left.num_rows + right.num_rows),
        )

    def drop_duplicates(self, subset=None) -> "TensorFrame":
        """Rows with duplicate keys removed, the FIRST occurrence kept in
        row order (pandas ``drop_duplicates(keep="first")``). ``subset``
        names the key columns (default: every column); keys must be
        scalar columns, and NaNs compare equal. Lazy; one block."""
        keys = (list(self.schema.names) if subset is None
                else ([subset] if isinstance(subset, str) else list(subset)))
        for k in keys:
            self.schema[k]
        names = list(self.schema.names)
        parent = self

        def compute() -> List[Block]:
            from .ops.keys import group_ids

            if _is_multirank():
                # REPLICATED frames (identical columns on every rank,
                # proven by one blake2b allgather — a uniform collective)
                # dedup locally: replicated in, replicated out. Everything
                # else exchanges: duplicates colocate under the content
                # hash, so each rank's dedup of its partition is the
                # global dedup, keep-first in (source rank, local row)
                # order. A sharded frame is never replicated.
                from .ops import exchange as xch
                from .parallel.distributed import process_count

                local = _gathered_local_or_raise(parent, names, "drop_duplicates")
                if not parent.is_sharded and _replicated_fleetwide(local):
                    cols = local
                else:
                    part = xch.partition_by_hash([local[k] for k in keys], process_count())
                    cols = xch.exchange_rows(local, part)
            else:
                cols = _merged_global_columns(parent, names, "drop_duplicates")
            key_arrs = []
            for k in keys:
                v = cols[k]
                arr = np.asarray(v, dtype=object) if isinstance(v, list) else np.asarray(v)
                if arr.ndim > 1:
                    raise ValueError(
                        f"drop_duplicates: key column {k!r} has "
                        f"non-scalar cells (shape {arr.shape[1:]}); "
                        "pass subset= naming scalar columns"
                    )
                key_arrs.append(arr)
            if len(key_arrs[0]) == 0:
                return [dict(cols)]
            codes, _, _ = group_ids(key_arrs)
            # first occurrence per group, back in row order
            keep = np.sort(np.unique(codes, return_index=True)[1])
            return [{name: _take_rows(cols[name], keep) for name in names}]

        return TensorFrame(
            None, self.schema,
            pending=_spanned("drop_duplicates", compute, lambda: parent.num_rows),
        )

    def distinct(self) -> "TensorFrame":
        """Spark-name alias for :meth:`drop_duplicates` over every column."""
        return self.drop_duplicates()

    def repartition_by_key(self, on) -> "TensorFrame":
        """Hash-partition rows by key across the ranks (≙ Spark's
        ``repartition(col)`` exchange): afterwards every row whose key
        hashes to rank p lives ON rank p, as a process-local host frame,
        in (source rank, local row) order. Frames repartitioned on the same
        key are co-partitioned: joining or aggregating them afterwards runs
        rank-locally with no further collective. The partitioner is
        :func:`~tensorframes_tpu_torch.ops.exchange.partition_by_hash`, the
        over-budget shuffle join's. EAGER (the exchange runs now); alone, a
        frame returns itself. The result's ``num_rows`` is the local
        partition's. Do NOT call this on a replicated frame (every rank
        holding the whole frame) or each row arrives P times; a warning
        fires when the local rows look identical on every rank."""
        keys = [on] if isinstance(on, str) else list(on)
        for k in keys:
            self.schema[k]
        if not _is_multirank():
            return self
        import zlib

        from .ops import exchange as xch
        from .parallel.collectives import allgather_bytes
        from .parallel.distributed import process_count

        names = list(self.schema.names)
        local = _gathered_local_or_raise(self, names, "repartition_by_key")
        # replication tripwire: checksum a bounded key sample and compare
        # across ranks; identical partitions CAN be legitimate, so warn
        probe = xch.content_hash64([local[k] for k in keys])[:1024]
        crc = zlib.crc32(probe.tobytes()) if len(probe) else 0
        crcs = allgather_bytes(str(crc).encode())
        if len(probe) and len(set(crcs)) == 1:
            from .utils import get_logger

            get_logger(__name__).warning(
                "repartition_by_key: every process holds identical-"
                "looking local rows — if this frame is REPLICATED "
                "(e.g. an under-budget multi-process sort_values "
                "result), the exchange will duplicate each row "
                "process_count times; repartition the original "
                "sharded frame instead"
            )
        t_x = time.perf_counter()
        part = xch.partition_by_hash([local[k] for k in keys], process_count())
        recv = xch.exchange_rows(local, part)
        profiling.record("repartition_by_key", time.perf_counter() - t_x,
                         _block_num_rows(recv))
        return TensorFrame([{n: recv[n] for n in names}], self.schema)

    def with_column_renamed(self, old: str, new: str) -> "TensorFrame":
        schema = Schema([c.with_name(new) if c.name == old else c for c in self.schema])
        parent = self
        out = TensorFrame(
            None, schema,
            pending=lambda: [{(new if k == old else k): v for k, v in b.items()}
                             for b in parent.blocks()],
        )
        carry_layout(self, out, rows_changed=False)
        if old in getattr(self, "_process_local_cols", ()):
            out._process_local_cols = out._process_local_cols | {new}
        return out

    def alias_column(self, name: str, alias: str) -> "TensorFrame":
        """Duplicate a column under a new name (≙ ``df.select(y,
        y.alias("z"))`` in the README reduce example, README.md:114)."""
        schema = self.schema.append([self.schema[name].with_name(alias)])
        parent = self
        out = TensorFrame(
            None, schema,
            pending=lambda: [dict(b, **{alias: b[name]}) for b in parent.blocks()],
        )
        carry_layout(self, out, rows_changed=False)
        if name in getattr(self, "_process_local_cols", ()):
            out._process_local_cols = out._process_local_cols | {alias}
        return out

    def repartition(self, num_blocks: int) -> "TensorFrame":
        """Re-chunk rows into ``num_blocks`` roughly equal blocks."""
        merged = _merged_global_columns(self, self.schema.names, "repartition")
        total = len(next(iter(merged.values()))) if merged else 0
        out = TensorFrame(
            [{k: v[lo:hi] for k, v in merged.items()}
             for lo, hi in _partition_bounds(total, num_blocks)],
            self.schema,
        )
        from .plan import ir as _plan_ir

        _plan_ir.mark_barrier(out, "repartition materialization", self)
        return out

    def cache(self) -> "TensorFrame":
        self.blocks()
        return self

    def save(self, path: str) -> "TensorFrame":
        """Persist to ``path`` (see ``io.save_frame``); returns self."""
        from .io import save_frame

        save_frame(self, path)
        return self

    def spill_to(self, store) -> "object":
        """Spill this frame's blocks into a
        :class:`~tensorframes_tpu_torch.blockstore.BlockStore` and return
        the :class:`~tensorframes_tpu_torch.blockstore.SpilledFrame` handle
        (blocks past the store's budget land on disk; ``to_frame`` rebuilds
        over memmap views). Forces a lazy chain."""
        from .blockstore.partitioner import SpilledFrame

        for name in self.schema.names:
            self._check_global(name)
        refs = []
        for b in self.blocks():
            refs.append(store.put({
                name: v if isinstance(v, list) else np.asarray(_host_col(v))
                for name, v in b.items()
            }))
        return SpilledFrame(store, refs, self.schema)

    # -- device placement -------------------------------------------------
    @property
    def is_sharded(self) -> bool:
        """True when the frame's rows live on the ranks' devices over a mesh."""
        return getattr(self, "_mesh", None) is not None

    @property
    def mesh(self):
        return getattr(self, "_mesh", None)

    def to_device(self, mesh=None, axis: Optional[str] = None) -> "TensorFrame":
        """Shard the frame over a mesh of ranks (≙ a Spark DataFrame's
        partitions living on executors): every rank calls this on the same
        frame, and rank r keeps rows ``[r·n_main/dp, (r+1)·n_main/dp)``
        of every dense device column as tensors on its device, where
        ``n_main`` is the row count rounded down to a multiple of the batch
        axis size ``dp``. The ``n_main < total`` remainder stays a small
        host tail block every rank holds alike, so no padding touches a
        reduction. Host-only and ragged columns ride along as each rank's
        own rows (process-local). Chained map verbs never leave the
        device."""
        from .config import resolve_device
        from .parallel.distributed import process_index, rank_device
        from .parallel.mesh import make_mesh

        mesh = mesh or make_mesh()
        axis = axis or get_config().batch_axis
        dp = mesh.shape[axis]
        where = np.argwhere(mesh.devices == process_index())
        if not len(where):
            raise ValueError(
                f"to_device: rank {process_index()} is not in the mesh {mesh!r}")
        pos = int(where[0][mesh.axis_names.index(axis)])
        dev = resolve_device(rank_device())
        names = list(self.schema.names)
        merged = _merged_global_columns(self, names, "to_device")
        total = _block_num_rows(merged)
        n_main = (total // dp) * dp
        lo, hi = pos * (n_main // dp), (pos + 1) * (n_main // dp)
        main: Block = {}
        tail: Block = {}
        host_cols = set()
        for info in self.schema:
            v = merged[info.name]
            if info.is_device and isinstance(v, np.ndarray) and v.dtype != object:
                main[info.name] = dt.to_torch(np.ascontiguousarray(v[lo:hi]), dev)
            else:
                v = list(v)
                main[info.name] = v[lo:hi]
                host_cols.add(info.name)
            if n_main < total:
                tail[info.name] = v[n_main:]
        out = TensorFrame([main] + ([tail] if n_main < total else []), self.schema)
        out._mesh = mesh
        out._axis = axis
        out._process_local_cols = frozenset(host_cols)
        return out

    def to_host(self, num_blocks: Optional[int] = None) -> "TensorFrame":
        """Materialize device columns back to host numpy blocks. Across
        ranks a sharded frame comes back as this rank's rows (the host
        tail on rank 0), a process-local frame: the ranks' results
        together are the global frame."""
        from .ops.device_agg import local_blocks

        blocks = local_blocks(self) if _is_multirank() else self.blocks()
        frame = TensorFrame(
            [{k: _host_col(v) for k, v in b.items()} for b in blocks], self.schema)
        if num_blocks:
            frame = frame.repartition(num_blocks)
        from .plan import ir as _plan_ir

        # explicit materialization: downstream chains re-root here
        _plan_ir.mark_barrier(frame, "to_host/to_numpy materialization", self)
        return frame

    # -- verb methods (≙ Implicits.RichDataFrame, dsl/Implicits.scala:25-100)
    def map_blocks(self, fetches, feed_dict=None, trim: bool = False,
                   strict: bool = False, device=None):
        from .ops.verbs import map_blocks

        return map_blocks(fetches, self, feed_dict=feed_dict, trim=trim,
                          strict=strict, device=device)

    def map_blocks_trimmed(self, fetches, feed_dict=None, strict: bool = False,
                           device=None):
        """≙ ``mapBlocksTrimmed`` (dsl/Implicits.scala:49-55)."""
        return self.map_blocks(fetches, feed_dict=feed_dict, trim=True,
                               strict=strict, device=device)

    def map_rows(self, fetches, feed_dict=None, strict: bool = False, device=None):
        from .ops.verbs import map_rows

        return map_rows(fetches, self, feed_dict=feed_dict, strict=strict,
                        device=device)

    def reduce_rows(self, fetches, strict: bool = False, device=None):
        from .ops.verbs import reduce_rows

        return reduce_rows(fetches, self, strict=strict, device=device)

    def reduce_blocks(self, fetches, strict: bool = False, device=None):
        from .ops.verbs import reduce_blocks

        return reduce_blocks(fetches, self, strict=strict, device=device)

    def analyze(self) -> "TensorFrame":
        """≙ ``RichDataFrame.analyze`` (dsl/Implicits.scala:69-71)."""
        return analyze(self)

    def explain_tensors(self) -> str:
        """≙ ``explainTensors`` (dsl/Implicits.scala:77-79)."""
        return explain(self)

    def explain(self, detailed: bool = False, analyze: bool = False) -> str:
        """Schema + tensor metadata rendering; ``detailed=True`` adds
        the physical layout. ``analyze=True`` is EXPLAIN ANALYZE: it
        appends the plan tree annotated with the per-stage profile the
        frame's last adaptive execution recorded (see
        :func:`tensorframes_tpu_torch.explain_plan`)."""
        return explain(self, detailed=detailed, analyze=analyze)

    def group_by(self, *keys: str) -> "GroupedData":
        """Group rows by key column(s) for keyed ``aggregate``
        (≙ ``df.groupBy("key")`` feeding ``tfs.aggregate``, core.py:401-419)."""
        for k in keys:
            self.schema[k]  # raises with available columns if missing
        return GroupedData(self, list(keys))


class GroupedData:
    """A frame grouped by key columns (≙ ``RelationalGroupedDataset``;
    the reference reflects the backing frame out of it,
    DebugRowOps.scala:714-737 — here it is just a field)."""

    def __init__(self, frame: "TensorFrame", keys: List[str]):
        self.frame = frame
        self.keys = keys

    def aggregate(self, fetches, strict: bool = False, device=None) -> "TensorFrame":
        """≙ ``RichRelationalGroupedDataset.aggregate``
        (dsl/Implicits.scala:107-116)."""
        from .ops.verbs import aggregate

        return aggregate(fetches, self, strict=strict, device=device)

    def count(self, device=None) -> "TensorFrame":
        """Rows per key (the ``groupBy().count()`` affordance): a DSL
        ``reduce_sum`` over an int64 ones column through ``aggregate``,
        so the keyed segment route runs it."""
        from . import dsl
        from .ops.verbs import aggregate

        def ones_for(b):
            on = next((v.device for v in b.values() if torch.is_tensor(v)), None)
            n = _block_num_rows(b)
            # a sharded frame's main block counts on its device
            return (np.ones(n, np.int64) if on is None
                    else torch.ones(n, dtype=torch.int64, device=on))

        ones = TensorFrame(
            [dict(b, count_tmp=ones_for(b)) for b in self.frame.blocks()],
            self.frame.schema.append(
                [ColumnInfo("count_tmp", dt.int64, Shape((Unknown,)))]
            ),
        )
        carry_layout(self.frame, ones, rows_changed=False)
        with dsl.with_graph():
            cnt_in = dsl.block(ones, "count_tmp", tf_name="count_tmp_input")
            cnt = dsl.reduce_sum(cnt_in, axis=0, name="count_tmp")
        out = aggregate(cnt, GroupedData(ones, self.keys), device=device)
        return out.with_column_renamed("count_tmp", "count")

    def __repr__(self):
        return f"GroupedData(keys={self.keys}, {self.frame!r})"


# ---------------------------------------------------------------------------
# sorts and joins across ranks
# ---------------------------------------------------------------------------

# crossing config.relational_broadcast_bytes flips the multi-rank
# sort_values result LAYOUT (replicated under it, each rank's key range
# over it): programs written against the replicated contract get a
# runtime signal the first time it happens
_SORT_LAYOUT_LOCK = threading.Lock()
_sort_layout_warned = False


def _warn_sort_layout_switch(gbytes: int, budget: int) -> None:
    """One-time (per process) tripwire for the replicated → range-
    partitioned sort_values layout switch."""
    global _sort_layout_warned
    with _SORT_LAYOUT_LOCK:
        if _sort_layout_warned:
            return
        _sort_layout_warned = True
    from .utils import get_logger

    get_logger(__name__).warning(
        "sort_values: frame (%s bytes global) exceeds "
        "config.relational_broadcast_bytes (%s) — switching from the "
        "REPLICATED plan to the range-partitioned exchange: each "
        "process now holds only ITS key range (O(global/P) rows), not "
        "the full sorted frame. collect()/num_rows are per-process "
        "under this layout; concatenating the processes' results in "
        "process order is the global sort order. Raise the budget "
        "(TFTPU_RELATIONAL_BROADCAST_MB) to keep the replicated "
        "contract. (This tripwire fires once per process.)",
        f"{gbytes:,}", f"{budget:,}",
    )


def _object_arrays(cols: Dict[str, object]) -> Dict[str, np.ndarray]:
    return {n: (np.asarray(v, dtype=object) if isinstance(v, list) else v)
            for n, v in cols.items()}


def _sort_exchanged(frame, names, keys, asc) -> Dict[str, object]:
    """The rows a multi-rank sort_values sorts on this rank: under
    ``config.relational_broadcast_bytes`` every rank's rows allgathered in
    rank order (every rank then holds the whole sorted frame); over it the
    RANGE EXCHANGE: rank p receives only the p-th key range, so the ranks'
    results in rank order are the global sort order, ties stable (the
    exchange keeps (source rank, local row) order)."""
    from .config import get_config
    from .ops import exchange as xch
    from .ops.device_agg import _allgather_dicts
    from .parallel.distributed import process_count

    local = _gathered_local_or_raise(frame, names, "sort_values")
    cfg = get_config()
    # the global-bytes estimate is a collective: every rank takes the
    # same branch
    gbytes = xch.global_frame_bytes(local)
    if gbytes > cfg.relational_broadcast_bytes:
        if not cfg.relational_exchange:
            raise RuntimeError(
                f"sort_values: replicating {gbytes:,} bytes "
                "on every process exceeds "
                "config.relational_broadcast_bytes "
                f"({cfg.relational_broadcast_bytes:,}) and "
                "the exchange path is disabled "
                "(config.relational_exchange=False / "
                "TFTPU_RELATIONAL_EXCHANGE=0) — raise the "
                "budget, re-enable the exchange, or sort a "
                "projected/filtered frame"
            )
        _warn_sort_layout_switch(gbytes, cfg.relational_broadcast_bytes)
        t_x = time.perf_counter()
        part = xch.partition_by_range([local[k] for k in keys], process_count(), asc)
        recv = xch.exchange_rows(local, part)
        profiling.record("sort_values.exchange", time.perf_counter() - t_x,
                         _block_num_rows(recv))
        return recv
    cols = _object_arrays(local)
    union, _ = _allgather_dicts([cols[n] for n in names])
    return {n: (list(v) if v.dtype == object else v) for n, v in zip(names, union)}


def _device_key_ok(v) -> bool:
    """A device sort key: a 1-D bool, integer (not uint64) or float tensor."""
    return (torch.is_tensor(v) and v.ndim == 1 and v.dtype not in (
        torch.uint64, torch.complex64, torch.complex128))


def _device_sort_codes(a: "torch.Tensor", ascending: bool) -> "torch.Tensor":
    """One device key column as a monotone int64 code column (the
    reference's ``_device_sort_codes``): integers and bools pass through
    widened; floats by the IEEE-754 radix trick in its signed form
    (negative patterns reflect about INT_MIN, every NaN canonical and last,
    -0.0 equal to 0.0); descending by bitwise NOT, which keeps ties
    stable and cannot overflow."""
    if a.is_floating_point():
        if a.dtype in (torch.float16, torch.bfloat16):
            a = a.float()
        int_dt = torch.int64 if a.dtype == torch.float64 else torch.int32
        a = torch.where(torch.isnan(a), torch.full_like(a, float("nan")), a)
        bits = a.view(int_dt)
        int_min = torch.iinfo(int_dt).min
        k = torch.where(bits >= 0, bits, int_min - bits).to(torch.int64)
    else:
        k = a.to(torch.int64)
    return k if ascending else ~k


def _device_sorted(block: Block, names, keys, asc) -> Block:
    """Sort one all-device block on its device: stable argsorts of the key
    codes, the last key first (a lexsort), then one gather per column."""
    order = None
    for k, k_asc in zip(reversed(keys), reversed(asc)):
        codes = _device_sort_codes(block[k], k_asc)
        if order is None:
            order = torch.argsort(codes, stable=True)
        else:
            order = order[torch.argsort(codes[order], stable=True)]
    return {n: block[n][order] for n in names}


def _join_across_ranks(left, right, keys, how, spec) -> Block:
    """A join with a sharded side across ranks. Under
    ``config.relational_broadcast_bytes`` a BROADCAST hash join: every rank
    allgathers the whole right side (the build side: put the smaller frame
    on the right) and joins its own left rows against it. Over it, and for
    every outer join (a broadcast would re-emit unmatched right rows on
    every rank), the SHUFFLE join: both sides hash-partition on the keys
    and each rank joins one partition. The result is this rank's share, a
    process-local host block."""
    from .config import get_config
    from .ops import exchange as xch
    from .ops.device_agg import _allgather_dicts, gather_local_columns, uniform_ok
    from .parallel.distributed import process_count

    lcols = gather_local_columns(left, left.schema.names)
    r_names = list(right.schema.names)
    r_local = gather_local_columns(right, r_names)
    if not uniform_ok(lcols is not None and r_local is not None):
        raise RuntimeError(
            "join: some process holds no addressable shard "
            "of a column — re-shard so every process holds "
            "rows of both sides (frame_from_process_local)"
        )
    cfg = get_config()
    # an allgathered estimate: the same on every rank, so the branch is
    r_bytes = xch.global_frame_bytes(r_local)
    if r_bytes > cfg.relational_broadcast_bytes or how == "outer":
        if not cfg.relational_exchange:
            raise RuntimeError(
                f"join: broadcasting the {r_bytes:,}-byte "
                "right side to every process "
                + (
                    "cannot implement an outer join "
                    "(unmatched right rows would duplicate "
                    "per process)"
                    if how == "outer"
                    else "exceeds config."
                    "relational_broadcast_bytes "
                    f"({cfg.relational_broadcast_bytes:,})"
                )
                + " and the exchange path is disabled "
                "(config.relational_exchange=False / "
                "TFTPU_RELATIONAL_EXCHANGE=0) — raise the "
                "budget, re-enable the exchange, or put "
                "the smaller frame on the right"
            )
        procs = process_count()
        t_x = time.perf_counter()
        lpart = xch.partition_by_hash([lcols[k] for k in keys], procs)
        rpart = xch.partition_by_hash([r_local[k] for k in keys], procs)
        lrecv = xch.exchange_rows(lcols, lpart)
        rrecv = xch.exchange_rows(r_local, rpart)
        profiling.record("join.exchange", time.perf_counter() - t_x,
                         _block_num_rows(lrecv) + _block_num_rows(rrecv))
        out = _hash_join_cols(_object_arrays(lrecv), _object_arrays(rrecv), spec)
    else:
        union, _ = _allgather_dicts([r_local[n] for n in r_names])
        out = _hash_join_cols(lcols, dict(zip(r_names, union)), spec)
    for name in list(out):
        v = out[name]
        if isinstance(v, np.ndarray) and v.dtype == object:
            out[name] = list(v)  # host columns store as lists
    return out


def _partition_bounds(total: int, num_blocks: int) -> List[tuple]:
    num_blocks = max(1, num_blocks)
    base = total // num_blocks
    rem = total % num_blocks
    bounds = []
    lo = 0
    for i in range(num_blocks):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def _infer_column_info(name: str, cells: Sequence) -> ColumnInfo:
    """Schema inference from the first cell, mirroring the reference's
    read-or-infer path (ColumnInformation.scala:46-58, :124-138): scalars
    get exact metadata; nested lists get Unknown dims per nesting level
    (the ArrayType recursion prepends Unknown)."""
    if len(cells) == 0:
        raise ValueError(f"Column {name!r} is empty; cannot infer schema")
    first = cells[0]
    depth = _nested_depth(first)
    leaf = _leaf_value(first)
    dtype = dt.from_python_value(leaf)
    if not dtype.device and depth > 0:
        raise dt.UnsupportedTypeError(
            f"Column {name!r}: {dtype.name} columns support scalar cells only"
        )
    cell_shape = Shape.unknown(depth)
    return ColumnInfo(name, dtype, cell_shape.prepend(Unknown))


def _cells_to_storage(cells: Sequence, info: ColumnInfo):
    """Pack cells into dense ndarray storage when possible, else keep a list."""
    if not info.is_device:
        return list(cells)
    if isinstance(cells, np.ndarray):
        return np.ascontiguousarray(cells.astype(info.dtype.np_dtype, copy=False))
    try:
        arr = np.asarray(list(cells))
        if arr.dtype == object:
            return list(cells)
        return np.ascontiguousarray(arr.astype(info.dtype.np_dtype, copy=False))
    except ValueError:
        # ragged — keep as list of cells
        return [np.asarray(c, dtype=info.dtype.np_dtype) if not np.isscalar(c) else c for c in cells]


def frame_from_rows(
    rows: Sequence[Dict[str, object]], num_blocks: Optional[int] = None
) -> TensorFrame:
    """Build a frame from row dicts (≙ ``sqlContext.createDataFrame(data)``
    with ``Row`` objects, README.md:67-68)."""
    if not rows:
        raise ValueError("Cannot build a frame from zero rows without a schema")
    from . import native

    names = list(rows[0].keys())
    num_blocks = num_blocks or min(get_config().default_num_blocks, len(rows))
    cols: Dict[str, object] = {}
    infos: List[ColumnInfo] = []
    use_native = native.available()
    for n in names:
        arr = None
        if use_native:
            # scalar numeric columns of the native pass's dtypes gather in
            # one C++ pass (≙ convertFast0, DataOps.scala:63-81); a column
            # it does not take — vectors, strings, mixed or missing cells —
            # takes the per-cell path below
            try:
                dtype = dt.from_python_value(rows[0][n])
            except dt.UnsupportedTypeError:
                dtype = None
            if (
                dtype is not None
                and dtype.device
                and dtype.np_dtype is not None
                and native.supported_dtype(dtype.np_dtype)
                and not isinstance(rows[0][n], (list, tuple, np.ndarray))
            ):
                try:
                    arr = native.gather_column(rows, n, dtype.np_dtype)
                except (TypeError, KeyError, OverflowError, ValueError):
                    arr = None
        if arr is not None:
            cols[n] = arr
            infos.append(ColumnInfo(n, dt.from_numpy(arr.dtype), Shape((Unknown,))))
        else:
            cells = [r[n] for r in rows]
            cols[n] = cells
            infos.append(_infer_column_info(n, cells))
    schema = Schema(infos)
    bounds = _partition_bounds(len(rows), num_blocks)
    blocks: List[Block] = []
    for lo, hi in bounds:
        block: Block = {}
        for info in infos:
            c = cols[info.name]
            if isinstance(c, np.ndarray):
                block[info.name] = c[lo:hi]
            else:
                block[info.name] = _cells_to_storage(c[lo:hi], info)
        blocks.append(block)
    return TensorFrame(blocks, schema)


def frame_from_arrays(
    data: Dict[str, Union[np.ndarray, Sequence]],
    num_blocks: Optional[int] = None,
) -> TensorFrame:
    """Build a frame from column name → array (lead dim = rows). Dense
    arrays get exact cell shapes in the schema immediately (no analyze
    needed — the shape is manifest)."""
    names = list(data.keys())
    if not names:
        raise ValueError("No columns")
    arrays: Dict[str, Union[np.ndarray, list]] = {}
    infos: List[ColumnInfo] = []
    n_rows = None
    for name in names:
        v = data[name]
        if isinstance(v, np.ndarray) and v.dtype != object:
            dtype = dt.from_numpy(v.dtype)
            info = ColumnInfo(name, dtype, Shape(v.shape).with_leading_unknown())
            arrays[name] = np.ascontiguousarray(v)
        else:
            cells = list(v)
            info = _infer_column_info(name, cells)
            stored = _cells_to_storage(cells, info)
            if isinstance(stored, np.ndarray):
                info = info.with_block_shape(
                    Shape(stored.shape).with_leading_unknown()
                )
            arrays[name] = stored
        if n_rows is None:
            n_rows = len(arrays[name])
        elif len(arrays[name]) != n_rows:
            raise ValueError(
                f"Column {name!r} has {len(arrays[name])} rows, expected {n_rows}"
            )
        infos.append(info)
    schema = Schema(infos)
    num_blocks = num_blocks or min(get_config().default_num_blocks, max(n_rows, 1))
    bounds = _partition_bounds(n_rows, num_blocks)
    blocks = [{k: v[lo:hi] for k, v in arrays.items()} for lo, hi in bounds]
    return TensorFrame(blocks, schema)


def frame_from_pandas(pdf, num_blocks: Optional[int] = None) -> TensorFrame:
    """Build a frame from a pandas DataFrame (≙ the reference's pandas debug
    path, core.py:171-183 — here a first-class constructor). pandas is
    only needed by the caller: this function imports nothing of it."""
    data = {}
    for name in pdf.columns:
        col = pdf[name]
        if col.dtype == object:
            data[name] = list(col)
        else:
            data[name] = col.to_numpy()
    return frame_from_arrays(data, num_blocks=num_blocks)


# ---------------------------------------------------------------------------
# Shape tooling: analyze / append_shape / print_schema
# ---------------------------------------------------------------------------

def _analyze_block_column(cells, info: ColumnInfo) -> Shape:
    """Merged cell shape over one block's cells
    (≙ per-partition loop in deepAnalyzeDataFrame,
    ExperimentalOperations.scala:96-110)."""
    if isinstance(cells, np.ndarray):
        return Shape(cells.shape[1:])
    merged: Optional[Shape] = None
    for c in cells:
        s = shape_of_nested(c)
        if merged is None:
            merged = s
        else:
            m = merged.merge(s)
            if m is None:
                raise ValueError(
                    f"Column {info.name!r}: cells have incompatible ranks "
                    f"({merged} vs {s})"
                )
            merged = m
    if merged is None:  # empty block: no information
        return info.cell_shape
    return merged


def analyze(frame: TensorFrame) -> TensorFrame:
    """Full-scan shape discovery: returns a new frame whose schema carries
    exact cell shapes wherever the data agrees, Unknown where it doesn't.

    ≙ ``tfs.analyze`` (core.py:366-379) →
    ``ExtraOperations.deepAnalyzeDataFrame``
    (ExperimentalOperations.scala:89-132). As in the reference this is a
    full pass over the data; unlike the reference it also *densifies*
    ragged-stored columns that turn out to be uniform, so later verbs take
    the fast dense path.
    """
    blocks = frame.blocks()
    new_infos: List[ColumnInfo] = []
    for info in frame.schema:
        cell_shape: Optional[Shape] = None
        for b in blocks:
            if _block_num_rows(b) == 0:
                continue
            s = _analyze_block_column(b[info.name], info)
            if cell_shape is None:
                cell_shape = s
            else:
                m = cell_shape.merge(s)
                if m is None:
                    raise ValueError(
                        f"Column {info.name!r}: blocks disagree on rank "
                        f"({cell_shape} vs {s})"
                    )
                cell_shape = m
        if cell_shape is None:
            cell_shape = info.cell_shape
        new_infos.append(
            ColumnInfo(info.name, info.dtype, cell_shape.prepend(Unknown))
        )
    new_schema = Schema(new_infos)
    # densify uniform ragged columns
    new_blocks: List[Block] = []
    for b in blocks:
        nb: Block = {}
        for info in new_infos:
            v = b[info.name]
            if (
                isinstance(v, list)
                and info.is_device
                and not info.cell_shape.has_unknown
            ):
                nb[info.name] = np.asarray(v, dtype=info.dtype.np_dtype).reshape(
                    (len(v),) + tuple(info.cell_shape.dims)
                )
            else:
                nb[info.name] = v
        new_blocks.append(nb)
    out = TensorFrame(new_blocks, new_schema)
    carry_layout(frame, out, rows_changed=False)
    return out


def append_shape(frame: TensorFrame, col: str, shape) -> TensorFrame:
    """Manually declare the cell shape of a column, skipping the analyze
    scan (≙ ``tfs.append_shape``, core.py:381-399;
    ExperimentalOperations.scala:53-68). ``None`` entries mean Unknown.
    The user is responsible for correctness; mismatches surface at
    execution, as in the reference."""
    cell = Shape.from_any(shape)
    info = frame.schema[col]
    new_info = info.with_block_shape(cell.prepend(Unknown))
    parent = frame

    def compute():
        out = []
        for b in parent.blocks():
            v = b[col]
            if isinstance(v, list) and new_info.is_device and not cell.has_unknown:
                v = np.asarray(v, dtype=new_info.dtype.np_dtype).reshape(
                    (len(v),) + tuple(cell.dims)
                )
            out.append(dict(b, **{col: v}))
        return out

    out = TensorFrame(None, frame.schema.replace(new_info), pending=compute)
    carry_layout(frame, out, rows_changed=False)
    return out


def explain(frame: TensorFrame, detailed: bool = False,
            analyze: bool = False) -> str:
    """Schema rendering with tensor metadata (≙ ``OperationsInterface.explain``,
    DebugRowOps.scala:535-552). With ``detailed=True`` adds the physical
    layout — block row counts and storage kinds (≙ ``explainDetailed``,
    ExperimentalOperations.scala:26-37) — materializing the frame if
    needed. With ``analyze=True`` appends the EXPLAIN ANALYZE view: the
    plan tree annotated with the per-stage profile, decisions and
    barrier evidence recorded by the frame's last adaptive execution."""
    base = frame.schema.explain()
    if analyze:
        from .plan import explain_plan as _explain_plan

        base = base + "\n\n" + _explain_plan(frame, analyze=True)
    if not detailed:
        return base
    lines = [base, ""]
    state = "materialized" if frame.is_materialized else "lazy (forcing)"
    blocks = frame.blocks()
    where = (f"sharded over {dict(frame.mesh.shape)}" if frame.is_sharded
             else "host-resident")
    lines.append(
        f"layout: {len(blocks)} block(s), {frame.num_rows} row(s), "
        f"{where} [{state}]"
    )
    for i, b in enumerate(blocks):
        kinds = []
        for name in frame.schema.names:
            v = b[name]
            if isinstance(v, list):
                kinds.append(f"{name}: list")
            elif torch.is_tensor(v):
                kinds.append(f"{name}: {v.device.type}{list(v.shape)}")
            else:
                kinds.append(f"{name}: np{list(v.shape)}")
        lines.append(f"  block {i}: {_block_num_rows(b)} rows  ({', '.join(kinds)})")
    return "\n".join(lines)


def print_schema(frame: TensorFrame) -> None:
    """≙ ``tfs.print_schema`` (core.py:355-364)."""
    print(explain(frame))


def describe(frame: TensorFrame, columns: Optional[Sequence[str]] = None, device=None):
    """Summary statistics per scalar numeric column — count, mean, std,
    min, max. Each block's (mean, M2, min, max) is computed on the device
    in float64 (the two-pass mean/M2 form, free of cancellation), and the
    block partials merge on the host by the parallel-variance recurrence.

    Returns {column: {"count", "mean", "std", "min", "max"}}; empty frames
    report count 0 and NaN moments."""
    import torch

    from .config import resolve_device

    if frame.is_sharded and _is_multirank():
        raise _spans_error("describe")
    dev = resolve_device(device)
    if columns is None:
        columns = [c.name for c in frame.schema.device_columns if c.cell_shape.rank == 0]
    else:
        for c in columns:
            info = frame.schema[c]
            if not info.is_device or info.cell_shape.rank != 0:
                raise ValueError(
                    f"describe: column {c!r} is not a scalar numeric column"
                )
    if not columns:
        return {}

    def stats(v):
        v = (v.to(dev) if torch.is_tensor(v) else dt.to_torch(v, dev)).double()
        m = v.mean()
        return torch.stack([m, ((v - m) ** 2).sum(), v.min(), v.max()])

    partials: Dict[str, list] = {c: [] for c in columns}
    ns: List[int] = []
    with torch.inference_mode():
        for b in frame.blocks():
            n = _block_num_rows(b)
            if n == 0:
                continue
            ns.append(n)
            for c in columns:
                partials[c].append(stats(b[c]))
        partials = {c: torch.stack(p).cpu().numpy() if p else p
                    for c, p in partials.items()}
    out = {}
    nan = float("nan")
    for c in columns:
        if not ns:
            out[c] = {"count": 0, "mean": nan, "std": nan, "min": nan, "max": nan}
            continue
        # Chan et al. pairwise merge of (n, mean, M2)
        n_t, mean_t, m2_t = 0, 0.0, 0.0
        lo, hi = float("inf"), float("-inf")
        for n_b, p in zip(ns, partials[c]):
            mean_b, m2_b = float(p[0]), float(p[1])
            delta = mean_b - mean_t
            n_new = n_t + n_b
            m2_t = m2_t + m2_b + delta * delta * n_t * n_b / n_new
            mean_t = mean_t + delta * n_b / n_new
            n_t = n_new
            lo, hi = min(lo, float(p[2])), max(hi, float(p[3]))
        out[c] = {
            "count": n_t,
            "mean": mean_t,
            "std": float(np.sqrt(max(m2_t / n_t, 0.0))),
            "min": lo,
            "max": hi,
        }
    return out
