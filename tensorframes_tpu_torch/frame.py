"""The TensorFrame: a block-partitioned columnar container.

The replacement for the reference's Spark ``DataFrame`` (+ the tensor
metadata it smuggles into ``StructField``\\ s). A frame is a list of
*blocks* (≙ Spark partitions); each block maps column name →

* a dense ``numpy.ndarray`` with leading row dim (device columns), or
* a Python list of per-row cells (ragged columns awaiting ``analyze`` /
  per-row execution, and host-only string/binary columns,
  ≙ datatypes.scala:571-622).

Frames are host-resident: blocks move to the device when a verb dispatches
them, and results come back to the host. Verbs are **lazy**, like the
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


def _merged_global_columns(frame, names) -> Dict[str, object]:
    """Concatenate every block of ``names`` into single host columns (a
    list where any block stores the column as cells)."""
    out: Dict[str, object] = {}
    blocks = frame.blocks()
    for name in names:
        vals = [b[name] for b in blocks]
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
    m = np.asarray(block[mask_name])
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
        return sum(_block_num_rows(b) for b in self.blocks())

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
        parts = []
        for b in self.blocks():
            v = b[name]
            if isinstance(v, list):
                v = np.asarray(v, dtype=object) if not info.is_device else np.asarray(v)
            parts.append(v)
        if not parts:
            return np.empty((0,), dtype=info.dtype.np_dtype)
        return np.concatenate(parts, axis=0)

    def collect(self) -> List[Dict[str, object]]:
        """Materialize as a list of row dicts (≙ ``DataFrame.collect``).

        Vector cells come back as numpy arrays; scalars as Python scalars.
        """
        from . import native

        rows: List[Dict[str, object]] = []
        for b in self.blocks():
            n = _block_num_rows(b)
            cols = {name: b[name] for name in self.schema.names}
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
                [{k: v[:take_here] for k, v in b.items()}], self.schema
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
                    cell = b[name][0]
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
            vals = []
            for b in self.blocks():
                vals.extend(list(b[name]))
            data[name] = vals
        return pd.DataFrame(data)

    # -- relational transforms (host frames, one process) -----------------
    def select(self, names: Sequence[str]) -> "TensorFrame":
        schema = self.schema.select(names)
        if self.is_materialized:
            return TensorFrame([{n: b[n] for n in names} for b in self._blocks], schema)
        from .plan import ir as _plan_ir

        if _plan_ir.fusion_enabled():
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
        return TensorFrame(
            None, schema, pending=lambda: [{n: b[n] for n in names} for b in parent.blocks()]
        )

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

        return TensorFrame(
            None, self.schema,
            pending=_spanned("filter", compute, lambda: parent.num_rows),
        )

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

            merged = _merged_global_columns(parent, names)
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

        return TensorFrame(
            None, self.schema,
            pending=_spanned("sort_values", compute, lambda: parent.num_rows),
        )

    def limit(self, n: int) -> "TensorFrame":
        """The first ``n`` rows, as a frame (``take`` returns rows). Lazy."""
        if n < 0:
            raise ValueError(f"limit must be >= 0, got {n}")
        names = list(self.schema.names)
        parent = self

        def compute() -> List[Block]:
            remaining = n
            out_blocks: List[Block] = []
            for b in parent.blocks():
                if remaining <= 0:
                    break
                take_n = min(_block_num_rows(b), remaining)
                out_blocks.append({name: b[name][:take_n] for name in names})
                remaining -= take_n
            if not out_blocks:
                out_blocks = [{name: b[name][:0] for name in names}
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

        if _plan_ir.fusion_enabled():
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
            return [_hash_join_cols(
                _merged_global_columns(left, left.schema.names),
                _merged_global_columns(right, right.schema.names), spec)]

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

            cols = _merged_global_columns(parent, names)
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

    def with_column_renamed(self, old: str, new: str) -> "TensorFrame":
        schema = Schema([c.with_name(new) if c.name == old else c for c in self.schema])
        parent = self
        return TensorFrame(
            None, schema,
            pending=lambda: [{(new if k == old else k): v for k, v in b.items()}
                             for b in parent.blocks()],
        )

    def alias_column(self, name: str, alias: str) -> "TensorFrame":
        """Duplicate a column under a new name (≙ ``df.select(y,
        y.alias("z"))`` in the README reduce example, README.md:114)."""
        schema = self.schema.append([self.schema[name].with_name(alias)])
        parent = self
        return TensorFrame(
            None, schema,
            pending=lambda: [dict(b, **{alias: b[name]}) for b in parent.blocks()],
        )

    def repartition(self, num_blocks: int) -> "TensorFrame":
        """Re-chunk rows into ``num_blocks`` roughly equal blocks."""
        merged = _merged_global_columns(self, self.schema.names)
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

        refs = []
        for b in self.blocks():
            refs.append(store.put({
                name: v if isinstance(v, list) else np.asarray(v)
                for name, v in b.items()
            }))
        return SpilledFrame(store, refs, self.schema)

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

        ones = TensorFrame(
            [dict(b, count_tmp=np.ones(_block_num_rows(b), np.int64))
             for b in self.frame.blocks()],
            self.frame.schema.append(
                [ColumnInfo("count_tmp", dt.int64, Shape((Unknown,)))]
            ),
        )
        with dsl.with_graph():
            cnt_in = dsl.block(ones, "count_tmp", tf_name="count_tmp_input")
            cnt = dsl.reduce_sum(cnt_in, axis=0, name="count_tmp")
        out = aggregate(cnt, GroupedData(ones, self.keys), device=device)
        return out.with_column_renamed("count_tmp", "count")

    def __repr__(self):
        return f"GroupedData(keys={self.keys}, {self.frame!r})"


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
    return TensorFrame(new_blocks, new_schema)


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

    return TensorFrame(None, frame.schema.replace(new_info), pending=compute)


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
    lines.append(
        f"layout: {len(blocks)} block(s), {frame.num_rows} row(s), "
        f"host-resident [{state}]"
    )
    for i, b in enumerate(blocks):
        kinds = []
        for name in frame.schema.names:
            v = b[name]
            if isinstance(v, list):
                kinds.append(f"{name}: list")
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
        v = dt.to_torch(v, dev).double()
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
