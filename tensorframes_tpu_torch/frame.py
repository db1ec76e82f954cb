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
it once and caches.

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

import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from . import dtypes as dt
from .config import get_config
from .schema import ColumnInfo, Schema
from .shape import Shape, Unknown, shape_of_nested

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
        rows: List[Dict[str, object]] = []
        for b in self.blocks():
            n = _block_num_rows(b)
            cols = {name: b[name] for name in self.schema.names}
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

    # -- verb methods (≙ Implicits.RichDataFrame, dsl/Implicits.scala:25-100)
    def map_blocks(self, fetches, feed_dict=None, trim: bool = False,
                   device=None):
        from .ops.verbs import map_blocks

        return map_blocks(fetches, self, feed_dict=feed_dict, trim=trim,
                          device=device)

    def map_rows(self, fetches, feed_dict=None, device=None):
        from .ops.verbs import map_rows

        return map_rows(fetches, self, feed_dict=feed_dict, device=device)

    def reduce_rows(self, fetches, device=None):
        from .ops.verbs import reduce_rows

        return reduce_rows(fetches, self, device=device)

    def reduce_blocks(self, fetches, device=None):
        from .ops.verbs import reduce_blocks

        return reduce_blocks(fetches, self, device=device)

    def analyze(self) -> "TensorFrame":
        """≙ ``RichDataFrame.analyze`` (dsl/Implicits.scala:69-71)."""
        return analyze(self)

    def explain_tensors(self) -> str:
        """≙ ``explainTensors`` (dsl/Implicits.scala:77-79)."""
        return explain(self)

    def explain(self, detailed: bool = False) -> str:
        """Schema + tensor metadata rendering; ``detailed=True`` adds
        the physical layout."""
        return explain(self, detailed=detailed)

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

    def aggregate(self, fetches, device=None) -> "TensorFrame":
        """≙ ``RichRelationalGroupedDataset.aggregate``
        (dsl/Implicits.scala:107-116)."""
        from .ops.verbs import aggregate

        return aggregate(fetches, self, device=device)

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
    names = list(rows[0].keys())
    num_blocks = num_blocks or min(get_config().default_num_blocks, len(rows))
    cols: Dict[str, list] = {}
    infos: List[ColumnInfo] = []
    for n in names:
        cells = [r[n] for r in rows]
        cols[n] = cells
        infos.append(_infer_column_info(n, cells))
    schema = Schema(infos)
    bounds = _partition_bounds(len(rows), num_blocks)
    blocks: List[Block] = []
    for lo, hi in bounds:
        blocks.append({
            info.name: _cells_to_storage(cols[info.name][lo:hi], info)
            for info in infos
        })
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


def explain(frame: TensorFrame, detailed: bool = False) -> str:
    """Schema rendering with tensor metadata (≙ ``OperationsInterface.explain``,
    DebugRowOps.scala:535-552). With ``detailed=True`` adds the physical
    layout — block row counts and storage kinds (≙ ``explainDetailed``,
    ExperimentalOperations.scala:26-37) — materializing the frame if
    needed."""
    base = frame.schema.explain()
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
