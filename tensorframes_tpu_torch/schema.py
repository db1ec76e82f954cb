"""Per-column tensor metadata and frame schemas.

Capability parity with the reference's metadata layer:

* ``ColumnInfo`` ≙ ``SparkTFColInfo`` + ``ColumnInformation``
  (reference: Shape.scala:120-123, ColumnInformation.scala:8-139): each
  column carries a scalar dtype and a *block shape* whose leading dim is the
  row count (usually Unknown) and whose tail is the per-cell shape.
* ``Schema`` ≙ the DataFrame ``StructType`` + ``DataFrameInfo``
  (reference: DataFrameInfo.scala:7-39): ordered named columns with a
  pretty ``explain`` rendering used by ``print_schema``
  (reference: DebugRowOps.scala:535-552, core.py:355-364).

Where the reference smuggles this through Spark ``StructField`` metadata
under keys like ``org.spartf.shape`` (MetadataConstants.scala:19,27), the
TPU-native frame owns its schema outright — there is no foreign engine to
annotate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from . import dtypes as dt
from .shape import Shape


@dataclasses.dataclass(frozen=True)
class ColumnInfo:
    """Metadata for one column: name, scalar dtype, block shape.

    ``block_shape`` includes the leading row-count dim (Unknown unless the
    frame has been analyzed with a pinned count); ``cell_shape`` is its tail.
    Host-only columns (string/binary) always have scalar cells
    (≙ datatypes.scala:577-581).
    """

    name: str
    dtype: dt.ScalarType
    block_shape: Shape

    def __post_init__(self):
        if self.block_shape.rank < 1:
            raise ValueError(
                f"Column {self.name!r}: block shape must have a leading row "
                f"dim, got {self.block_shape}"
            )
        if not self.dtype.device and self.block_shape.rank != 1:
            raise ValueError(
                f"Column {self.name!r}: host-only type {self.dtype.name} "
                f"supports scalar cells only (got cell shape "
                f"{self.block_shape.tail})"
            )

    @property
    def cell_shape(self) -> Shape:
        return self.block_shape.tail

    @property
    def is_device(self) -> bool:
        return self.dtype.device

    def with_block_shape(self, shape: Shape) -> "ColumnInfo":
        return ColumnInfo(self.name, self.dtype, shape)

    def with_name(self, name: str) -> "ColumnInfo":
        return ColumnInfo(name, self.dtype, self.block_shape)

    def merge(self, other: "ColumnInfo") -> "ColumnInfo":
        """Merge metadata from two blocks of the same column (analyze scan);
        disagreeing dims become Unknown (≙ ExperimentalOperations.scala:168-178)."""
        if other.name != self.name:
            raise ValueError(f"Cannot merge columns {self.name!r} and {other.name!r}")
        if other.dtype is not self.dtype:
            raise dt.UnsupportedTypeError(
                f"Column {self.name!r}: conflicting dtypes {self.dtype.name} "
                f"vs {other.dtype.name} (no implicit casting)"
            )
        merged = self.block_shape.merge(other.block_shape)
        if merged is None:
            raise ValueError(
                f"Column {self.name!r}: rank mismatch between blocks: "
                f"{self.block_shape} vs {other.block_shape}"
            )
        return ColumnInfo(self.name, self.dtype, merged)

    def pretty(self) -> str:
        """Render like the reference's explain line: ``name: type[?,2]``
        (cf. README.md:108-109 `` |-- y: array (nullable = false) double[?,2]``)."""
        return f"{self.name}: {self.dtype.name}{self.block_shape}"


class Schema:
    """An ordered collection of ColumnInfo, keyed by name."""

    __slots__ = ("_cols", "_by_name")

    def __init__(self, cols: Iterable[ColumnInfo]):
        cols = list(cols)
        by_name: Dict[str, ColumnInfo] = {}
        for c in cols:
            if c.name in by_name:
                raise ValueError(f"Duplicate column name {c.name!r} in schema")
            by_name[c.name] = c
        self._cols: List[ColumnInfo] = cols
        self._by_name = by_name

    # -- container protocol -------------------------------------------------
    def __iter__(self):
        return iter(self._cols)

    def __len__(self) -> int:
        return len(self._cols)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __getitem__(self, name: str) -> ColumnInfo:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(
                f"Column {name!r} not found. Available columns: {self.names}"
            ) from None

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self._cols == other._cols

    def __repr__(self) -> str:
        return f"Schema({', '.join(c.pretty() for c in self._cols)})"

    # -- accessors ----------------------------------------------------------
    @property
    def names(self) -> List[str]:
        return [c.name for c in self._cols]

    @property
    def columns(self) -> List[ColumnInfo]:
        return list(self._cols)

    @property
    def device_columns(self) -> List[ColumnInfo]:
        return [c for c in self._cols if c.is_device]

    @property
    def host_columns(self) -> List[ColumnInfo]:
        return [c for c in self._cols if not c.is_device]

    def get(self, name: str) -> Optional[ColumnInfo]:
        return self._by_name.get(name)

    # -- transforms ---------------------------------------------------------
    def select(self, names: Iterable[str]) -> "Schema":
        return Schema([self[n] for n in names])

    def replace(self, info: ColumnInfo) -> "Schema":
        return Schema([info if c.name == info.name else c for c in self._cols])

    def append(self, cols: Iterable[ColumnInfo]) -> "Schema":
        return Schema(self._cols + list(cols))

    def merge(self, other: "Schema") -> "Schema":
        """Column-wise metadata merge of two block schemas (same columns)."""
        if self.names != other.names:
            raise ValueError(
                f"Schema mismatch between blocks: {self.names} vs {other.names}"
            )
        return Schema([a.merge(b) for a, b in zip(self._cols, other._cols)])

    # -- rendering ----------------------------------------------------------
    def explain(self) -> str:
        """Tree rendering ≙ the reference's ``explain``/``print_schema``
        output (DebugRowOps.scala:535-552)."""
        lines = ["root"]
        for c in self._cols:
            nullable = "false"
            kind = "array" if c.cell_shape.rank > 0 else c.dtype.name
            lines.append(
                f" |-- {c.name}: {kind} (nullable = {nullable}) "
                f"{c.dtype.name}{c.block_shape}"
            )
        return "\n".join(lines)
