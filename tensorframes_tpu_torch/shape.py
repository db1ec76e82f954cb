"""Tensor shapes with unknown dimensions.

The frame layer tracks a (possibly partial) shape for every column cell and
every block. A dimension may be *unknown* (``Unknown == -1``), which arises
when rows in a column carry ragged vectors, or when the user has not yet run
``analyze`` on the frame.

Capability parity with the reference's ``Shape`` abstraction
(reference: src/main/scala/org/tensorframes/Shape.scala:16-109):

* unknown dims encoded as -1 (Shape.scala:88-89)
* ``prepend`` / ``tail`` / ``drop_inner`` structural ops
* a *precision lattice*: ``is_more_precise_than`` (Shape.scala:54-59)
* ``merge`` to Unknown on disagreement
  (reference: ExperimentalOperations.scala:168-178)
* physical-shape inference from element counts
  (reference: impl/DataOps.scala:103-144)

Unlike the reference this is a pure-Python value type with no protobuf
round-tripping — the tensor-side shape is derived from meta-device tensors
at analysis time instead of ``TensorShapeProto``.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

Unknown: int = -1


class Shape:
    """An immutable N-dimensional shape; dims may be ``Unknown`` (-1).

    ``Shape.empty()`` (rank 0) denotes a scalar.
    """

    __slots__ = ("_dims",)

    def __init__(self, dims: Iterable[int]):
        dims = tuple(int(d) for d in dims)
        for d in dims:
            if d < -1:
                raise ValueError(f"Invalid dimension {d} in shape {dims}")
        object.__setattr__(self, "_dims", dims)

    def __setattr__(self, *a):  # immutability
        raise AttributeError("Shape is immutable")

    # -- constructors -------------------------------------------------------
    @staticmethod
    def empty() -> "Shape":
        return Shape(())

    @staticmethod
    def scalar() -> "Shape":
        return Shape(())

    @staticmethod
    def of(*dims: int) -> "Shape":
        return Shape(dims)

    @staticmethod
    def unknown(rank: int) -> "Shape":
        """A shape of given rank with every dim unknown."""
        return Shape((Unknown,) * rank)

    @staticmethod
    def from_any(x) -> "Shape":
        """Coerce sequences / Shape / None-style dims into a Shape.

        ``None`` entries map to Unknown, mirroring the reference's Python
        client convention (core.py:38-40: ``-1 if x is None else x``).
        """
        if isinstance(x, Shape):
            return x
        return Shape(tuple(Unknown if d is None else int(d) for d in x))

    # -- accessors ----------------------------------------------------------
    @property
    def dims(self) -> Tuple[int, ...]:
        return self._dims

    @property
    def rank(self) -> int:
        return len(self._dims)

    @property
    def is_scalar(self) -> bool:
        return not self._dims

    @property
    def has_unknown(self) -> bool:
        return Unknown in self._dims

    def __len__(self) -> int:
        return len(self._dims)

    def __iter__(self):
        return iter(self._dims)

    def __getitem__(self, i):
        return self._dims[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Shape) and self._dims == other._dims

    def __hash__(self) -> int:
        return hash(("Shape", self._dims))

    def __repr__(self) -> str:
        return f"Shape{list(self._dims)}"

    def __str__(self) -> str:
        return "[" + ",".join("?" if d == Unknown else str(d) for d in self._dims) + "]"

    # -- structural ops (≙ Shape.scala prepend/tail/dropInner) --------------
    def prepend(self, dim: Optional[int]) -> "Shape":
        """Add a leading (block/row-count) dimension; None → Unknown."""
        d = Unknown if dim is None else int(dim)
        return Shape((d,) + self._dims)

    @property
    def tail(self) -> "Shape":
        """Drop the leading dimension (block shape → cell shape)."""
        if not self._dims:
            raise ValueError("Cannot take tail of a scalar shape")
        return Shape(self._dims[1:])

    def drop_inner(self) -> "Shape":
        """Drop the innermost (last) dimension."""
        if not self._dims:
            raise ValueError("Cannot drop inner dim of a scalar shape")
        return Shape(self._dims[:-1])

    def with_leading_unknown(self) -> "Shape":
        """Replace the leading dim by Unknown (block shapes never pin the
        row count — empty partitions would otherwise fail; core.py:470-473)."""
        if not self._dims:
            raise ValueError("Scalar shape has no leading dim")
        return Shape((Unknown,) + self._dims[1:])

    # -- element counting ---------------------------------------------------
    @property
    def num_elements(self) -> Optional[int]:
        """Number of elements, or None if any dim is unknown."""
        if self.has_unknown:
            return None
        return math.prod(self._dims) if self._dims else 1

    # -- the precision lattice ----------------------------------------------
    def is_more_precise_than(self, other: "Shape") -> bool:
        """True iff this shape refines ``other``: same rank and every dim
        either matches or ``other``'s dim is Unknown.

        ≙ ``Shape.checkMorePreciseThan`` (reference: Shape.scala:54-59).
        """
        if self.rank != other.rank:
            return False
        return all(o == Unknown or s == o for s, o in zip(self._dims, other._dims))

    def is_compatible_with(self, other: "Shape") -> bool:
        """Dims compatible pointwise (equal, or either Unknown); same rank."""
        if self.rank != other.rank:
            return False
        return all(
            s == o or s == Unknown or o == Unknown
            for s, o in zip(self._dims, other._dims)
        )

    def merge(self, other: "Shape") -> Optional["Shape"]:
        """Pointwise merge for the analyze scan: dims that disagree become
        Unknown; rank mismatch yields None (incompatible columns).

        ≙ ``ExtraOperations.merge`` (reference: ExperimentalOperations.scala:168-178).
        """
        if self.rank != other.rank:
            return None
        return Shape(
            tuple(s if s == o else Unknown for s, o in zip(self._dims, other._dims))
        )

    def refine(self, hint: "Shape") -> "Shape":
        """Overlay a hint shape: hint dims win wherever they are known.

        This is the *hint-override* rule: user/DSL-provided shape hints take
        precedence over statically derived shapes
        (reference: TensorFlowOps.scala:126-133).
        """
        if hint.rank != self.rank:
            return hint  # a hint of different rank replaces outright
        return Shape(
            tuple(h if h != Unknown else s for s, h in zip(self._dims, hint._dims))
        )


def infer_physical_shape(num_elements: int, shape: Shape) -> Shape:
    """Resolve at most one Unknown dim of ``shape`` from a known element count.

    ≙ ``DataOps.inferPhysicalShape`` (reference: impl/DataOps.scala:103-144):
    given the flat element count of a materialised tensor and a partial
    shape, solve for the single unknown dimension. Errors mirror the
    reference's contract: more than one unknown dim, non-divisible counts,
    and zero-sized known dims with nonzero counts are all rejected.
    """
    dims = shape.dims
    unknown_idx = [i for i, d in enumerate(dims) if d == Unknown]
    if len(unknown_idx) > 1:
        raise ValueError(
            f"Shape {shape} has more than one unknown dimension; cannot infer "
            f"physical shape from {num_elements} elements"
        )
    known = math.prod([d for d in dims if d != Unknown]) if dims else 1
    if not unknown_idx:
        if known != num_elements:
            raise ValueError(
                f"Shape {shape} implies {known} elements but buffer has "
                f"{num_elements}"
            )
        return shape
    if known == 0:
        if num_elements != 0:
            raise ValueError(
                f"Shape {shape} has a zero dim but buffer has {num_elements} elements"
            )
        resolved = 0
    else:
        if num_elements % known != 0:
            raise ValueError(
                f"Buffer of {num_elements} elements does not divide into shape {shape}"
            )
        resolved = num_elements // known
    out = list(dims)
    out[unknown_idx[0]] = resolved
    return Shape(out)


def shape_of_nested(cell) -> Shape:
    """Recursive shape of a (possibly nested) Python list / numpy cell.

    ≙ the analyze pass's per-cell recursion
    (reference: ExperimentalOperations.scala:140-152). Numpy arrays report
    their ndarray shape directly; nested lists recurse on the first element
    (ragged inner lists are detected by the caller via merge()).
    """
    import numpy as np

    if isinstance(cell, np.ndarray):
        return Shape(cell.shape)
    if isinstance(cell, (list, tuple)):
        if len(cell) == 0:
            return Shape((0,))
        inner = shape_of_nested(cell[0])
        return inner.prepend(len(cell))
    return Shape.empty()
