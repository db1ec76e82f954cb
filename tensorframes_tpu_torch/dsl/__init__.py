"""Public DSL surface (≙ dsl/package.scala:17-134 and the Python
``tfs.block``/``tfs.row`` auto-placeholders, core.py:421-474)."""

from __future__ import annotations

from typing import Optional

from ..shape import Unknown
from .node import (  # noqa: F401
    GraphContext,
    Node,
    abs_,
    add,
    apply_fn,
    binary,
    compile_fetches,
    constant,
    current_graph,
    div,
    exp,
    fill,
    identity,
    log,
    matmul,
    mul,
    ones,
    placeholder,
    reduce_max,
    reduce_mean,
    reduce_min,
    reduce_sum,
    relu,
    scope,
    segment_reduce_info,
    sigmoid,
    sqrt,
    square,
    sub,
    tanh,
    unary,
    with_graph,
    zeros,
)


def block(frame, col_name: str, tf_name: Optional[str] = None) -> Node:
    """Auto-placeholder for a column, block-shaped: leading row dim is
    always Unknown (empty/short blocks must not choke — ≙ core.py:470-473),
    tail = the column's cell shape.

    ≙ ``tfs.block`` (core.py:421-434) + ``extractPlaceholder``
    (dsl/DslImpl.scala:90-107).
    """
    info = frame.schema[col_name]
    if not info.is_device:
        raise TypeError(
            f"Column {col_name!r} has host-only type {info.dtype.name}; it "
            "cannot feed a device program (strings/binary ride along as "
            "pass-through columns)"
        )
    shape = info.cell_shape.prepend(Unknown)
    return placeholder(info.dtype, shape, name=tf_name or col_name)


def row(frame, col_name: str, tf_name: Optional[str] = None) -> Node:
    """Auto-placeholder shaped as one row's cell (≙ ``tfs.row``,
    core.py:436-449: the block shape minus the leading dim)."""
    info = frame.schema[col_name]
    if not info.is_device:
        raise TypeError(
            f"Column {col_name!r} has host-only type {info.dtype.name}; it "
            "cannot feed a device program"
        )
    return placeholder(info.dtype, info.cell_shape, name=tf_name or col_name)
