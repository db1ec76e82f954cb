"""Pre-flight validation: program ⇄ frame schema matching.

This reproduces the reference's ``SchemaTransforms`` error contract
(impl/DebugRowOps.scala:53-273) — the largest behavioral surface of the
reference (SURVEY.md §7.4). Every check enumerates, in the error message,
both sides of the mismatch (columns available vs program nodes), as the
reference's messages do.

Contracts validated:

* **map verbs** (mapBlocks/mapRows, DebugRowOps.scala:318-363): every
  program input must name a frame column (after ``feed_dict`` renames);
  dtypes must match exactly (no implicit casting, datatypes.scala:155-161);
  the column's (cell/block) shape must be *at least as precise as* the
  placeholder's declared shape; output names must not collide with
  existing columns when appending.
* **reduce_blocks** (reduceBlocksSchema, DebugRowOps.scala:80-170): each
  fetch ``x`` must name an existing column; inputs must be exactly
  ``{x}_input`` for the fetches; ``x_input``'s shape must be one rank
  higher than ``x``'s with a widened (Unknown) lead dim
  (``widenLeadDim``, :265-272); dtypes equal.
* **reduce_rows** (reduceRowsSchema, DebugRowOps.scala:172-262): each
  fetch ``x`` pairs with placeholders ``x_1``/``x_2`` of identical dtype
  and shape (Operations.scala:83-95).
"""

from __future__ import annotations

from typing import Sequence

from .program import Program, TensorSpec
from .schema import ColumnInfo, Schema


class ValidationError(ValueError):
    """A schema/program mismatch detected before execution."""


def _no_collisions(outputs: Sequence[TensorSpec], schema: Schema) -> None:
    cols = set(schema.names)
    clash = [o.name for o in outputs if o.name in cols]
    if clash:
        raise ValidationError(
            f"Output name(s) {clash} already exist as column(s) in the "
            f"frame (columns: {schema.names}). Output names must all differ "
            "from existing columns."
        )


def _check_dtype(col: ColumnInfo, spec: TensorSpec, role: str) -> None:
    if col.dtype is not spec.dtype:
        raise ValidationError(
            f"{role} {spec.name!r} has dtype {spec.dtype.name} but column "
            f"{col.name!r} has dtype {col.dtype.name}. No implicit casting "
            "is performed on inputs."
        )


def validate_map(
    program: Program,
    schema: Schema,
    block: bool,
    trim: bool = False,
) -> None:
    """Validate a map_blocks/map_rows program against a frame schema.

    ``program.inputs`` must already be renamed per feed_dict (so input
    names are column names).
    """
    for spec in program.inputs:
        col = schema.get(spec.name)
        if col is None:
            raise ValidationError(
                f"Program input {spec.name!r} does not match any column. "
                f"Graph inputs: {program.input_names}; frame columns: "
                f"{schema.names}. Use feed_dict to rename placeholders to "
                "columns."
            )
        _check_dtype(col, spec, "Placeholder")
        data_shape = col.block_shape if block else col.cell_shape
        if spec.shape.rank != data_shape.rank:
            kind = "block" if block else "row"
            raise ValidationError(
                f"Placeholder {spec.name!r} has rank {spec.shape.rank} "
                f"(shape {spec.shape}) but the column's {kind} shape is "
                f"{data_shape} (rank {data_shape.rank})."
            )
        if not data_shape.is_compatible_with(spec.shape):
            raise ValidationError(
                f"Placeholder {spec.name!r} declares shape {spec.shape} "
                f"which is incompatible with column shape {data_shape}. "
                "Run analyze() on the frame or append_shape() if the "
                "column's shape metadata is missing."
            )
    if not trim:
        _no_collisions(program.outputs, schema)
    if block and not trim:
        # appending requires outputs to keep the block's row count: lead
        # dim must be batch-covariant (Unknown) or the check happens at
        # runtime per block.
        for o in program.outputs:
            if o.shape.rank == 0:
                raise ValidationError(
                    f"map_blocks output {o.name!r} is a scalar; block "
                    "outputs must have a leading row dimension (use "
                    "map_blocks(trim=True) or reduce_blocks for "
                    "aggregations)."
                )


def validate_reduce_blocks(program: Program, schema: Schema) -> None:
    """≙ reduceBlocksSchema (DebugRowOps.scala:80-170)."""
    out_names = [o.name for o in program.outputs]
    for o in program.outputs:
        col = schema.get(o.name)
        if col is None:
            raise ValidationError(
                f"reduce_blocks output {o.name!r} must correspond to an "
                f"existing column. Outputs: {out_names}; columns: "
                f"{schema.names}."
            )
    expected_inputs = {f"{n}_input" for n in out_names}
    got_inputs = set(program.input_names)
    if got_inputs != expected_inputs:
        raise ValidationError(
            "reduce_blocks requires exactly one placeholder '<x>_input' per "
            f"fetch '<x>'. Expected inputs: {sorted(expected_inputs)}; got: "
            f"{sorted(got_inputs)}."
        )
    for o in program.outputs:
        col = schema[o.name]
        spec = program.input(f"{o.name}_input")
        _check_dtype(col, spec, "Placeholder")
        if o.dtype is not spec.dtype:
            raise ValidationError(
                f"Fetch {o.name!r} has dtype {o.dtype.name} but its input "
                f"{spec.name!r} has dtype {spec.dtype.name}; they must match."
            )
        if spec.shape.rank != o.shape.rank + 1:
            raise ValidationError(
                f"Placeholder {spec.name!r} (shape {spec.shape}) must have "
                f"exactly one more dimension than fetch {o.name!r} (shape "
                f"{o.shape})."
            )
        # the input block shape must be compatible with the column's
        if not col.block_shape.is_compatible_with(spec.shape):
            raise ValidationError(
                f"Placeholder {spec.name!r} declares shape {spec.shape}, "
                f"incompatible with column block shape {col.block_shape}."
            )


def validate_reduce_rows(program: Program, schema: Schema) -> None:
    """≙ reduceRowsSchema (DebugRowOps.scala:172-262)."""
    out_names = [o.name for o in program.outputs]
    for o in program.outputs:
        col = schema.get(o.name)
        if col is None:
            raise ValidationError(
                f"reduce_rows output {o.name!r} must correspond to an "
                f"existing column. Outputs: {out_names}; columns: "
                f"{schema.names}."
            )
    expected = set()
    for n in out_names:
        expected.add(f"{n}_1")
        expected.add(f"{n}_2")
    got = set(program.input_names)
    if got != expected:
        raise ValidationError(
            "reduce_rows requires exactly two placeholders '<x>_1' and "
            f"'<x>_2' per fetch '<x>'. Expected: {sorted(expected)}; got: "
            f"{sorted(got)}."
        )
    for o in program.outputs:
        col = schema[o.name]
        for suffix in ("_1", "_2"):
            spec = program.input(o.name + suffix)
            _check_dtype(col, spec, "Placeholder")
            if spec.shape.rank != o.shape.rank:
                raise ValidationError(
                    f"Placeholder {spec.name!r} (shape {spec.shape}) must "
                    f"have the same shape as fetch {o.name!r} (shape "
                    f"{o.shape})."
                )
            if not col.cell_shape.is_compatible_with(spec.shape):
                raise ValidationError(
                    f"Placeholder {spec.name!r} declares shape {spec.shape}, "
                    f"incompatible with column cell shape {col.cell_shape}."
                )
