"""Execution layer: the five verbs, the block executor, key encoding and
the single-op segment reductions. Re-exports the verbs, as the reference
package's ``ops`` does."""
from .verbs import (
    aggregate,
    compile_program,
    map_blocks,
    map_rows,
    reduce_blocks,
    reduce_rows,
)

__all__ = [
    "aggregate",
    "compile_program",
    "map_blocks",
    "map_rows",
    "reduce_blocks",
    "reduce_rows",
]
