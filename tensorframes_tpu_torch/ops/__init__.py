"""Execution layer: the five verbs, the block executor, key encoding and
the single-op segment reductions."""
