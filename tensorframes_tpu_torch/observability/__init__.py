"""Observability: the process-wide metrics registry (counters keep the
reference package's names, so snapshots compare series by series), the
structured event timeline (:mod:`.events`, Chrome trace JSON) and the
plan-profile reader behind EXPLAIN ANALYZE (:mod:`.profile`)."""

from .metrics import REGISTRY, counter, histogram  # noqa: F401
from . import events  # noqa: F401
