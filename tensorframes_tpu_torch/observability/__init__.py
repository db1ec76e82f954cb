"""Observability: the process-wide metrics registry (counters keep the
reference package's names, so snapshots compare series by series)."""

from .metrics import REGISTRY, counter, histogram  # noqa: F401
