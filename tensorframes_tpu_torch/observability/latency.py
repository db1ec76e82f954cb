"""Dispatch-latency histograms and derived quantiles (p50/p95/p99).

The reference package's ``observability/latency.py``. Two pre-registered
histogram families, under the reference's names:

* ``tftpu_verb_latency_seconds{verb=...}`` — wall-clock of one verb
  invocation (all blocks), observed by ``utils/profiling.record``/``span``
  at the points the five verbs already time.
* ``tftpu_dispatch_latency_seconds{entry=block|vmap}`` — wall-clock of
  one executor dispatch, pre-registered for the reference's series set.

Buckets are latency-flavored (10 µs … 30 s): a warm dispatch is tens of
µs and p50 must resolve there. Quantiles come from bucket counts by
:meth:`~tensorframes_tpu_torch.observability.metrics.Histogram.quantile`
(linear interpolation within the bucket, Prometheus's
``histogram_quantile`` estimate). Serving endpoints and registered
queries use :data:`LATENCY_BUCKETS` for their own histograms.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .metrics import REGISTRY, Histogram, histogram

__all__ = [
    "LATENCY_BUCKETS",
    "VERBS",
    "observe_verb",
    "verb_histogram",
    "dispatch_histogram",
    "series_key",
    "quantile_summary",
    "summary_lines",
]

#: Latency-flavored bucket ladder: 10 µs through 30 s.
LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

#: The span names that count as verb dispatches (profiling hook filter).
VERBS: Tuple[str, ...] = (
    "map_blocks",
    "map_blocks.dispatch",
    "map_rows",
    "reduce_rows",
    "reduce_blocks",
    "aggregate",
)

_VERB_HISTS: Dict[str, Histogram] = {
    v: histogram(
        "tftpu_verb_latency_seconds",
        "Wall-clock of one verb invocation, by verb "
        "(map_blocks.dispatch = sharded async dispatch only)",
        labels={"verb": v},
        buckets=LATENCY_BUCKETS,
    )
    for v in VERBS
}

_DISPATCH_HISTS: Dict[str, Histogram] = {
    entry: histogram(
        "tftpu_dispatch_latency_seconds",
        "Wall-clock of one executor dispatch (one block through one "
        "executable), by entry kind",
        labels={"entry": entry},
        buckets=LATENCY_BUCKETS,
    )
    for entry in ("block", "vmap")
}


def observe_verb(name: str, seconds: float) -> None:
    """Record one verb invocation's wall-clock (called by
    ``utils/profiling`` for every span whose name is a verb; other names
    cost one dict lookup)."""
    h = _VERB_HISTS.get(name)
    if h is not None:
        h.observe(seconds)


def verb_histogram(verb: str) -> Optional[Histogram]:
    return _VERB_HISTS.get(verb)


def dispatch_histogram(entry: str) -> Histogram:
    return _DISPATCH_HISTS[entry]


def series_key(labels: Dict[str, str]) -> str:
    """Canonical ``family:label`` key of one latency series, e.g.
    ``verb:map_blocks`` or ``dispatch:block``."""
    fam = "verb" if "verb" in labels else "dispatch"
    label = "/".join(v for _, v in sorted(labels.items())) or "-"
    return f"{fam}:{label}"


def quantile_summary(
    registry=None, quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99)
) -> List[dict]:
    """Per-series quantiles of every ``*_latency_seconds`` histogram with
    observations: ``[{"name", "labels", "count", "mean", "p50", ...}]``."""
    reg = registry if registry is not None else REGISTRY
    out = []
    for m in reg.collect():
        if not isinstance(m, Histogram):
            continue
        if not m.name.endswith("_latency_seconds"):
            continue
        if m.count == 0:
            continue
        row = {
            "name": m.name,
            "labels": dict(m.labels),
            "count": m.count,
            "mean": m.sum / m.count,
        }
        for q in quantiles:
            row[f"p{int(q * 100)}"] = m.quantile(q)
        out.append(row)
    return sorted(
        out, key=lambda r: (r["name"], sorted(r["labels"].items()))
    )


def summary_lines(registry=None) -> List[str]:
    """Compact per-series quantile lines (``verb:map_blocks count=...
    p50=...``)."""
    lines = []
    for row in quantile_summary(registry):
        lines.append(
            f"{series_key(row['labels'])} count={row['count']} "
            f"p50={row['p50']:.6f}s p95={row['p95']:.6f}s "
            f"p99={row['p99']:.6f}s mean={row['mean']:.6f}s"
        )
    return lines
