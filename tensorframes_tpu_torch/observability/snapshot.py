"""Bench snapshots and the perf-regression diff.

A benchmark round is kept as a JSON wrapper around one run whose
``tail`` holds the ``# name=value`` metric lines and whose ``parsed``
field holds the final headline JSON (the repo's ``BENCH_r*.json``). This
module makes such rounds diffable, in the reference package's formats:

* :func:`build_snapshot` / :func:`write_snapshot` — the structured
  snapshot: schema tag, run context, the full metrics dict, and the
  latency quantiles.
* :func:`load_metrics` — one loader for every artifact shape in the
  repo: a native snapshot, a committed ``BENCH_r*.json`` round (metrics
  recovered from its ``tail``), raw bench stdout, or a metrics-registry
  JSONL export.
* :func:`diff_metrics` — per-metric comparison with direction inference
  (rows/sec up is good; wall-seconds up is bad) and per-metric
  thresholds. ``observability diff`` exits nonzero on regression — the
  CI gate (warn-only on CPU runners, where scheduler noise is real).
"""

from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Mapping, Optional, Tuple

__all__ = [
    "SCHEMA",
    "build_snapshot",
    "write_snapshot",
    "load_metrics",
    "parse_bench_text",
    "diff_metrics",
    "DEFAULT_THRESHOLD",
]

SCHEMA = "tftpu-bench-snapshot/1"

#: Default relative-change threshold: bench noise on shared machines
#: runs tens of percent, so only a >=50% move counts as a regression by
#: default; a genuine 2x latency regression is 100% and always trips.
DEFAULT_THRESHOLD = 0.5

_METRIC_LINE = re.compile(
    r"^#\s*([A-Za-z0-9_.]+)=(-?[0-9][0-9_.eE+-]*)\s*$"
)
_LATENCY_LINE = re.compile(r"^#\s*latency\s*\|\s*(\S+)\s+(.*)$")
_KV = re.compile(r"([A-Za-z0-9_]+)=([-0-9.eE+]+)s?")

_HIGHER_BETTER = ("_per_sec", "per_sec_", "_per_chip", "_speedup")
_LOWER_BETTER_SUFFIX = ("_s", "_seconds", "_ms", "_us")
_LOWER_BETTER_SUBSTR = ("wall_s", "_p50", "_p95", "_p99",
                        ".p50", ".p95", ".p99", ".mean", "compile_s")


def direction(name: str) -> int:
    """+1 = higher is better, -1 = lower is better, 0 = unknown (the
    diff reports unknown-direction metrics but never gates on them)."""
    if name.endswith((".count", "_count", "_total")):
        # counts are run-length-shaped, not quality-shaped: a longer
        # run dispatches more, and that is not a regression
        return 0
    if any(h in name for h in _HIGHER_BETTER):
        return 1
    if any(s in name for s in _LOWER_BETTER_SUBSTR):
        return -1
    if name.endswith(_LOWER_BETTER_SUFFIX):
        return -1
    return 0


# ---------------------------------------------------------------------------
# building (the bench's side)
# ---------------------------------------------------------------------------

def build_snapshot(
    metrics: Mapping[str, float], meta: Optional[Mapping] = None
) -> Dict:
    """Assemble the structured bench snapshot: metrics + the latency
    quantile summary + run context."""
    from . import context as _context
    from .latency import quantile_summary, series_key

    latency = {}
    for row in quantile_summary():
        latency[series_key(row["labels"])] = {
            k: row[k] for k in ("count", "mean", "p50", "p95", "p99")
        }
    snap = {
        "schema": SCHEMA,
        "ts": round(time.time(), 3),
        **_context.snapshot(),
        "metrics": {
            k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float))
        },
        "latency": latency,
    }
    if meta:
        snap["meta"] = dict(meta)
    return snap


def write_snapshot(
    path: str, metrics: Mapping[str, float], meta: Optional[Mapping] = None
) -> str:
    with open(path, "w") as f:
        json.dump(build_snapshot(metrics, meta), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# loading (any artifact shape in the repo)
# ---------------------------------------------------------------------------

def parse_bench_text(text: str) -> Dict[str, float]:
    """Metrics from bench stdout (or a BENCH round's ``tail``):
    ``# name=value`` comment rows, ``# latency |`` quantile rows
    (flattened to ``latency.<series>.<q>``), and the final headline
    JSON line's ``value``."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        m = _METRIC_LINE.match(line)
        if m:
            try:
                out[m.group(1)] = float(m.group(2))
            except ValueError:
                continue
            continue
        m = _LATENCY_LINE.match(line)
        if m:
            series = m.group(1)
            for k, v in _KV.findall(m.group(2)):
                try:
                    out[f"latency.{series}.{k}"] = float(v)
                except ValueError:
                    continue
            continue
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and isinstance(
                obj.get("value"), (int, float)
            ):
                out["headline.value"] = float(obj["value"])
    return out


def _flatten_snapshot(snap: Dict) -> Dict[str, float]:
    out = dict(snap.get("metrics") or {})
    for series, qs in (snap.get("latency") or {}).items():
        for k, v in qs.items():
            if isinstance(v, (int, float)):
                out[f"latency.{series}.{k}"] = float(v)
    return out


def load_metrics(path: str) -> Tuple[Dict[str, float], Dict]:
    """Load ``{metric: value}`` plus a small meta dict from any of: a
    native snapshot (:data:`SCHEMA`), a committed ``BENCH_r*.json``
    round, raw bench stdout, or a metrics-registry JSONL export."""
    with open(path) as f:
        text = f.read()
    # registry JSONL: one {"name": ..., "kind": ...} object per line
    first = text.lstrip()[:1]
    if first == "{" and "\n" in text.strip():
        lines = text.strip().splitlines()
        try:
            rows = [json.loads(ln) for ln in lines]
            if all(isinstance(r, dict) and "name" in r and "kind" in r
                   for r in rows):
                return _metrics_from_registry_rows(rows), {
                    "source": "metrics-jsonl", "path": path,
                }
        except json.JSONDecodeError:
            pass
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        obj = None
    if isinstance(obj, dict):
        if obj.get("schema") == SCHEMA:
            meta = {
                "source": "snapshot", "path": path,
                "ts": obj.get("ts"), "run_id": obj.get("run_id"),
            }
            return _flatten_snapshot(obj), meta
        if "tail" in obj:  # a committed BENCH_r*.json round
            metrics = parse_bench_text(obj.get("tail") or "")
            parsed = obj.get("parsed")
            if isinstance(parsed, dict) and isinstance(
                parsed.get("value"), (int, float)
            ):
                metrics.setdefault("headline.value", float(parsed["value"]))
            return metrics, {
                "source": "bench-round", "path": path, "n": obj.get("n"),
            }
    # raw bench stdout
    return parse_bench_text(text), {"source": "bench-text", "path": path}


def _metrics_from_registry_rows(rows: List[Dict]) -> Dict[str, float]:
    """Registry-JSONL rows → flat metrics: counters/gauges by value,
    histograms by derived mean and p50/p95/p99 (re-estimated from the
    exported cumulative buckets)."""
    out: Dict[str, float] = {}
    for r in rows:
        labels = r.get("labels") or {}
        suffix = "".join(
            f".{k}.{v}" for k, v in sorted(labels.items())
        )
        base = r["name"] + suffix
        if r["kind"] in ("counter", "gauge"):
            out[base] = float(r.get("value", 0.0))
            continue
        count = int(r.get("count", 0))
        if count <= 0:
            continue
        out[base + ".count"] = float(count)
        out[base + ".mean"] = float(r.get("sum", 0.0)) / count
        from .metrics import quantile_from_cumulative

        cum = []
        for bound, c in (r.get("buckets") or {}).items():
            b = float("inf") if bound in ("+Inf", "inf") else float(bound)
            cum.append((b, int(c)))
        cum.sort(key=lambda t: t[0])
        for q in (0.5, 0.95, 0.99):
            v = quantile_from_cumulative(cum, count, q)
            if v is not None:
                out[f"{base}.p{int(q * 100)}"] = v
    return out


# ---------------------------------------------------------------------------
# diffing
# ---------------------------------------------------------------------------

def diff_metrics(
    old: Mapping[str, float],
    new: Mapping[str, float],
    threshold: float = DEFAULT_THRESHOLD,
    per_metric: Optional[Mapping[str, float]] = None,
) -> Dict:
    """Compare two metric dicts; returns ``{"rows": [...],
    "regressions": [...], "improvements": [...], "only_old": [...],
    "only_new": [...]}``.

    A metric regresses when it moves against its direction by more than
    its threshold: higher-better ``new < old * (1 - t)``, lower-better
    ``new > old * (1 + t)``. Unknown-direction metrics are reported
    (``"?"``) but never gate. ``per_metric`` overrides the global
    threshold by exact metric name."""
    per_metric = dict(per_metric or {})
    rows, regressions, improvements = [], [], []
    common = sorted(set(old) & set(new))
    for name in common:
        a, b = float(old[name]), float(new[name])
        d = direction(name)
        t = per_metric.get(name, threshold)
        ratio = (b / a) if a else None
        status = "ok"
        if d == 0:
            status = "?"
        elif a == 0 and b == 0:
            status = "ok"
        elif a == 0:
            status = "?"  # no base to compare against
        elif d > 0 and b < a * (1.0 - t):
            status = "regression"
        elif d < 0 and b > a * (1.0 + t):
            status = "regression"
        elif d > 0 and b > a * (1.0 + t):
            status = "improvement"
        elif d < 0 and b < a * (1.0 - t):
            status = "improvement"
        row = {
            "metric": name, "old": a, "new": b, "ratio": ratio,
            "direction": {1: "higher", -1: "lower", 0: "?"}[d],
            "threshold": t, "status": status,
        }
        rows.append(row)
        if status == "regression":
            regressions.append(row)
        elif status == "improvement":
            improvements.append(row)
    return {
        "rows": rows,
        "regressions": regressions,
        "improvements": improvements,
        "only_old": sorted(set(old) - set(new)),
        "only_new": sorted(set(new) - set(old)),
    }
