"""Cross-process trace aggregation: per-process shards → one timeline.

A multi-process run (a serving fleet's replicas and its router, a
multi-process job) produces one trace shard per process
(``events.save_shard``), each on its own monotonic clock and
each claiming ``pid = os.getpid()``. This module merges them into one
valid Chrome/Perfetto trace with **per-process tracks**:

* every shard's events are re-stamped with ``pid = process_index`` (the
  stable rank from the shard's ``otherData``), so Perfetto renders one
  process group per rank regardless of what OS pids the fleet drew;
* each shard's timestamps are shifted by the difference of its
  wall-clock epoch anchor (``trace_epoch_unix_us``) against the
  earliest shard's, so "process 3 stalled while process 0 compiled"
  reads off one shared real-time axis (wall clocks are NTP-grade
  aligned on one host or a cluster — microsecond-perfect alignment is
  not claimed, and sub-ms skew is irrelevant at dispatch timescales);
* ``process_name`` / ``process_sort_index`` metadata events label and
  order the tracks;
* shards from *different* runs refuse to merge (mismatched ``run_id``)
  unless forced — silently interleaving two runs' timelines is how
  postmortems go wrong.

``observability merge`` (cli.py) is the command-line face of
:func:`merge_traces`.
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence

from ..utils import get_logger

logger = get_logger(__name__)

__all__ = ["merge_traces", "load_shard", "find_shards"]


def find_shards(directory: str, run_id: Optional[str] = None) -> List[str]:
    """Shard files under ``directory`` (the ``events.save_shard``
    naming), optionally restricted to one run id, sorted by rank."""
    pat = f"trace_{run_id}_p*.json" if run_id else "trace_*_p*.json"
    paths = _glob.glob(os.path.join(directory, pat))

    def rank(p: str) -> int:
        stem = os.path.basename(p).rsplit(".", 1)[0]
        try:
            return int(stem.rsplit("_p", 1)[1])
        except (IndexError, ValueError):
            return 1 << 30
    return sorted(paths, key=rank)


def load_shard(path: str) -> Dict[str, Any]:
    """Read one shard; raises ValueError on non-trace JSON."""
    with open(path) as f:
        shard = json.load(f)
    if not isinstance(shard, dict) or "traceEvents" not in shard:
        raise ValueError(
            f"{path}: not a Chrome trace (no traceEvents key)"
        )
    return shard


def _shard_meta(shard: Dict[str, Any], path: str, fallback_index: int):
    other = shard.get("otherData") or {}
    idx = other.get("process_index")
    if idx is None:
        # pre-correlation shard (or foreign trace): fall back to file
        # order, loudly — tracks still separate, identity is best-effort
        logger.warning(
            "merge: %s carries no process_index; assigning track %d by "
            "file order", path, fallback_index,
        )
        idx = fallback_index
    if not other.get("trace_epoch_unix_us"):
        logger.warning(
            "merge: %s carries no wall-clock epoch anchor; its events "
            "keep their own timebase (placed at the start of the merged "
            "axis) — cross-process ordering against this shard is not "
            "meaningful", path,
        )
    return {
        "index": int(idx),
        "run_id": other.get("run_id"),
        "pid": other.get("pid"),
        "epoch_us": other.get("trace_epoch_unix_us"),
        "dropped": int(other.get("dropped_events") or 0),
    }


def merge_traces(
    paths: Sequence[str], force: bool = False
) -> Dict[str, Any]:
    """Merge per-process trace shards into one Chrome trace object.

    ``paths`` are shard files (``events.save_shard`` layout or any
    Chrome trace carrying the ``otherData`` context stamp). Returns the
    merged ``{"traceEvents": [...], ...}`` dict; :func:`json.dump` it or
    hand it to Perfetto. ``force=True`` merges across mismatched
    run_ids (tracks are still separated; the metadata records every id).
    """
    if not paths:
        raise ValueError("merge_traces: no shard paths given")
    shards = []
    for i, p in enumerate(paths):
        shard = load_shard(p)
        shards.append((p, shard, _shard_meta(shard, p, i)))

    run_ids = sorted({m["run_id"] for _, _, m in shards if m["run_id"]})
    if len(run_ids) > 1 and not force:
        raise ValueError(
            "merge_traces: shards come from different runs "
            f"{run_ids} — pass force=True to merge anyway"
        )
    seen_ranks: Dict[int, str] = {}
    for p, _, m in shards:
        if m["index"] in seen_ranks and not force:
            raise ValueError(
                f"merge_traces: duplicate process_index {m['index']} "
                f"({seen_ranks[m['index']]} and {p}) — a stale shard "
                "from an earlier run? pass force=True to keep both"
            )
        seen_ranks.setdefault(m["index"], p)

    anchors = [m["epoch_us"] for _, _, m in shards if m["epoch_us"]]
    base_us = min(anchors) if anchors else 0

    merged: List[Dict[str, Any]] = []
    processes = []
    total_dropped = 0
    for _, shard, m in shards:
        idx = m["index"]
        shift = (m["epoch_us"] - base_us) if m["epoch_us"] else 0
        label = f"process {idx}"
        if m["pid"]:
            label += f" (pid {m['pid']})"
        merged.append({
            "ph": "M", "name": "process_name", "pid": idx,
            "args": {"name": label},
        })
        merged.append({
            "ph": "M", "name": "process_sort_index", "pid": idx,
            "args": {"sort_index": idx},
        })
        for ev in shard["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = idx
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift
            merged.append(ev)
        total_dropped += m["dropped"]
        processes.append({
            "process_index": idx,
            "pid": m["pid"],
            "events": len(shard["traceEvents"]),
            "epoch_unix_us": m["epoch_us"],
        })

    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "tensorframes_tpu_torch.observability.merge",
            "run_id": run_ids[0] if len(run_ids) == 1 else run_ids,
            "num_shards": len(shards),
            "processes": processes,
            "dropped_events": total_dropped,
        },
    }
