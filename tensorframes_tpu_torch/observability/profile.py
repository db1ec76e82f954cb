"""Plan-profile reading and rendering.

Two consumers share this module:

* **EXPLAIN ANALYZE** — :func:`profile_lines` annotates a frame's plan
  tree with the per-stage profile its last execution recorded into the
  stats sidecar (``plan/stats.py``): wall, rows, bytes, chosen strategy
  and the lowering time, plus the evidence already hanging off the
  frame: fusion barriers (TFG107), unfused epilogues (TFG109) and missed
  pushdowns (TFG110), named by the reference package's diagnostic
  codes. Reached through ``explain_plan(df, analyze=True)`` /
  ``TensorFrame.explain(analyze=True)``.
* **Offline reports** — :func:`render_report` scans a sidecar directory
  (CI artifacts, a laptop) and renders the top-N slowest recorded plan
  stages across every fingerprint plus the current per-strategy
  observed-wall tables feeding the latency-driven ``decide_*`` flips.

Offline readers never quarantine: deleting a corrupt sidecar is the
owning process's job (``plan/stats.py`` does it on load); a report over
someone else's artifact directory must be read-only. Corrupt or alien
files are skipped and counted in the report header instead.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = [
    "load_profiles",
    "load_strategy_walls",
    "top_stages",
    "render_report",
    "profile_lines",
]


def _valid_record(rec: object, fp: str) -> bool:
    # mirrors plan/stats._valid, minus the version pin: a report over
    # an older artifact should still render what it can
    return (
        isinstance(rec, dict)
        and rec.get("fp") == fp
        and isinstance(rec.get("execs"), int)
    )


def load_profiles(sidecar_dir: str) -> Tuple[Dict[str, dict], int]:
    """All readable per-fingerprint records under ``sidecar_dir``
    (``{fp: record}``), plus the count of skipped (corrupt / alien /
    mis-named) files. Never raises, never deletes."""
    records: Dict[str, dict] = {}
    skipped = 0
    try:
        names = sorted(os.listdir(sidecar_dir))
    except OSError:
        return records, 0
    for name in names:
        if not name.endswith(".json") or name == "strategy_walls.json":
            continue
        fp = name[: -len(".json")]
        try:
            with open(os.path.join(sidecar_dir, name), "r") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            skipped += 1
            continue
        if not _valid_record(rec, fp):
            skipped += 1
            continue
        records[fp] = rec
    return records, skipped


def load_strategy_walls(sidecar_dir: str) -> Dict[str, dict]:
    """The per-(decision, strategy) observed-wall tables from
    ``strategy_walls.json`` (``{decision: {"obs", "strategies"}}``), or
    ``{}`` when absent/unreadable. Read-only — see module docstring."""
    path = os.path.join(sidecar_dir, "strategy_walls.json")
    try:
        with open(path, "r") as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return {}
    if not (
        isinstance(rec, dict)
        and rec.get("kind") == "strategy_walls"
        and isinstance(rec.get("tables"), dict)
    ):
        return {}
    return rec["tables"]


def top_stages(records: Dict[str, dict], n: int = 10) -> List[dict]:
    """The ``n`` slowest recorded plan stages across every fingerprint,
    slowest first. Each row is the sidecar profile entry plus its
    ``fp``."""
    rows: List[dict] = []
    for fp, rec in records.items():
        prof = rec.get("profile")
        if not isinstance(prof, list):
            continue
        for entry in prof:
            if isinstance(entry, dict) and "stage" in entry:
                rows.append({"fp": fp, **entry})
    rows.sort(key=lambda r: -float(r.get("wall_s", 0.0) or 0.0))
    return rows[: max(0, int(n))]


def _fmt_stage(entry: dict, *, with_fp: bool = False) -> str:
    parts = [f"{entry.get('stage', '?')}"]
    wall = entry.get("wall_s")
    if wall is not None:
        parts.append(f"wall={float(wall):.6f}s")
    if entry.get("strategy"):
        parts.append(f"strategy={entry['strategy']}")
    if entry.get("rows") is not None:
        parts.append(f"rows={int(entry['rows'])}")
    if entry.get("bytes") is not None:
        parts.append(f"bytes={int(entry['bytes'])}")
    if entry.get("compile_s") is not None:
        parts.append(f"compile={float(entry['compile_s']):.6f}s")
    if with_fp and entry.get("fp"):
        parts.append(f"fp={entry['fp'][:12]}")
    return "  ".join(parts)


def render_report(sidecar_dir: str, top: int = 10) -> str:
    """The ``report --profile`` body: top-N slowest stages + the
    per-strategy wall tables, as one printable string."""
    records, skipped = load_profiles(sidecar_dir)
    lines = [
        f"# plan-profile sidecar: {sidecar_dir} — "
        f"{len(records)} fingerprint(s)"
        + (f", {skipped} unreadable file(s) skipped" if skipped else "")
    ]
    stages = top_stages(records, n=top)
    lines.append(f"\n# top {len(stages)} slowest recorded plan stage(s)")
    if stages:
        for entry in stages:
            lines.append("  " + _fmt_stage(entry, with_fp=True))
    else:
        lines.append("  (no per-stage profiles recorded)")
    walls = load_strategy_walls(sidecar_dir)
    lines.append("\n# observed per-strategy walls (EWMA seconds)")
    if walls:
        for decision in sorted(walls):
            table = walls[decision]
            strategies = table.get("strategies", {})
            lines.append(
                f"  {decision} (obs={int(table.get('obs', 0))}):"
            )
            for strat in sorted(strategies):
                ent = strategies[strat]
                lines.append(
                    f"    {strat:<24} ewma={float(ent.get('ewma_s', 0.0)):.6f}s"
                    f"  n={int(ent.get('n', 0))}"
                )
    else:
        lines.append("  (no strategy walls recorded)")
    return "\n".join(lines)


def profile_lines(frame) -> List[str]:
    """EXPLAIN ANALYZE annotation lines for one frame: the recorded
    per-stage profile keyed by the frame's plan fingerprint, the
    counted decisions' latency evidence, and the TFG cross-references.
    Imports the plan layer lazily — this module stays loadable offline
    without the verbs."""
    from ..plan import ir as _ir
    from ..plan import stats as _stats

    node = getattr(frame, "_plan", None)
    fp = getattr(frame, "_plan_fp", None)  # stashed at force time —
    # the plan chain itself is dropped once the blocks materialize
    if node is None and fp is None:
        return [
            "profile: frame carries no plan chain and no recorded "
            "execution fingerprint"
        ]
    if not _stats.reopt_enabled():
        return [
            "profile: unavailable — adaptive stats are off "
            "(TFTPU_REOPT=0 or plan_reopt=False)"
        ]
    if fp is None:
        source, nodes = _ir.resolve_chain(node)
        fp = _stats.chain_fingerprint(source, nodes)
    rec = _stats.lookup(fp)
    lines: List[str] = []
    if rec is None:
        return [
            f"profile: fp={fp} — no recorded execution "
            "(force the frame, then explain again)"
        ]
    head = f"profile: fp={fp}  execs={int(rec.get('execs', 0))}"
    if rec.get("wall_s") is not None:
        head += f"  wall={float(rec['wall_s']):.6f}s"
    lines.append(head)
    prof = rec.get("profile")
    if isinstance(prof, list) and prof:
        for entry in prof:
            if isinstance(entry, dict):
                lines.append("  " + _fmt_stage(entry))
    else:
        lines.append("  (no per-stage breakdown recorded yet)")
    # observed join selectivities / pushdown history already recorded
    joins = rec.get("joins")
    if isinstance(joins, dict) and joins:
        for key in sorted(joins):
            obs = joins[key]
            if isinstance(obs, dict):
                kv = "  ".join(
                    f"{k}={obs[k]}" for k in sorted(obs)
                )
                lines.append(f"  join[{key}]: {kv}")
    push = rec.get("push")
    if isinstance(push, dict) and push:
        kv = "  ".join(f"{k}={push[k]}" for k in sorted(push))
        lines.append(f"  pushdown: {kv}")
    # TFG cross-references: the lint rules' evidence, named inline so
    # the profile points straight at the fix
    try:
        _n_maps, barriers = _ir.chain_barriers(frame)
    except Exception:
        barriers = []
    for b in barriers:
        lines.append(
            f"  TFG107 fusion-barrier: {b.get('reason', '?')}"
        )
    for u in _ir.unfused_epilogues(frame):
        lines.append(
            "  TFG109 unfused-aggregate: "
            f"{u.get('verb', '?')} — {u.get('reason', '?')}"
        )
    for m in _ir.pushdown_miss_log(frame):
        lines.append(
            f"  TFG110 missed-pushdown: {m.get('detail', m)}"
        )
    return lines
