"""Per-plan-fingerprint execution statistics: the feedback half of the
adaptive optimizer.

The static cost model makes one-shot decisions. This module closes the
loop: every adaptive lowering records what it OBSERVED —
per-join build-side cardinalities and row selectivities, aggregate
group counts, segment wall-clock — keyed by a stable **plan
fingerprint** (a content hash of the logical chain: node kinds, stage
program signatures, join specs, aggregate ops — no ``id()``/``hash()``,
so the same pipeline rebuilt in a new process keys identically). The
next execution of the same pipeline consults the record and picks a
better lowering — join order by observed selectivity instead of build
size, pushdown skipped when the joins are observed to discard most
rows, segment-bucket history warm-started — each consultation counted
as a ``reoptimized`` decision in ``tftpu_plan_cost_decisions_total``.

Persistence: records live in memory and, when ``TFTPU_COMPILE_CACHE``
names a directory, as one JSON sidecar per fingerprint under
``<cache>/planstats/`` (write-temp → ``os.replace``, same durability
discipline). A corrupt, stale, or unreadable record is counted,
quarantined (unlinked), and the decision falls back to static — a
stats problem can never fail a dispatch or change results (stats are
hints; correctness never depends on them).

The fingerprint hashes specs, never code (:func:`_program_sig`), and the
port keeps the reference package's dtype names, so one pipeline keys the
same record in both packages.

``TFTPU_REOPT=0`` (``config.plan_reopt``) disables the whole adaptive
layer: :func:`lookup` returns None, :func:`record_execution` no-ops,
and the lowering keeps the static paths bit-identically.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional

from ..observability.metrics import counter as _counter
from ..utils import get_logger

logger = get_logger(__name__)

__all__ = [
    "FORMAT_VERSION",
    "reopt_enabled",
    "chain_fingerprint",
    "lookup",
    "record_execution",
    "clear_memory",
    "sidecar_dir",
    "observe_strategy_wall",
    "strategy_walls",
    "reset_strategy_walls",
    "workload_scope",
    "current_workload",
    "SW_FORMAT_VERSION",
    "STRATEGY_WALL_ALPHA",
    "STRATEGY_WALL_MIN_SAMPLES",
    "STRATEGY_STALE_OBS",
]

#: Sidecar record format; a version bump quarantines old records.
FORMAT_VERSION = 1

# Registered at import (TFL003): the sidecar family expositions from
# process start even when re-optimization never engages.
_SIDECAR_EVENTS = {
    event: _counter(
        "tftpu_plan_reopt_sidecar_total",
        "Plan-stats sidecar operations (the adaptive optimizer's "
        "feedback store under TFTPU_COMPILE_CACHE), by event",
        labels={"event": event},
    )
    for event in ("load", "store", "quarantine")
}

_LOCK = threading.Lock()
_MEM: "OrderedDict[str, dict]" = OrderedDict()
_MEM_MAX = 256
#: Bound on per-record observation lists (recent distinct group counts).
_OBS_MAX = 16


def reopt_enabled() -> bool:
    """True when the adaptive optimizer may rewrite plans and consult
    or record stats (``TFTPU_REOPT=0`` / ``configure(plan_reopt=False)``
    is the escape hatch back to the static cost model)."""
    from ..config import get_config

    return bool(get_config().plan_reopt)


def sidecar_dir() -> Optional[str]:
    """The sidecar directory under the compile cache root, or None when
    no cache dir is configured (stats then stay in-memory only)."""
    from ..config import get_config

    root = get_config().compilation_cache_dir
    if not root:
        return None
    return os.path.join(root, "planstats")


# ---------------------------------------------------------------------------
# plan fingerprinting: a stable content key for one logical chain
# ---------------------------------------------------------------------------

def _program_sig(program) -> object:
    """Stable signature of a stage/reduce Program: named input/output
    specs (dtype + cell dims). Deliberately not the code — the
    fingerprint must be cheap enough to compute per force, and a
    collision only merges two pipelines' stats (hints, not keys for
    correctness)."""
    try:
        ins = [
            (s.name, s.dtype.name, [str(d) for d in s.shape.dims])
            for s in (program.inputs or [])
        ]
        outs = [
            (s.name, s.dtype.name, [str(d) for d in s.shape.dims])
            for s in (program.outputs or [])
        ]
        return {"in": ins, "out": outs}
    except Exception:  # pragma: no cover - exotic program-likes
        return {"in": [], "out": []}


def _frame_sig(frame) -> object:
    try:
        return [(c.name, c.dtype.name) for c in frame.schema]
    except Exception:  # pragma: no cover
        return []


def _node_sig(node) -> object:
    sig: Dict[str, object] = {"kind": node.kind}
    if node.kind == "map":
        sig["rows"] = bool(node.rows)
        sig["out"] = list(node.out_names)
        sig["program"] = _program_sig(node.program)
    elif node.kind == "select":
        sig["names"] = list(node.names)
    elif node.kind == "filter":
        sig["mask"] = node.mask_name
    elif node.kind == "join":
        spec = node.spec
        sig["keys"] = list(spec.keys)
        sig["how"] = spec.how
        sig["lname"] = [list(p) for p in spec.lname]
        sig["rname"] = [list(p) for p in spec.rname]
        sig["right"] = _frame_sig(node.right)
    elif node.kind == "aggregate":
        sig["keys"] = list(node.keys)
        sig["ops"] = [[x, op] for x, op, _ in (node.spec or ())]
    elif node.kind == "reduce":
        sig["mode"] = str(node.spec)
        sig["out"] = list(node.out_names)
    return sig


def chain_fingerprint(source, nodes) -> str:
    """sha256 content key of one resolved plan chain (source schema +
    per-node signatures). Stable across processes for the same rebuilt
    pipeline — the property the sidecar's survives-restarts contract
    needs."""
    payload = {
        "v": FORMAT_VERSION,
        "source": _frame_sig(source),
        "nodes": [_node_sig(n) for n in nodes],
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


# ---------------------------------------------------------------------------
# the stats table: in-memory cache over the on-disk sidecar
# ---------------------------------------------------------------------------

def _sidecar_path(fp: str) -> Optional[str]:
    d = sidecar_dir()
    if d is None:
        return None
    return os.path.join(d, f"{fp}.json")


def _valid(rec: object, fp: str) -> bool:
    """A sidecar record is usable only when it is structurally what
    this version writes AND names the fingerprint it sits under —
    anything else (corrupt JSON handled by the caller, a format bump,
    a file copied under the wrong name) is stale and quarantines."""
    return (
        isinstance(rec, dict)
        and rec.get("v") == FORMAT_VERSION
        and rec.get("fp") == fp
        and isinstance(rec.get("execs"), int)
    )


def _quarantine(path: str, why: str) -> None:
    _SIDECAR_EVENTS["quarantine"].inc()
    logger.warning(
        "plan-stats sidecar %s is %s; quarantining (static decisions "
        "continue — stats are hints, never correctness)", path, why,
    )
    try:
        os.unlink(path)
    except OSError:  # pragma: no cover - already gone / perms
        pass


def lookup(fp: str) -> Optional[dict]:
    """The stats record for one plan fingerprint, or None (no history,
    re-optimization disabled, or a quarantined sidecar). Never raises."""
    if not reopt_enabled():
        return None
    with _LOCK:
        hit = _MEM.get(fp)
        if hit is not None:
            _MEM.move_to_end(fp)
            # deep copy: the record nests dicts that record_execution
            # merges into — a shallow copy would let a concurrent merge
            # mutate what this caller is reading outside the lock
            return copy.deepcopy(hit)
    path = _sidecar_path(fp)
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path, "r") as f:
            rec = json.load(f)
    except (OSError, ValueError) as e:
        _quarantine(path, f"unreadable ({type(e).__name__})")
        return None
    if not _valid(rec, fp):
        _quarantine(path, "stale (format/fingerprint mismatch)")
        return None
    _SIDECAR_EVENTS["load"].inc()
    with _LOCK:
        _MEM[fp] = rec
        while len(_MEM) > _MEM_MAX:
            _MEM.popitem(last=False)
    return copy.deepcopy(rec)


#: Bound on recorded per-stage profile entries (one execution's stages).
_PROFILE_MAX = 32


def _merge(rec: dict, *, agg: Optional[dict], joins: Optional[dict],
           push: Optional[dict], wall_s: Optional[float],
           profile: Optional[List[dict]] = None) -> dict:
    rec["execs"] = int(rec.get("execs", 0)) + 1
    if agg:
        a = rec.setdefault("agg", {})
        a.update({k: v for k, v in agg.items() if k != "num_groups"})
        if "num_groups" in agg:
            a["num_groups"] = int(agg["num_groups"])
            counts = [int(c) for c in a.get("counts", [])]
            if int(agg["num_groups"]) not in counts:
                counts.append(int(agg["num_groups"]))
            a["counts"] = counts[-_OBS_MAX:]
    if joins:
        j = rec.setdefault("joins", {})
        for key, obs in joins.items():
            j.setdefault(key, {}).update(obs)
    if push:
        rec.setdefault("push", {}).update(push)
    if wall_s is not None:
        rec["wall_s"] = round(float(wall_s), 6)
    if profile:
        # replace, not merge: the profile is the LAST execution's
        # per-stage breakdown (wall/rows/bytes/strategy/compile split)
        # — EXPLAIN ANALYZE shows what just happened, not an average
        rec["profile"] = [
            {k: (round(float(v), 6) if isinstance(v, float) else v)
             for k, v in entry.items()}
            for entry in profile[:_PROFILE_MAX]
        ]
    return rec


def record_execution(fp: str, *, agg: Optional[dict] = None,
                     joins: Optional[dict] = None,
                     push: Optional[dict] = None,
                     wall_s: Optional[float] = None,
                     profile: Optional[List[dict]] = None) -> None:
    """Merge one execution's observations into the record and persist
    the sidecar (best-effort: a write failure logs and moves on)."""
    if not reopt_enabled():
        return
    with _LOCK:
        rec = _MEM.get(fp)
        if rec is None:
            rec = {"v": FORMAT_VERSION, "fp": fp, "execs": 0}
        # deep copy before merging: _merge mutates nested dicts, and
        # records handed out by lookup() must stay frozen snapshots
        rec = _merge(copy.deepcopy(rec), agg=agg, joins=joins,
                     push=push, wall_s=wall_s, profile=profile)
        _MEM[fp] = rec
        _MEM.move_to_end(fp)
        while len(_MEM) > _MEM_MAX:
            _MEM.popitem(last=False)
    path = _sidecar_path(fp)
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(rec, f, sort_keys=True)
        os.replace(tmp, path)
        _SIDECAR_EVENTS["store"].inc()
    except OSError as e:  # pragma: no cover - disk-full etc.
        logger.debug("plan-stats sidecar write failed: %s", e)


def clear_memory() -> None:
    """Drop the in-memory table (tests; the sidecar is untouched)."""
    global _SW_LOADED
    with _LOCK:
        _MEM.clear()
    with _SW_LOCK:
        _SW.clear()
        _SW_WL.clear()
        _SW_LOADED = False


# ---------------------------------------------------------------------------
# the strategy-wall table: observed per-(decision, strategy) latency
# ---------------------------------------------------------------------------
# The fingerprinted records above answer "what did THIS pipeline do".
# Kernel/epilogue strategy choices need the complementary question:
# "what does each strategy COST on this host, whatever the pipeline" —
# the CUDA kernel vs the torch route of a segment reduce, fused vs
# per-stage, per-block vs concat epilogue. One process-wide table keyed (decision, strategy)
# holds an EWMA of observed dispatch wall with a sample count, persisted
# as ONE sidecar (`strategy_walls.json`) under the same write-temp →
# atomic-replace / quarantine-on-corrupt contract as the per-fingerprint
# records. Entries not refreshed within STRATEGY_STALE_OBS observations
# of their decision are stale and dropped (counted as quarantine), the
# same hygiene the selectivity records get from _valid().
#
# v2 adds PER-WORKLOAD tables keyed by a chain-fingerprint prefix: a
# join-heavy pipeline and a pointwise scoring pipeline can legitimately
# disagree about, say, per-block vs concat epilogue on the same host.
# ``workload_scope(fp[:12])`` (installed by execute_plan around each
# dispatch) routes observations into BOTH the workload table and the
# global one; lookups prefer the workload table only once it is
# evidence-grade (≥ STRATEGY_WALL_MIN_SAMPLES samples on ≥ 2
# strategies — one-sided evidence can't rank), else fall back to the
# global table. Old v1 sidecars quarantine on load (format bump).

#: Strategy-wall sidecar format; a bump quarantines old sidecars.
#: (v1 → v2: per-workload tables joined the global one.)
SW_FORMAT_VERSION = 2
#: EWMA smoothing factor for observed strategy walls.
STRATEGY_WALL_ALPHA = 0.3
#: Minimum samples per strategy before a latency-driven flip may engage.
STRATEGY_WALL_MIN_SAMPLES = 2
#: An entry unrefreshed for this many observations of its decision is
#: stale: dropped instead of consulted (a strategy that stopped being
#: exercised months of observations ago is not evidence).
STRATEGY_STALE_OBS = 256

_SW_LOCK = threading.Lock()
_SW: Dict[str, dict] = {}
# workload fingerprint-prefix → {decision: {"obs": int, "strategies": {}}}
_SW_WL: Dict[str, Dict[str, dict]] = {}  # lint: guarded (under _SW_LOCK)
_SW_LOADED = False
# the active workload scope is per-thread: prefetch workers dispatching
# different chains concurrently must not cross-attribute their walls
_SW_SCOPE = threading.local()


@contextmanager
def workload_scope(workload: Optional[str]):
    """Attribute strategy-wall observations on this thread to
    ``workload`` (a chain-fingerprint prefix) for the duration.
    ``None`` is a no-op scope (observations stay global-only).
    Scopes nest; the innermost wins."""
    prev = getattr(_SW_SCOPE, "wl", None)
    _SW_SCOPE.wl = workload
    try:
        yield
    finally:
        _SW_SCOPE.wl = prev


def current_workload() -> Optional[str]:
    """The workload key observations on this thread attribute to."""
    return getattr(_SW_SCOPE, "wl", None)


def _sw_path() -> Optional[str]:
    d = sidecar_dir()
    if d is None:
        return None
    return os.path.join(d, "strategy_walls.json")


def _sw_valid(rec: object) -> bool:
    # v1 sidecars (no "workloads" slot, pre-workload keying) quarantine:
    # their global EWMAs may encode walls a single dominant workload
    # produced, which is exactly the attribution bug v2 fixes
    return (
        isinstance(rec, dict)
        and rec.get("v") == SW_FORMAT_VERSION
        and rec.get("kind") == "strategy_walls"
        and isinstance(rec.get("tables"), dict)
        and isinstance(rec.get("workloads"), dict)
    )


def _sw_merge_table(dst: Dict[str, dict], tables: dict) -> None:
    for decision, table in tables.items():
        if not isinstance(table, dict):
            continue
        mem = dst.setdefault(decision, {"obs": 0, "strategies": {}})
        mem["obs"] = max(int(mem.get("obs", 0)), int(table.get("obs", 0)))
        for strat, ent in (table.get("strategies") or {}).items():
            if isinstance(ent, dict) and "ewma_s" in ent:
                mem["strategies"].setdefault(strat, dict(ent))


def _sw_load_locked() -> None:
    """Merge the on-disk table into memory once per process (under
    _SW_LOCK). Corrupt/stale files quarantine exactly like records."""
    global _SW_LOADED
    if _SW_LOADED:
        return
    _SW_LOADED = True
    path = _sw_path()
    if path is None or not os.path.exists(path):
        return
    try:
        with open(path, "r") as f:
            rec = json.load(f)
    except (OSError, ValueError) as e:
        _quarantine(path, f"unreadable ({type(e).__name__})")
        return
    if not _sw_valid(rec):
        _quarantine(path, "stale (format/kind mismatch)")
        return
    _SIDECAR_EVENTS["load"].inc()
    _sw_merge_table(_SW, rec["tables"])
    for wl, tables in rec["workloads"].items():
        if isinstance(tables, dict):
            _sw_merge_table(_SW_WL.setdefault(wl, {}), tables)


def _sw_prune_one_locked(table: Optional[dict], decision: str) -> None:
    if not table:
        return
    obs = int(table.get("obs", 0))
    stale = [
        s for s, e in table["strategies"].items()
        if obs - int(e.get("last_obs", 0)) > STRATEGY_STALE_OBS
    ]
    for s in stale:
        del table["strategies"][s]
        _SIDECAR_EVENTS["quarantine"].inc()
        logger.warning(
            "strategy-wall entry (%s, %s) is stale (unrefreshed for >%d "
            "observations); dropping (static decisions continue)",
            decision, s, STRATEGY_STALE_OBS,
        )


def _sw_prune_locked(decision: str) -> None:
    _sw_prune_one_locked(_SW.get(decision), decision)
    for tables in _SW_WL.values():
        _sw_prune_one_locked(tables.get(decision), decision)


def _sw_fold_locked(table: dict, strategy: str, wall_s: float) -> None:
    table["obs"] = int(table.get("obs", 0)) + 1
    ent = table["strategies"].get(strategy)
    if ent is None:
        ent = {"ewma_s": float(wall_s), "n": 0}
        table["strategies"][strategy] = ent
    else:
        a = STRATEGY_WALL_ALPHA
        ent["ewma_s"] = a * float(wall_s) + (1.0 - a) * float(ent["ewma_s"])
    ent["ewma_s"] = round(float(ent["ewma_s"]), 9)
    ent["n"] = int(ent.get("n", 0)) + 1
    ent["last_obs"] = table["obs"]


def observe_strategy_wall(decision: str, strategy: str,
                          wall_s: float) -> None:
    """Fold one observed dispatch wall into the (decision, strategy)
    EWMA — the global table always, and the active :func:`workload_scope`
    table too when one is installed — and persist both (best-effort).
    No-op when re-optimization is disabled — TFTPU_REOPT=0 freezes the
    static cost model."""
    if not reopt_enabled():
        return
    wl = current_workload()
    with _SW_LOCK:
        _sw_load_locked()
        _sw_fold_locked(
            _SW.setdefault(decision, {"obs": 0, "strategies": {}}),
            strategy, wall_s,
        )
        if wl is not None:
            _sw_fold_locked(
                _SW_WL.setdefault(wl, {}).setdefault(
                    decision, {"obs": 0, "strategies": {}}
                ),
                strategy, wall_s,
            )
        _sw_prune_locked(decision)
        snapshot = copy.deepcopy(_SW)
        wl_snapshot = copy.deepcopy(_SW_WL)
    path = _sw_path()
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump({"v": SW_FORMAT_VERSION, "kind": "strategy_walls",
                       "tables": snapshot, "workloads": wl_snapshot},
                      f, sort_keys=True)
        os.replace(tmp, path)
        _SIDECAR_EVENTS["store"].inc()
    except OSError as e:  # pragma: no cover - disk-full etc.
        logger.debug("strategy-wall sidecar write failed: %s", e)


def reset_strategy_walls(unlink_sidecar: bool = True) -> None:
    """Drop the strategy-wall table — memory and (by default) the
    sidecar file. For tests and the bench's decision-flip smoke leg,
    which inject synthetic walls to force a flip and must not leave
    them behind for real runs to act on. ``unlink_sidecar=False``
    forgets only this process's memory (the per-test isolation hook:
    the table stays empty because the file is not re-merged either)."""
    global _SW_LOADED
    with _SW_LOCK:
        _SW.clear()
        _SW_WL.clear()
        _SW_LOADED = True  # do not re-merge the file being dropped
    if not unlink_sidecar:
        return
    path = _sw_path()
    if path is not None:
        try:
            os.unlink(path)
        except OSError:
            pass


def strategy_walls(decision: str) -> Dict[str, dict]:
    """Observed-wall entries for one decision: ``{strategy: {"ewma_s",
    "n", "last_obs"}}``, stale entries already dropped. Inside a
    :func:`workload_scope`, the workload's own table answers — but only
    once it is evidence-grade (≥ STRATEGY_WALL_MIN_SAMPLES samples on
    ≥ 2 strategies; a table that has only ever seen one strategy cannot
    rank alternatives) — else the global table is the fallback. Empty
    when re-optimization is disabled or nothing was observed. Never
    raises."""
    if not reopt_enabled():
        return {}
    wl = current_workload()
    with _SW_LOCK:
        _sw_load_locked()
        _sw_prune_locked(decision)
        if wl is not None:
            table = (_SW_WL.get(wl) or {}).get(decision)
            if table:
                ranked = [
                    e for e in table["strategies"].values()
                    if int(e.get("n", 0)) >= STRATEGY_WALL_MIN_SAMPLES
                ]
                if len(ranked) >= 2:
                    return copy.deepcopy(table["strategies"])
        table = _SW.get(decision)
        if not table:
            return {}
        return copy.deepcopy(table["strategies"])
