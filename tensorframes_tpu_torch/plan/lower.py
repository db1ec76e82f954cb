"""Lowering: turn a plan chain into (ideally) ONE dispatch per block.

``execute_plan`` is the pending computation of every plan-carrying
frame. It resolves the chain to its effective source, splits it into
segments at filters and joins (:mod:`.rules`), and runs each segment
either

* **fused** — the segment's included map stages compose into a single
  :class:`~tensorframes_tpu_torch.program.Program` (map_rows stages enter
  as ``torch.func.vmap`` of their cell function) that runs through the
  ordinary ``map_blocks`` verb, so the block pipeline (prefetch, pinned
  readback) serves a fused segment as it serves one verb, and the
  intermediate columns stay on the device; or
* **per stage** — the exact single-verb execution, taken when a runtime
  barrier shows up (ragged source cells, a host-callback stage) or when
  fusing would not help (a bare single map keeps its own path, lead-dim
  bucketing included).

A segment ending in a ``join`` node runs its probe-side maps fused as
above, then executes the hash join through the SAME
:func:`~tensorframes_tpu_torch.frame._hash_join_cols` core the eager path
uses — over only the columns the needed-columns pass kept on either
side.

``execute_aggregate`` is the pending computation of a plan-recorded
keyed ``aggregate``. Both of its epilogues reach the eager route's
keyed reduction (:func:`~tensorframes_tpu_torch.ops.verbs._segment_reduce_device`:
the ``segment_reduce`` kernel when eligible, else the per-op route with
the ``segment_sum`` kernel):

* ``epilogue_concat`` (float sums and means): the fused maps keep their
  value columns on the device, and the device-concatenated columns feed
  ONE call of the eager route — the same kernel over the same values in
  the same row order as with fusion off, so the same bits;
* ``epilogue_per_block`` (integer sums and means, min, max): each
  block's fused maps end in the same route with that block's int32
  segment ids, and the ``[K, ...]`` partial tables combine across blocks
  on the device — exact, so the same bits.

The mapped value columns never come back to the host on either. When a
join sits below the aggregate, the adaptive optimizer may push the
aggregate below it (``_pushdown_aggregate``). ``lower_reduce`` fuses the
chain into whole-frame ``reduce_blocks``/``reduce_rows`` the same way,
returning per-block partials for the verbs' unchanged combine step.

Nothing falls back quietly: a lowering error raises. Per-stage replay
happens only at the barriers named above (counted in
``tftpu_plan_fallback_total``).

Observability: ``tftpu_plan_*`` metrics are registered at import (the
fused-stages/epilogue counters, the intermediate-bytes-avoided counter,
the plan-lowering-seconds histogram, per-reason fallback counters,
per-decision cost-model counters, per-stage and per-strategy walls) and
``plan.lower`` / ``plan.execute`` spans plus ``plan.cost`` decision
instants land on the structured trace timeline when tracing is on.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability import events as _events
from ..observability.metrics import counter as _counter
from ..observability.metrics import histogram as _histogram
from ..utils import get_logger
from ..utils import profiling
from . import ir
from . import rules as _rules
from . import stats as _stats
from .rules import SegmentPlan, plan_segment, split_segments

logger = get_logger(__name__)

__all__ = [
    "execute_plan", "execute_aggregate", "lower_reduce",
    "canonical_table_order", "fold_partial_tables", "pushdown_misses",
    "estimate_materialized_bytes",
]

# Registered at import so expositions always carry the plan family
# (a process that never fused reads 0 — the series does not vanish).
_FUSED_STAGES = _counter(
    "tftpu_plan_fused_stages_total",
    "Map stages executed inside a fused (single-dispatch) plan segment",
)
_BYTES_AVOIDED = _counter(
    "tftpu_plan_intermediate_bytes_avoided_total",
    "Bytes of intermediate stage outputs never materialized because the "
    "chain ran fused (consumed in-register or pruned by select pushdown)",
)
_LOWER_SECONDS = _histogram(
    "tftpu_plan_lowering_seconds",
    "Wall-clock of lowering one segment to its fused Program "
    "(cache lookup + composition)",
)
_FALLBACKS = {
    reason: _counter(
        "tftpu_plan_fallback_total",
        "Plan segments that fell back to per-stage execution, by reason",
        labels={"reason": reason},
    )
    for reason in (
        "ragged", "host_callback", "trace_error", "single_stage",
        "computed_key",
    )
}
# Whole-pipeline epilogues that fused into the plan, by consuming verb.
_FUSED_EPILOGUES = {
    verb: _counter(
        "tftpu_plan_fused_epilogues_total",
        "Aggregate/reduce/join epilogues executed inside the plan "
        "(mapped inputs never materialized), by verb",
        labels={"verb": verb},
    )
    for verb in ("aggregate", "reduce_blocks", "reduce_rows", "join")
}
# Cost-model decisions, by decision kind (plan/rules.py decide_*): the
# reference's kinds, with its kernel lowerings named as the port's
# (rules.LOWERING_KINDS).
_COST_DECISIONS = {
    kind: _counter(
        "tftpu_plan_cost_decisions_total",
        "Lowering choices made by the plan cost model, by decision",
        labels={"decision": kind},
    )
    for kind in (
        "fuse", "split_single_stage", "epilogue_per_block",
        "epilogue_concat",
        # kernel selection: rules.decide_segment_reduce /
        # decide_decode_attention / decide_ragged_gather
        _rules.CUDA_SEGMENT_REDUCE, _rules.TORCH_SEGMENT_REDUCE,
        _rules.CUDA_DECODE_ATTN, _rules.TORCH_DECODE_ATTN,
        _rules.CUDA_RAGGED_GATHER,
        # adaptive optimizer: aggregate pushdown below joins, multi-join
        # reordering and stats-fed re-optimization (TFTPU_REOPT=0
        # removes them all)
        "pushdown_aggregate", "pushdown_ineligible",
        "pushdown_skipped_selective", "reorder_joins",
        "join_order_static", "reoptimized",
    )
}


def _note_decision(decision: "_rules.Decision") -> None:
    """Count and trace one cost-model decision."""
    c = _COST_DECISIONS.get(decision.kind)
    if c is not None:
        c.inc()
    if _events.TRACER.enabled:
        _events.TRACER.instant(
            "plan.cost", cat="plan",
            decision=decision.kind, reason=decision.reason,
            **{k: str(v) for k, v in decision.details.items()},
        )


def _lowering_seconds_mean() -> Optional[float]:
    """Mean observed lowering wall-clock — the live-metrics input the
    cost model's fuse decision records for post-hoc inspection."""
    if _LOWER_SECONDS.count:
        return _LOWER_SECONDS.sum / _LOWER_SECONDS.count
    return None


# -- per-stage / per-strategy wall observation ------------------------------
# EXPLAIN ANALYZE needs every executed plan stage to leave a profile
# entry (wall, rows, bytes, strategy, lowering time), and the
# latency-driven fuse and epilogue decisions need every strategy
# dispatch to land in the stats sidecar's EWMA table (the kernel
# decisions read no walls: eligibility alone picks the kernel). Both series pre-register at import
# with closed label sets.

#: Closed stage-kind set for tftpu_plan_stage_wall_seconds.
_STAGE_KINDS = (
    "fused", "per_stage", "join", "join_chain", "aggregate",
    "pushdown", "reduce",
)
_STAGE_WALL = {
    s: _histogram(
        "tftpu_plan_stage_wall_seconds",
        "Observed wall-clock of one executed plan stage, by stage kind "
        "(the metric shadow of the EXPLAIN ANALYZE per-stage profile)",
        labels={"stage": s},
    )
    for s in _STAGE_KINDS
}

#: Closed (decision, strategy) pairs for tftpu_plan_strategy_wall_seconds.
_STRATEGY_WALL_PAIRS = (
    ("fuse", "fuse"), ("fuse", "split_single_stage"),
    ("epilogue", "epilogue_per_block"), ("epilogue", "epilogue_concat"),
)
_STRATEGY_WALL = {
    pair: _histogram(
        "tftpu_plan_strategy_wall_seconds",
        "Observed wall-clock of one strategy's dispatch, by (decision, "
        "strategy) — the histogram shadow of the EWMA table that feeds "
        "latency-driven plan decisions",
        labels={"decision": pair[0], "strategy": pair[1]},
    )
    for pair in _STRATEGY_WALL_PAIRS
}


def observe_strategy_wall(decision: str, strategy: str,
                          wall_s: float) -> None:
    """Record one observed strategy dispatch wall: the pre-registered
    histogram plus the stats sidecar's per-(decision, strategy) EWMA
    table — the feedback input decide_fuse and decide_epilogue consult."""
    h = _STRATEGY_WALL.get((decision, strategy))
    if h is not None:
        h.observe(wall_s)
    _stats.observe_strategy_wall(decision, strategy, wall_s)


# Per-force profile collector: execute_plan / execute_aggregate push a
# frame, every executed stage notes itself into the topmost frame, and
# the force records the popped entries into the stats sidecar under its
# plan fingerprint. A stack because forces nest (a join's build side is
# an independent pipeline with its own fingerprint).
_PROFILE_TLS = threading.local()


def _profile_push() -> list:
    stack = getattr(_PROFILE_TLS, "stack", None)
    if stack is None:
        stack = _PROFILE_TLS.stack = []
    frame: list = []
    stack.append(frame)
    return frame


def _profile_pop(frame: list) -> Optional[list]:
    """Detach ``frame`` from the stack (idempotent — record sites pop
    first, the owner's finally pops again harmlessly)."""
    stack = getattr(_PROFILE_TLS, "stack", None)
    if stack is None:
        return None
    try:
        stack.remove(frame)
    except ValueError:
        return None
    return frame


def _profile_note(stage: str, wall_s: float, *, rows: Optional[int] = None,
                  nbytes: Optional[int] = None,
                  strategy: Optional[str] = None,
                  compile_s: Optional[float] = None) -> None:
    """One executed stage's profile entry: always observed on the
    stage-wall histogram, appended to the active force's collector when
    one is open. ``compile_s`` is the lowering time (composition and
    cache lookup: PyTorch compiles nothing)."""
    h = _STAGE_WALL.get(stage)
    if h is not None:
        h.observe(wall_s)
    stack = getattr(_PROFILE_TLS, "stack", None)
    if not stack:
        return
    entry: Dict[str, object] = {"stage": stage, "wall_s": float(wall_s)}
    if rows is not None:
        entry["rows"] = int(rows)
    if nbytes is not None:
        entry["bytes"] = int(nbytes)
    if strategy is not None:
        entry["strategy"] = strategy
    if compile_s is not None:
        entry["compile_s"] = float(compile_s)
    stack[-1].append(entry)


# fused-Program cache: steady-state loops rebuild chains from the same
# stage Programs every iteration; keyed by stage identity + needed
# outputs + source input specs; values pin the stage Programs so ids
# stay live, and hits verify identity against id reuse.
_CACHE_LOCK = threading.Lock()
_FUSED_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_FUSED_CACHE_MAX = 64


def _segment_device(plan: SegmentPlan, default=None):
    """The device a segment's fused program runs on: its stages' (one
    device by construction — ir.node_for_parent splits a chain at a
    device change)."""
    for n in plan.included:
        if n.device is not None:
            return n.device
    for n in plan.nodes:
        if n.device is not None:
            return n.device
    if default is not None:
        return default
    from ..config import resolve_device

    return resolve_device(None)


def _cache_get(key, pinned_expect):
    with _CACHE_LOCK:
        hit = _FUSED_CACHE.get(key)
        if hit is not None:
            fused, pinned = hit
            if len(pinned) == len(pinned_expect) and all(
                p is q for p, q in zip(pinned, pinned_expect)
            ):
                _FUSED_CACHE.move_to_end(key)
                return fused
    return None


def _cache_put(key, fused, pinned) -> None:
    with _CACHE_LOCK:
        _FUSED_CACHE[key] = (fused, tuple(pinned))
        while len(_FUSED_CACHE) > _FUSED_CACHE_MAX:
            _FUSED_CACHE.popitem(last=False)


def _stage_fns(plan: SegmentPlan):
    """Each included stage as ``(fn, input names, output names)``: a
    map_rows stage enters as ``torch.func.vmap`` of its cell function."""
    import torch

    return [
        (torch.func.vmap(n.program.fn) if n.rows else n.program.fn,
         tuple(n.program.input_names), tuple(n.out_names))
        for n in plan.included
    ]


def _input_specs(names: Sequence[str], schema):
    """Block-level input specs for a fused program over ``names``."""
    from ..program import TensorSpec

    return [
        TensorSpec(name, schema[name].dtype, schema[name].block_shape)
        for name in names
    ]


def _output_specs(plan: SegmentPlan):
    """Output specs of the fused program: each computed name's spec from
    its producing stage, lifted to block level (map_rows outputs gain
    the leading batch dim their vmapped form produces)."""
    from ..program import TensorSpec
    from ..shape import Unknown

    by_name = {}
    for n in plan.included:
        for o in (n.program.outputs or []):
            shape = o.shape.prepend(Unknown) if n.rows else o.shape
            by_name[o.name] = TensorSpec(o.name, o.dtype, shape)
    return [by_name[name] for name in plan.computed_names]


def _fused_program(plan: SegmentPlan, schema):
    """Build (or fetch) the composed Program for one segment: stages
    applied in order over a shared column environment, outputs
    restricted to what the segment's consumer needs."""
    from ..program import Program

    in_specs = _input_specs(plan.source_inputs, schema)
    device = _segment_device(plan)
    key = (
        tuple(
            (id(n.program), n.rows, n.out_names) for n in plan.included
        ),
        tuple(plan.computed_names),
        tuple(
            (s.name, s.dtype.name, tuple(s.shape.dims)) for s in in_specs
        ),
        str(device),  # the same stages chained on another device
    )
    pinned = tuple(n.program for n in plan.included)
    hit = _cache_get(key, pinned)
    if hit is not None:
        return hit
    stages = _stage_fns(plan)
    result_names = tuple(plan.computed_names)

    def fn(feeds):
        env = dict(feeds)
        for stage_fn, in_names, out_names in stages:
            outs = stage_fn({k: env[k] for k in in_names})
            for k in out_names:
                env[k] = outs[k]
        return {name: env[name] for name in result_names}

    fused = Program(fn, in_specs, _output_specs(plan),
                    fetch_order=list(result_names))
    fused.device = device
    _cache_put(key, fused, pinned)
    return fused


def _pruned_source(frame, names: Sequence[str]):
    """``frame`` restricted to ``names`` (lazy when ``frame`` is)."""
    from ..frame import TensorFrame

    names = list(names)
    if list(frame.schema.names) == names:
        return frame
    schema = frame.schema.select(names)
    if frame.is_materialized:
        return TensorFrame(
            [{n: b[n] for n in names} for b in frame.blocks()], schema
        )
    return TensorFrame(
        None, schema,
        pending=lambda: [{n: b[n] for n in names} for b in frame.blocks()],
    )


def _segment_ragged(source, input_names: Sequence[str]) -> bool:
    """True when any fused input column holds ragged cells in any source
    block — the block-level program cannot feed them; per-stage map_rows
    regroups rows by shape (and stages them through the ragged gather)."""
    from ..ops.executor import block_is_ragged

    src = set(source.schema.names)
    names = [n for n in input_names if n in src]
    return any(block_is_ragged(b, names) for b in source.blocks())


def _avoided_bytes(plan: SegmentPlan, blocks) -> int:
    """Bytes the fused run never materialized: per avoided output, total
    rows x known cell extent x itemsize (Unknown inner dims skipped —
    an estimate must never overclaim)."""
    from ..frame import _block_num_rows
    from ..shape import Unknown

    rows = sum(_block_num_rows(b) for b in blocks)
    total = 0
    for _, spec in plan.avoided_outputs:
        dims = list(spec.shape.dims)
        if dims and dims[0] == Unknown:
            dims = dims[1:]
        if any(d == Unknown for d in dims):
            continue
        cell = 1
        for d in dims:
            cell *= int(d)
        itemsize = np.dtype(spec.dtype.np_dtype).itemsize
        total += rows * cell * itemsize
    return total


def _run_fused(source, plan: SegmentPlan):
    """One dispatch per block: compose, hand to map_blocks (the block
    pipeline unchanged), re-key to the segment's result columns, apply
    the filter mask if present."""
    from ..frame import TensorFrame, _apply_mask, _block_num_rows
    from ..ops.verbs import map_blocks

    t0 = time.perf_counter()
    src_cols = [
        n for n in source.schema.names
        if n in set(plan.source_inputs) | set(plan.pass_through)
    ]
    pruned = _pruned_source(source, src_cols)
    fused = _fused_program(plan, pruned.schema)
    lower_dt = time.perf_counter() - t0
    _LOWER_SECONDS.observe(lower_dt)
    if _events.TRACER.enabled:
        _events.TRACER.emit_complete(
            "plan.lower", t0, lower_dt,
            args={"stages": len(plan.included)}, cat="plan",
        )
    t_f0 = time.perf_counter()
    mapped = map_blocks(fused, pruned, device=fused.device)
    blocks = mapped.blocks()
    keep = list(plan.final_names)
    if plan.has_filter:
        out_blocks = [
            _apply_mask(b, keep, plan.mask_name) for b in blocks
        ]
        # the eager filter's observability contract: one span, INPUT rows
        profiling.record(
            "filter", time.perf_counter() - t_f0,
            sum(_block_num_rows(b) for b in blocks),
        )
    else:
        out_blocks = [{n: b[n] for n in keep} for b in blocks]
    _FUSED_STAGES.inc(len(plan.included))
    avoided = _avoided_bytes(plan, blocks)
    _BYTES_AVOIDED.inc(avoided)
    _profile_note(
        "fused", time.perf_counter() - t0,
        rows=sum(_block_num_rows(b) for b in blocks),
        nbytes=avoided, strategy="fuse", compile_s=lower_dt,
    )
    return TensorFrame(out_blocks, plan.nodes[-1].schema.select(keep))


def _run_per_stage(source, plan: SegmentPlan):
    """Exact single-verb execution of the segment's nodes (barriers split
    the plan, they never change semantics)."""
    from ..frame import TensorFrame, _apply_mask, _block_num_rows
    from ..ops.verbs import map_blocks, map_rows

    t_seg0 = time.perf_counter()
    cur = source
    for n in plan.nodes:
        if n.kind == "map":
            cur = (map_rows if n.rows else map_blocks)(
                n.program, cur, device=n.device
            )
        elif n.kind == "select":
            cur = cur.select(list(n.names))
        elif n.kind == "filter":
            names = list(n.schema.names)
            t_f0 = time.perf_counter()
            in_blocks = cur.blocks()
            out_blocks = [
                _apply_mask(b, names, n.mask_name) for b in in_blocks
            ]
            profiling.record(
                "filter", time.perf_counter() - t_f0,
                sum(_block_num_rows(b) for b in in_blocks),
            )
            cur = TensorFrame(out_blocks, n.schema)
    keep = list(plan.final_names)
    if list(cur.schema.names) != keep:
        cur = _pruned_source(cur, keep)
    blocks = cur.blocks()
    _profile_note(
        "per_stage", time.perf_counter() - t_seg0,
        rows=sum(_block_num_rows(b) for b in blocks),
        strategy="split_single_stage",
    )
    return cur


def _gather_right(plan: SegmentPlan) -> Dict[str, object]:
    """Force + gather a join segment's (pruned) build side. The build
    side is an INDEPENDENT pipeline: the select escapes the lowering
    re-entrancy guard so it records on ITS plan and pushdown genuinely
    prunes the build chain."""
    from ..frame import _merged_global_columns

    right = plan.join_node.right
    r_needed = set(plan.right_needed or [])
    r_names = [n for n in right.schema.names if n in r_needed]
    with ir.allow_planning():
        if list(right.schema.names) != r_names:
            right_p = right.select(r_names)
        else:
            right_p = right
        return _merged_global_columns(right_p, r_names)


def _run_join(cur, plan: SegmentPlan, rcols: Optional[Dict] = None):
    """Execute a segment's trailing join node: gather the (pruned) probe
    side, force the (pruned) build side, and run the SAME hash join core
    the eager path runs. Returns a one-block frame holding exactly the
    join outputs the consumer needs. ``rcols`` passes pre-gathered build
    columns (the join-chain path forces every build side up front)."""
    from ..frame import (
        TensorFrame,
        _block_num_rows,
        _hash_join_cols,
        _merged_global_columns,
    )

    jn = plan.join_node
    t0 = time.perf_counter()
    if rcols is None:
        rcols = _gather_right(plan)
    lcols = _merged_global_columns(cur, list(cur.schema.names))
    out = _hash_join_cols(lcols, rcols, jn.spec)
    keep = list(plan.join_out_names)
    out = {n: out[n] for n in keep}
    # the eager join span's contract: INPUT rows
    rows_in = _block_num_rows(lcols) + _block_num_rows(rcols)
    profiling.record("join", time.perf_counter() - t0, rows_in)
    _FUSED_EPILOGUES["join"].inc()
    _profile_note(
        "join", time.perf_counter() - t0, rows=rows_in,
        strategy="hash_join",
    )
    return TensorFrame([out], jn.schema.select(keep))


# ---------------------------------------------------------------------------
# adaptive optimizer: join-chain reordering + aggregate pushdown below
# joins + stats feedback. All of it gates on BOTH ``plan_fusion`` and
# ``plan_reopt`` (TFTPU_REOPT=0 restores the static lowering exactly),
# and every rewrite is bit-identical to the unrewritten path by
# construction — see plan/rules.py eligibility.
# ---------------------------------------------------------------------------

def _strip_join(plan: SegmentPlan) -> SegmentPlan:
    """A join segment's inner (pre-join) part as its own plan."""
    return dataclasses.replace(
        plan, join_node=None, right_needed=None, join_out_names=None
    )


def _as_key_array(v):
    """Key column → array form ``group_ids`` accepts (host list columns
    become object arrays, the join core's convention)."""
    if isinstance(v, list):
        u = np.empty(len(v), dtype=object)
        u[:] = v
        return u
    return np.asarray(v)


def _union_key_arrays(a_cols, b_cols):
    """Per-key union arrays for membership encoding — built by the join
    core's own helper, so NaN/string semantics cannot drift."""
    from ..frame import _key_union_col

    return [_key_union_col(a, b) for a, b in zip(a_cols, b_cols)]


def _keys_unique(rcols: Dict[str, object], keys: Sequence[str]) -> bool:
    """True when the key tuple is unique per row (the m=1 condition every
    adaptive join rewrite needs: with at most one match per key, joins
    neither duplicate nor scale rows, so they commute and degenerate to
    semi-join filters)."""
    from ..frame import _block_num_rows
    from ..ops.keys import group_ids

    nr = _block_num_rows({k: rcols[k] for k in keys})
    if nr == 0:
        return True
    _, _, ng = group_ids([_as_key_array(rcols[k]) for k in keys])
    return ng == nr


def _join_stat_key(index: int, keys: Sequence[str]) -> str:
    """Stable per-level stats key inside one plan fingerprint."""
    return f"{index}:{'+'.join(keys)}"


def _note_reoptimized(why: str, details: Dict[str, object]) -> None:
    """Count + trace one stats-informed (feedback) decision."""
    _note_decision(_rules.Decision("reoptimized", why, details))


def _note_flip(decision: "_rules.Decision") -> None:
    """A decide_* choice that flipped on observed strategy walls counts
    as a ``reoptimized`` decision too."""
    if decision.details.get("latency_flip"):
        _note_reoptimized(
            "strategy chosen from observed per-strategy walls "
            "(stats sidecar latency table) instead of the static rule",
            {"decision": decision.kind,
             "observed_wall_s": decision.details.get("observed_wall_s")},
        )


def _sequential_joins(cur, jplans: List[SegmentPlan], rights):
    """Original-order join execution over pre-gathered build sides (the
    runtime path when a chain's m=1 check fails after the build sides
    were already forced)."""
    for k, (p, rc) in enumerate(zip(jplans, rights)):
        if k > 0:
            cur = _pruned_source(cur, p.final_names)
        cur = _run_join(cur, p, rcols=rc)
    return cur


def _run_join_chain(cur, jplans: List[SegmentPlan], fusion_on: bool,
                    fp: Optional[str]):
    """Execute a run of consecutive join segments, reordered by the cost
    model where eligibility holds (rules.plan_join_chain: all-inner,
    base-rooted keys, no build-side callbacks; runtime m=1 via unique
    build keys). Eligible chains pre-rename every column to its final
    name so the hash joins execute in any order — output rows are the
    base rows, in base order, that match every build side."""
    from ..frame import (
        TensorFrame,
        _block_num_rows,
        _hash_join_cols,
        _JoinSpec,
        _merged_global_columns,
    )

    chain, why_not = _rules.plan_join_chain(jplans)
    if chain is None:
        _note_decision(_rules.Decision(
            "join_order_static",
            f"multi-join chain keeps recorded order: {why_not}",
            {"joins": len(jplans)},
        ))
        for p in jplans:
            cur = _run_one_segment(cur, p, fusion_on)
        return cur

    estimates = [
        getattr(p.join_node.right, "estimated_rows", None)
        for p in jplans
    ]
    base = _run_one_segment(cur, _strip_join(jplans[0]), fusion_on)
    rights = [_gather_right(p) for p in jplans]
    for p, rc in zip(jplans, rights):
        if not _keys_unique(rc, p.join_node.spec.keys):
            _note_decision(_rules.Decision(
                "join_order_static",
                "build side has duplicate join keys — m>1 joins "
                "duplicate rows positionally and do not commute",
                {"joins": len(jplans)},
            ))
            return _sequential_joins(base, jplans, rights)

    build_rows = [
        _block_num_rows({k: rc[k] for k in p.join_node.spec.keys})
        for p, rc in zip(jplans, rights)
    ]
    rec = _stats.lookup(fp) if fp else None
    sels: List[Optional[float]] = []
    for idx, lev in enumerate(chain["levels"]):
        obs = ((rec or {}).get("joins") or {}).get(
            _join_stat_key(idx, lev["keys"]), {}
        )
        sels.append(obs.get("row_sel"))
    order, decision, used_stats = _rules.decide_join_order(
        build_rows, sels, estimates
    )
    _note_decision(decision)
    if used_stats:
        _note_reoptimized(
            "join order chosen from observed per-join selectivities "
            "(stats sidecar) instead of build-side size",
            {"order": list(order)},
        )

    base_rename = chain["base_rename"]
    bcols = _merged_global_columns(
        base, [n for n in base.schema.names if n in base_rename]
    )
    lcols = {base_rename[n]: v for n, v in bcols.items()}
    obs_joins: Dict[str, dict] = {}
    all_finals = chain["all_finals"]
    for idx in order:
        lev = chain["levels"][idx]
        rr = lev["right_rename"]
        rcols_f = {rr[n]: v for n, v in rights[idx].items() if n in rr}
        exec_keys = lev["exec_keys"]
        espec = _JoinSpec(
            keys=tuple(exec_keys),
            how="inner",
            lname=tuple(
                (n, n) for n in all_finals
                if n not in exec_keys and n not in lev["nonkey_finals"]
            ),
            rname=tuple((n, n) for n in lev["nonkey_finals"]),
            fill_value=None,
        )
        t_j = time.perf_counter()
        rows_in = _block_num_rows(lcols)
        lcols = _hash_join_cols(lcols, rcols_f, espec)
        rows_out = _block_num_rows(lcols)
        profiling.record(
            "join", time.perf_counter() - t_j,
            rows_in + build_rows[idx],
        )
        _FUSED_EPILOGUES["join"].inc()
        _profile_note(
            "join_chain", time.perf_counter() - t_j,
            rows=rows_in + build_rows[idx], strategy="reordered_join",
        )
        obs_joins[_join_stat_key(idx, lev["keys"])] = {
            "build_rows": int(build_rows[idx]),
            "row_sel": round(rows_out / rows_in, 6) if rows_in else 1.0,
        }
    if fp:
        _stats.record_execution(fp, joins=obs_joins)
    last = jplans[-1]
    keep = list(last.join_out_names)
    out = {n: lcols[n] for n in keep}
    return TensorFrame([out], last.join_node.schema.select(keep))


def _execute_plans(cur, plans: Sequence[SegmentPlan], fusion_on: bool,
                   fp: Optional[str] = None):
    """Run a sequence of segment plans over ``cur``. With the adaptive
    optimizer on, maximal runs of consecutive join segments (only the
    first may carry map stages) route through the reordering path;
    everything else — and everything under TFTPU_REOPT=0 /
    TFTPU_FUSION=0 — executes segment by segment."""
    adaptive = fusion_on and _stats.reopt_enabled()
    i, n = 0, len(plans)
    while i < n:
        j = i
        if adaptive and plans[i].has_join:
            while (
                j + 1 < n
                and plans[j + 1].has_join
                and not plans[j + 1].included
                and not plans[j + 1].has_filter
            ):
                j += 1
        if j > i:
            cur = _run_join_chain(cur, list(plans[i:j + 1]), fusion_on,
                                  fp)
            i = j + 1
        else:
            cur = _run_one_segment(cur, plans[i], fusion_on)
            i += 1
    return cur


def _plan_segments(
    source, nodes: Sequence[ir.PlanNode], final_names: Sequence[str]
) -> List[SegmentPlan]:
    """Split + backward needed-columns pass: segment k must produce what
    segment k+1 reads off its source — k+1's fused inputs plus its
    pass-through columns (join segments map the requirement back through
    the join's rename tables, see rules.plan_segment)."""
    segments = split_segments(nodes)
    plans: List[Optional[SegmentPlan]] = [None] * len(segments)
    need = list(final_names)
    for k in range(len(segments) - 1, -1, -1):
        src_names = (
            source.schema.names if k == 0
            else list(segments[k - 1][-1].schema.names)
        )
        plans[k] = plan_segment(segments[k], need, src_names)
        req = set(plans[k].source_inputs) | set(plans[k].pass_through)
        need = [n for n in src_names if n in req]
    return plans


def _run_one_segment(cur, plan: SegmentPlan, fusion_on: bool):
    """Execute one segment (inner stages + optional trailing join) over
    ``cur``, honoring the escape hatch and the runtime barriers."""
    if not fusion_on:
        cur = _run_per_stage(cur, plan)
        return _run_join(cur, plan) if plan.has_join else cur
    if not plan.included and not plan.has_filter:
        # pushdown pruned every stage (or the segment was pure
        # projection): no program to dispatch — just project
        cur = _pruned_source(cur, plan.final_names)
        return _run_join(cur, plan) if plan.has_join else cur
    fused_ok = plan.fusable
    reason = None
    if fused_ok and any(
        ir.program_has_callback(n.program) for n in plan.included
    ):
        fused_ok, reason = False, "host_callback"
    if fused_ok and _segment_ragged(cur, plan.source_inputs):
        fused_ok, reason = False, "ragged"
    timed_choice = False
    if reason is None:
        # the cost model speaks only when no hard barrier already
        # decided. A fusable segment is a REAL choice (both strategies
        # are bit-identical), so its wall feeds the latency table and
        # observed walls may flip it back to the per-stage replay.
        timed_choice = plan.fusable
        decision = _rules.decide_fuse(
            plan, _lowering_seconds_mean(),
            observed_walls=(
                _stats.strategy_walls("fuse") if timed_choice else None
            ),
        )
        _note_decision(decision)
        _note_flip(decision)
        fused_ok = decision.kind == "fuse"
    if fused_ok:
        t_strat = time.perf_counter()
        cur = _run_fused(cur, plan)
        if timed_choice:
            observe_strategy_wall(
                "fuse", "fuse", time.perf_counter() - t_strat
            )
    else:
        if reason is not None:
            _FALLBACKS[reason].inc()
        elif len(plan.included) <= 1:
            _FALLBACKS["single_stage"].inc()
        t_strat = time.perf_counter()
        cur = _run_per_stage(cur, plan)
        if timed_choice:
            observe_strategy_wall(
                "fuse", "split_single_stage",
                time.perf_counter() - t_strat,
            )
    return _run_join(cur, plan) if plan.has_join else cur


def _stash_fingerprint(node: ir.PlanNode, fp: str) -> None:
    # the frame drops its plan chain at force time, so EXPLAIN ANALYZE
    # needs the fingerprint stashed on the frame itself
    f_res = node.frame()
    if f_res is not None:
        try:
            f_res._plan_fp = fp
        except AttributeError:  # pragma: no cover - exotic frames
            pass


def execute_plan(node: ir.PlanNode) -> List[Dict[str, object]]:
    """Force a plan-carrying frame: lower its chain and return the final
    blocks (the frame's ``pending`` contract)."""
    source, nodes = ir.resolve_chain(node)
    final_names = list(node.schema.names)
    if not nodes:  # degenerate: the node chain collapsed to its source
        return [
            {n: b[n] for n in final_names} for b in source.blocks()
        ]

    plans = _plan_segments(source, nodes, final_names)

    from ..config import get_config

    # the escape hatch is honored at FORCE time too: a chain recorded
    # while fusion was on still executes per stage when the user turns
    # plan_fusion off before forcing
    fusion_on = bool(get_config().plan_fusion)
    fp = None
    if fusion_on and _stats.reopt_enabled():
        # every adaptive execution fingerprints: the per-stage profile
        # EXPLAIN ANALYZE reads back is keyed here
        fp = _stats.chain_fingerprint(source, nodes)
        _stash_fingerprint(node, fp)
    prof = _profile_push() if fp else None
    t_exec = time.perf_counter()
    try:
        # strategy-wall observations inside this force attribute to THIS
        # pipeline (fingerprint prefix) as well as the global table
        with _stats.workload_scope(fp[:12] if fp else None):
            with ir.lowering():
                cur = _execute_plans(source, plans, fusion_on, fp)
            out = [{n: b[n] for n in final_names} for b in cur.blocks()]
    finally:
        entries = _profile_pop(prof) if prof is not None else None
    wall = time.perf_counter() - t_exec
    if fp:
        _stats.record_execution(fp, wall_s=wall, profile=entries)
    if _events.TRACER.enabled:
        args = {"segments": len(plans)}
        if fp:
            args["fp"] = fp
        _events.TRACER.emit_complete(
            "plan.execute", t_exec, wall, args=args, cat="plan",
        )
    return out


# ---------------------------------------------------------------------------
# whole-pipeline epilogues: aggregate / reduce fused onto the map chain
# ---------------------------------------------------------------------------

def _value_dtype(plan: SegmentPlan, schema, name: str):
    """np dtype of value column ``name`` as the fused run produces it:
    a stage output's spec dtype when computed, else the source column's."""
    for n in plan.included:
        for o in (n.program.outputs or []):
            if o.name == name:
                return np.dtype(o.dtype.np_dtype)
    return np.dtype(schema[name].dtype.np_dtype)


def _epilogue_value_bytes(
    plan: SegmentPlan, schema, seg_info, n_rows: int
) -> int:
    """Estimated bytes of the mapped value columns (the concat
    epilogue's device-residency cost; Unknown inner dims skipped so the
    estimate never overclaims)."""
    from ..shape import Unknown

    total = 0
    for x, _, _ in seg_info:
        try:
            dims = list(schema[x].cell_shape.dims)
        except KeyError:
            dims = []
        if any(d == Unknown for d in dims):
            continue
        cell = 1
        for d in dims:
            cell *= int(d)
        total += n_rows * cell * _value_dtype(plan, schema, x).itemsize
    return total


def _block_values(plan: SegmentPlan, schema, value_names, device):
    """A per-block function giving the value columns as tensors on
    ``device``: computed ones from the fused map program (kept on the
    device), pass-through ones straight off the block. Returns
    ``(fn, lowering seconds)``."""
    from .. import dtypes as dt
    from ..ops.executor import gather_feeds

    t0 = time.perf_counter()
    fused = _fused_program(plan, schema) if plan.included else None
    lower_dt = time.perf_counter() - t0
    if fused is not None:
        _LOWER_SECONDS.observe(lower_dt)
    compiled = fused.compiled() if fused is not None else None
    computed = set(plan.computed_names)

    def values(block):
        outs = {}
        if compiled is not None:
            feeds = gather_feeds(block, fused.input_names, fused)
            outs = compiled.run_block(feeds, device, to_numpy=False)
        return {
            x: outs[x] if x in computed
            else dt.to_torch(np.asarray(block[x]), device)
            for x in value_names
        }

    return values, lower_dt


def _per_block_partials(ops_key, num_groups, vals, sids, device):
    """One block's partial tables through the eager route: sums (and, for
    a mean, the sum and a count of ones, both in the value dtype,
    wrapping as the eager route's do), min and max."""
    import torch

    from ..ops.verbs import _segment_reduce_device

    part_ops, part_vals = [], {}
    for x, op in ops_key:
        v = vals[x]
        part_ops.append((x, "reduce_sum" if op == "reduce_mean" else op))
        part_vals[x] = v
        if op == "reduce_mean":
            cx = "__cnt__" + x
            part_ops.append((cx, "reduce_sum"))
            part_vals[cx] = torch.ones(
                v.shape[:1], dtype=v.dtype, device=v.device
            )
    return _segment_reduce_device(
        tuple(part_ops), num_groups, part_vals, sids, device
    )


def _combine_partials(ops_key, partials):
    """Tree-combine per-block partial tables (exact: the caller admits
    only reassociation-safe (op, dtype) pairs) and finish each mean the
    way the eager route does: ``(s / c)`` in the inexact type, cast back
    to the value dtype."""
    import torch

    totals = dict(partials[0])
    for p in partials[1:]:
        for x, op in ops_key:
            if op in ("reduce_sum", "reduce_mean"):
                totals[x] = totals[x] + p[x]
                if op == "reduce_mean":
                    cx = "__cnt__" + x
                    totals[cx] = totals[cx] + p[cx]
            elif op == "reduce_min":
                totals[x] = torch.minimum(totals[x], p[x])
            else:
                totals[x] = torch.maximum(totals[x], p[x])
    out = {}
    for x, op in ops_key:
        v = totals[x]
        if op == "reduce_mean":
            c = totals["__cnt__" + x].reshape((-1,) + (1,) * (v.ndim - 1))
            inexact = v.dtype if v.is_floating_point() else (
                torch.float64 if v.dtype == torch.int64 else torch.float32)
            v = (v.to(inexact) / c.to(inexact)).to(totals[x].dtype)
        out[x] = v
    return out


def execute_aggregate(node: ir.PlanNode) -> List[Dict[str, object]]:
    """Force a plan-recorded keyed aggregate: fuse the upstream map
    chain with a segment-reduce epilogue (strategy chosen by the cost
    model), or run the chain and the eager aggregate over it — at the
    barriers, counted by reason. The mapped value columns never come
    back to the host on any fused path."""
    from ..config import get_config

    adaptive = bool(get_config().plan_fusion) and _stats.reopt_enabled()
    prof = _profile_push() if adaptive else None
    try:
        return _execute_aggregate(node, prof)
    finally:
        if prof is not None:
            _profile_pop(prof)


def _execute_aggregate(
    node: ir.PlanNode, prof: Optional[list]
) -> List[Dict[str, object]]:
    """``execute_aggregate``'s body. The wrapper owns the profile frame;
    the record sites here pop it (idempotently) so the per-stage profile
    lands in the same sidecar write as the aggregate's stats."""
    import torch

    from ..config import get_config
    from ..frame import _block_num_rows
    from ..ops.keys import frame_group_ids
    from ..ops.verbs import (
        _empty_agg_blocks,
        _host_fast_aggregate,
        _segment_reduce_best,
    )

    t_exec = time.perf_counter()
    source, nodes = ir.resolve_chain(node)
    inner = [n for n in nodes if n is not node]
    keys = list(node.keys)
    out_names = list(node.out_names)
    seg_info = list(node.spec)
    need = list(dict.fromkeys(keys + out_names))
    fusion_on = bool(get_config().plan_fusion)
    dev = node.device

    def eager_epilogue(frame, reason: Optional[str]) -> List[Dict[str, object]]:
        """Chain already executed into ``frame``; run the eager keyed
        aggregate over it (bit-identical to TFTPU_FUSION=0)."""
        if reason is not None:
            c = _FALLBACKS.get(reason)
            if c is not None:
                c.inc()
            f = node.frame()
            if f is not None and reason in (
                "computed_key", "ragged", "host_callback"
            ):
                ir.mark_unfused(f, "aggregate", {
                    "computed_key": "group key is computed by a chained "
                                    "stage (group by a source column, or "
                                    "materialize the chain first)",
                    "ragged": "value column holds ragged cells (run "
                              "analyze() to densify)",
                    "host_callback": "a chained stage contains a host "
                                     "callback (keep callbacks out of "
                                     "aggregated chains)",
                }[reason])
        if frame.num_rows == 0:
            return _empty_agg_blocks(node.schema)
        out_key_cols, out_cols, n = _host_fast_aggregate(
            frame, keys, seg_info, out_names, dev
        )
        block = dict(out_key_cols)
        block.update({x: out_cols[x] for x in out_names})
        profiling.record("aggregate", time.perf_counter() - t_exec, n)
        return [block]

    with ir.lowering():
        if not inner:
            return eager_epilogue(source, None)
        plans = _plan_segments(source, inner, need)
        adaptive = fusion_on and _stats.reopt_enabled()
        fp = _stats.chain_fingerprint(source, nodes) if adaptive else None
        if fp:
            _stash_fingerprint(node, fp)

        # ---- aggregate pushdown below a trailing join chain: eligible
        # shapes run the partial aggregate BELOW the join(s) and filter
        # whole groups above — rows never match-expand. Ineligible
        # shapes keep the static path, counted, with the fixable causes
        # recorded (ir.mark_pushdown_miss).
        if adaptive and plans[-1].has_join:
            push, misses = _rules.plan_pushdown(
                plans, keys, seg_info, node.schema
            )
            if push is None:
                if misses:
                    f_res = node.frame()
                    if f_res is not None:
                        for m in misses:
                            ir.mark_pushdown_miss(f_res, m)
                    _note_decision(_rules.Decision(
                        "pushdown_ineligible", misses[0]["detail"],
                        {"cause": misses[0]["cause"]},
                    ))
            else:
                rec = _stats.lookup(fp)
                do_push, decision, used_stats = _rules.decide_pushdown(
                    push, rec
                )
                if used_stats:
                    _note_reoptimized(
                        "pushdown choice informed by observed row "
                        "survival through the joins (stats sidecar)",
                        {"decision": decision.kind},
                    )
                if do_push:
                    mid_p = _execute_plans(
                        source, plans[:push.start], fusion_on, fp
                    )
                    blocks = _pushdown_aggregate(
                        mid_p, plans, push, node, seg_info, fusion_on,
                        fp, decision, t_exec, prof,
                    )
                    if blocks is not None:
                        return blocks
                    # runtime-ineligible (duplicate build keys): finish
                    # exactly as the static path would, from the
                    # already-computed prefix
                    cur = _execute_plans(
                        mid_p, plans[push.start:-1], fusion_on, fp
                    )
                    cur = _run_one_segment(cur, plans[-1], fusion_on)
                    return eager_epilogue(cur, None)
                _note_decision(decision)  # pushdown_skipped_selective

        mid = _execute_plans(source, plans[:-1], fusion_on, fp)
        last = plans[-1]

        if not fusion_on or last.has_join or last.has_filter or not last.included:
            # join/filter-tailed pipelines run their tail through the
            # plan (probe-side maps fused, pushdown applied) and apply
            # the eager keyed reduction directly on the tail's output —
            # no user-visible intermediate frame exists, but the
            # epilogue ran separately, so it does NOT count as fused. A
            # bare pass-through tail (or the escape hatch) likewise
            # takes the eager epilogue; none of these are fallbacks.
            cur = _run_one_segment(mid, last, fusion_on)
            return eager_epilogue(cur, None)
        reason = None
        computed = set()
        for n in last.included:
            computed |= set(n.out_names)
        if any(k in computed for k in keys):
            reason = "computed_key"
        elif any(
            ir.program_has_callback(n.program) for n in last.included
        ):
            reason = "host_callback"
        elif _segment_ragged(mid, last.source_inputs):
            reason = "ragged"
        if reason is not None:
            cur = _run_one_segment(mid, last, fusion_on)
            return eager_epilogue(cur, reason)

        # ---- fused epilogue -------------------------------------------
        t0 = time.perf_counter()
        src_cols = [
            n for n in mid.schema.names
            if n in set(last.source_inputs) | set(last.pass_through)
        ]
        pruned = _pruned_source(mid, src_cols)
        blocks = pruned.blocks()
        rows = [_block_num_rows(b) for b in blocks]
        n_total = sum(rows)
        if n_total == 0:
            return _empty_agg_blocks(node.schema)
        seg_ids, group_key_cols, num_groups = frame_group_ids(mid, keys)

        ops_key = tuple((x, op) for x, op, _ in seg_info)
        ops_and_dtypes = [
            (op, _value_dtype(last, pruned.schema, x))
            for x, op, _ in seg_info
        ]
        decision = _rules.decide_epilogue(
            ops_and_dtypes, num_groups,
            _epilogue_value_bytes(last, pruned.schema, seg_info, n_total),
            observed_walls=_stats.strategy_walls("epilogue"),
        )
        _note_decision(decision)
        _note_flip(decision)

        value_names = [x for x, _, _ in seg_info]
        values, lower_dt = _block_values(
            last, pruned.schema, value_names, dev
        )
        if decision.kind == "epilogue_per_block":
            from .. import dtypes as dt

            partials = []
            off = 0
            for b, nb in zip(blocks, rows):
                if nb == 0:
                    continue
                sids = dt.to_torch(np.ascontiguousarray(
                    seg_ids[off:off + nb], dtype=np.int32), dev)
                off += nb
                partials.append(_per_block_partials(
                    ops_key, num_groups, values(b), sids, dev
                ))
            res = _combine_partials(ops_key, partials)
            out_cols = {x: dt.to_numpy(res[x]) for x, _ in ops_key}
        else:
            # concat epilogue: fused map per block, outputs stay on the
            # device, ONE call of the eager route over the concatenation
            # — the exact kernel, values and row order of the unfused
            # path
            parts: Dict[str, list] = {x: [] for x in value_names}
            for b, nb in zip(blocks, rows):
                if nb == 0:
                    continue
                vb = values(b)
                for x in value_names:
                    parts[x].append(vb[x])
            seg_vals = {
                x: parts[x][0] if len(parts[x]) == 1
                else torch.cat(parts[x])
                for x in value_names
            }
            out_cols = _segment_reduce_best(
                ops_key, num_groups, seg_vals, seg_ids, dev
            )

    _FUSED_STAGES.inc(len(last.included))
    _FUSED_EPILOGUES["aggregate"].inc()
    avoided = SegmentPlan(
        nodes=[], included=[], excluded=[], final_names=[],
        computed_names=[], pass_through=[], source_inputs=[],
        mask_name=None,
        avoided_outputs=[
            (o.name, o)
            for n in last.included for o in (n.program.outputs or [])
        ],
    )
    _BYTES_AVOIDED.inc(_avoided_bytes(avoided, blocks))
    block = dict(zip(keys, group_key_cols))
    block.update({x: out_cols[x] for x in out_names})
    profiling.record("aggregate", time.perf_counter() - t_exec, n_total)
    ep_wall = time.perf_counter() - t0
    observe_strategy_wall("epilogue", decision.kind, ep_wall)
    _profile_note(
        "aggregate", ep_wall, rows=n_total, strategy=decision.kind,
        compile_s=lower_dt,
    )
    if fp:
        _stats.record_execution(
            fp, agg={"num_groups": int(num_groups)},
            wall_s=time.perf_counter() - t_exec,
            profile=_profile_pop(prof) if prof is not None else None,
        )
    if _events.TRACER.enabled:
        _events.TRACER.emit_complete(
            "plan.execute", t_exec, time.perf_counter() - t_exec,
            args={"segments": len(plans), "verb": "aggregate",
                  "epilogue": decision.kind}, cat="plan",
        )
    return [block]


def _pushdown_aggregate(
    mid, plans: Sequence[SegmentPlan], push, node, seg_info,
    fusion_on: bool, fp: Optional[str], decision, t_exec: float,
    prof: Optional[list] = None,
) -> Optional[List[Dict[str, object]]]:
    """Execute an eligible aggregate-below-join rewrite: the partial
    aggregate runs over the pushed side's full row set (maps fused, one
    call of the eager keyed reduction — the segment kernels), and each
    pushed inner join degenerates to a whole-group semi-join filter over
    the partial tables — rows never match-expand through the join, and
    the build sides force only their key columns.

    Bit-identity holds by construction: group encoding is lexicographic
    (row-order independent), a group's join key is functionally
    determined by the group (keys ⊆ group keys), build keys are unique
    (m=1 — verified here, BEFORE any probe-side stage runs, so the
    static path never replays a stage), and every (op, dtype) is
    reassoc-safe, making per-group partials exact.

    Returns the result blocks, or None when a runtime condition fails —
    the caller then finishes on the static path, counted."""
    from ..frame import _merged_global_columns
    from ..ops.keys import frame_group_ids, group_ids
    from ..ops.verbs import _empty_agg_blocks, _segment_reduce_best

    keys = list(node.keys)
    out_names = list(node.out_names)
    ops_key = tuple((x, op) for x, op, _ in seg_info)
    base_plan = _strip_join(plans[push.start])

    def runtime_miss(cause: str, subject: str, detail: str, fix: str):
        f_res = node.frame()
        if f_res is not None:
            ir.mark_pushdown_miss(f_res, {
                "cause": cause, "subject": subject, "detail": detail,
                "fix": fix,
            })
        _note_decision(_rules.Decision(
            "pushdown_ineligible", detail, {"cause": cause},
        ))

    level_keys: List[Optional[Dict[str, object]]] = [None] * len(
        push.levels
    )
    if push.side == "left":
        # a host callback in a build-side chain bars the rewrite: the
        # key-column force here plus a later runtime fallback's full
        # force would run the callback twice
        for lev in push.levels:
            right = plans[lev.plan_index].join_node.right
            rnode = getattr(right, "_plan", None)
            if rnode is not None and not right.is_materialized:
                _, rnodes = ir.resolve_chain(rnode)
                if any(
                    n.kind == "map"
                    and ir.program_has_callback(n.program)
                    for n in rnodes
                ):
                    runtime_miss(
                        "build_callback", "+".join(lev.spec.keys),
                        "a build-side stage contains a host callback; "
                        "the pushdown's key-only force plus a runtime "
                        "fallback would execute it twice",
                        "keep host callbacks out of joined build "
                        "chains, or materialize the build side first",
                    )
                    return None
        # force every pushed build side down to its key columns and
        # verify m=1 BEFORE any probe-side stage runs; innermost level
        # first, matching the static path's forcing order
        for li in range(len(push.levels) - 1, -1, -1):
            lev = push.levels[li]
            spec = lev.spec
            right = plans[lev.plan_index].join_node.right
            kcols = list(spec.keys)
            with ir.allow_planning():
                rsel = (
                    right.select(kcols)
                    if list(right.schema.names) != kcols else right
                )
                rcols = _merged_global_columns(rsel, kcols)
            if not _keys_unique(rcols, spec.keys):
                runtime_miss(
                    "duplicate_build_keys", "+".join(spec.keys),
                    f"build side of the join on {list(spec.keys)} has "
                    "duplicate keys — m>1 matches scale group partials "
                    "and bar the whole-group rewrite",
                    "drop_duplicates the build side on its join keys, "
                    "or accept the aggregate-above path",
                )
                return None
            level_keys[li] = rcols
        B = _run_one_segment(mid, base_plan, fusion_on)
    else:  # side == 'right': aggregate the build frame below the join
        lev = push.levels[0]
        spec = lev.spec
        jn = plans[lev.plan_index].join_node
        right = jn.right
        if any(
            ir.program_has_callback(n.program)
            for n in base_plan.included
        ):
            runtime_miss(
                "probe_callback", "+".join(spec.keys),
                "a probe-side stage contains a host callback; a "
                "runtime fallback after running it would execute the "
                "callback twice",
                "keep host callbacks out of aggregated join chains",
            )
            return None
        for k in spec.keys:
            if jn.schema[k].dtype.name != right.schema[k].dtype.name:
                runtime_miss(
                    "key_dtype_mismatch", k,
                    f"join key {k!r} has dtype "
                    f"{jn.schema[k].dtype.name} on the probe side but "
                    f"{right.schema[k].dtype.name} on the build side — "
                    "the output key column comes from the probe side",
                    "cast the key columns to one dtype before joining",
                )
                return None
        # probe side runs its maps (keys only — plan_segment pruned the
        # probe requirement down to the join keys), then the m=1 check
        B_left = _run_one_segment(mid, base_plan, fusion_on)
        lkcols = _merged_global_columns(B_left, list(spec.keys))
        if not _keys_unique(lkcols, spec.keys):
            runtime_miss(
                "duplicate_build_keys", "+".join(spec.keys),
                f"probe side of the join on {list(spec.keys)} has "
                "duplicate keys — each build row would repeat once per "
                "matching probe row",
                "drop_duplicates the probe side on its join keys, or "
                "accept the aggregate-above path",
            )
            return None
        level_keys[0] = lkcols
        rneed = list(dict.fromkeys(
            list(push.key_base) + list(push.val_base.values())
        ))
        with ir.allow_planning():
            B = (
                right.select(rneed)
                if list(right.schema.names) != rneed else right
            )
            B.blocks()

    if B.num_rows == 0:
        _note_decision(decision)
        profiling.record("aggregate", time.perf_counter() - t_exec, 0)
        return _empty_agg_blocks(node.schema)

    # partial aggregate over the pushed side's full row set: cached key
    # encode + ONE keyed reduction (the route per the cost model)
    seg_ids, group_key_cols, num_groups = frame_group_ids(
        B, push.key_base
    )
    val_cols = {}
    for x in out_names:
        vals = B.column_values(push.val_base[x])
        if vals.dtype == object:
            # the unrewritten path raises identically for ragged cells
            raise ValueError(
                f"Column {push.val_base[x]!r} is ragged; aggregate "
                "requires uniform cells (run analyze() first)."
            )
        val_cols[x] = vals
    out_cols = _segment_reduce_best(
        ops_key, num_groups, val_cols, seg_ids, node.device
    )

    # each pushed inner join = a whole-group semi-join filter (the
    # lexicographic group order is row-order independent, so the
    # surviving groups keep exactly the unrewritten output order)
    mask = np.ones(num_groups, dtype=bool)
    for lev, rcols in zip(push.levels, level_keys):
        if lev.how != "inner":
            continue  # left joins keep every group
        g_arrays = [
            group_key_cols[keys.index(fin)] for fin in lev.key_finals
        ]
        r_arrays = [rcols[k] for k in lev.spec.keys]
        codes, _, _ = group_ids(_union_key_arrays(g_arrays, r_arrays))
        mask &= np.isin(codes[:num_groups], codes[num_groups:])

    n_base = int(len(seg_ids))
    counts = np.bincount(seg_ids, minlength=num_groups)
    surviving_rows = int(counts[mask].sum())
    survival = (surviving_rows / n_base) if n_base else 1.0
    _note_decision(dataclasses.replace(decision, details={
        **decision.details,
        "num_groups": int(num_groups),
        "groups_kept": int(mask.sum()),
        "base_rows": n_base,
        "survival": round(survival, 4),
    }))
    _profile_note(
        "pushdown", time.perf_counter() - t_exec, rows=n_base,
        strategy="pushdown_below_join",
    )
    if fp:
        _stats.record_execution(
            fp,
            push={"survival": round(survival, 6),
                  "levels": len(push.levels)},
            agg={"num_groups": int(num_groups)},
            wall_s=time.perf_counter() - t_exec,
            profile=_profile_pop(prof) if prof is not None else None,
        )
    if not mask.any():
        profiling.record(
            "aggregate", time.perf_counter() - t_exec, n_base
        )
        return _empty_agg_blocks(node.schema)
    surv = np.flatnonzero(mask)
    block: Dict[str, object] = {}
    for i, fin in enumerate(keys):
        block[fin] = group_key_cols[i][surv]
    for x in out_names:
        block[x] = np.asarray(out_cols[x])[surv]
    profiling.record("aggregate", time.perf_counter() - t_exec, n_base)
    if _events.TRACER.enabled:
        _events.TRACER.emit_complete(
            "plan.execute", t_exec, time.perf_counter() - t_exec,
            args={"segments": len(plans), "verb": "aggregate",
                  "epilogue": "pushdown_below_join"}, cat="plan",
        )
    return [block]


def pushdown_misses(frame) -> List[dict]:
    """The fixable causes blocking an aggregate-below-join pushdown on
    ``frame``: the static eligibility walk re-run over the recorded plan
    (pure; never forces the frame, like ``chain_barriers``) plus any
    runtime causes the lowering recorded via ``ir.mark_pushdown_miss``
    (duplicate build-side keys are only discoverable at force time)."""
    out = list(ir.pushdown_miss_log(frame))
    node = getattr(frame, "_plan", None)
    if node is None or node.kind != "aggregate":
        return out
    source, nodes = ir.resolve_chain(node)
    inner = [n for n in nodes if n is not node]
    if not inner or not any(n.kind == "join" for n in inner):
        return out
    keys = list(node.keys)
    need = list(dict.fromkeys(keys + list(node.out_names)))
    try:
        plans = _plan_segments(source, inner, need)
        if not plans or not plans[-1].has_join:
            return out
        push, misses = _rules.plan_pushdown(
            plans, keys, list(node.spec), node.schema
        )
    except Exception:  # pragma: no cover - inspection never raises
        return out
    if push is None:
        seen = {(m.get("cause"), m.get("subject")) for m in out}
        out.extend(
            m for m in misses
            if (m.get("cause"), m.get("subject")) not in seen
        )
    return out


def estimate_materialized_bytes(frame) -> Optional[int]:
    """Host-byte estimate of materializing ``frame``: ``estimated_rows``
    (never forces a lazy chain) × the schema's dense per-row width.
    Unknown cell dims count as 1 and host columns as a pointer-sized
    cell — a deliberate lower bound. None when the row count is
    unknowable before the force."""
    rows = frame.estimated_rows
    if rows is None:
        return None
    per_row = 0
    for info in frame.schema:
        if info.is_device:
            elems = 1
            for d in info.cell_shape.dims:
                if isinstance(d, int):
                    elems *= max(1, d)
            per_row += elems * np.dtype(info.dtype.np_dtype).itemsize
        else:
            per_row += 8
    return int(rows) * per_row


def oversized_materializations(frame) -> List[dict]:
    """TFG111 evidence for ``lint_plan``: forced ``to_host``/``to_numpy``
    materializations on ``frame``'s chain whose estimated bytes exceed
    the block-store budget (``config.block_budget_bytes`` /
    ``TFTPU_BLOCK_BUDGET_MB``). Checks the frame itself and its chain
    source (where :func:`.ir.mark_barrier` records a materialization);
    never forces a lazy frame. The port's single-device frames have no
    ``to_host`` barrier yet (it comes with multi-device frames), so on a
    real chain this finds nothing until then."""
    from ..config import get_config

    budget = get_config().block_budget_bytes
    if budget <= 0:
        return []
    out: List[dict] = []
    node = getattr(frame, "_plan", None)
    source = ir.resolve_chain(node)[0] if node is not None else None
    seen = set()
    for f in (frame, source):
        if f is None or id(f) in seen:
            continue
        seen.add(id(f))
        reason = getattr(f, "_fusion_barrier", None)
        if not reason or "to_host" not in str(reason):
            continue
        est = estimate_materialized_bytes(f)
        if est is None or est <= budget:
            continue
        out.append({
            "reason": str(reason),
            "estimated_bytes": int(est),
            "budget_bytes": int(budget),
            "rows": int(f.estimated_rows or 0),
        })
    return out


def lower_reduce(
    frame, program, out_names: Sequence[str], mode: str, device=None,
) -> Optional[tuple]:
    """Fuse a whole-frame reduce onto ``frame``'s recorded map chain:
    one composed program per block computes the chained stages AND the
    reduce epilogue (the reduce program applied block-level for
    ``reduce_blocks``; the eager pairwise fold for ``reduce_rows``), so
    the mapped columns never come back to the host. Returns
    ``(per_block_partials, input_rows)`` for the verbs' unchanged combine
    step, or None when the chain is ineligible (no plan, barriers) — the
    caller then takes the eager path, which forces the frame through the
    ordinary plan lowering."""
    if getattr(frame, "_plan", None) is None or not ir.fusion_enabled():
        return None
    if frame.is_materialized:
        return None
    # record the epilogue on the IR (branch bookkeeping included: a
    # later consumer of the same lazy frame re-sources on it)
    node = ir.PlanNode(
        "reduce",
        parent=ir.node_for_parent(frame, device),
        program=program,
        out_names=list(out_names),
        spec=mode,
        schema=frame.schema,
        device=device,
    )
    node._extended = True  # terminal: nothing chains on a reduce
    source, nodes = ir.resolve_chain(node)
    inner = [n for n in nodes if n is not node]
    if not inner or any(n.kind not in ("map", "select") for n in inner):
        return None
    plan = plan_segment(inner, list(out_names), source.schema.names)
    if not plan.included:
        return None
    if any(ir.program_has_callback(n.program) for n in plan.included):
        _FALLBACKS["host_callback"].inc()
        return None
    src_cols = [
        n for n in source.schema.names
        if n in set(plan.source_inputs) | set(plan.pass_through)
    ]
    pruned = _pruned_source(source, src_cols)
    if _segment_ragged(pruned, plan.source_inputs):
        _FALLBACKS["ragged"].inc()
        return None

    import torch

    from ..frame import _block_num_rows
    from ..ops.executor import Readback

    t0 = time.perf_counter()
    values, _ = _block_values(plan, pruned.schema, list(out_names), device)
    epilogue = _reduce_epilogue(program, list(out_names), mode)
    partials: List[Dict[str, np.ndarray]] = []
    blocks = pruned.blocks()
    n_rows = 0
    for b in blocks:
        nb = _block_num_rows(b)
        if nb == 0:
            continue
        n_rows += nb
        with torch.inference_mode():
            res = epilogue(values(b))
        partials.append(Readback({x: res[x] for x in out_names}).wait())
    if not partials:
        return None  # all-empty frame: the eager path owns the error
    _FUSED_STAGES.inc(len(plan.included))
    _FUSED_EPILOGUES["reduce_" + mode].inc()
    _profile_note(
        "reduce", time.perf_counter() - t0, rows=n_rows,
        strategy="fused_" + mode,
        compile_s=None,
    )
    avoided = [
        (o.name, o)
        for n in plan.included for o in (n.program.outputs or [])
    ]
    plan_for_bytes = SegmentPlan(
        nodes=[], included=[], excluded=[], final_names=[],
        computed_names=[], pass_through=[], source_inputs=[],
        mask_name=None, avoided_outputs=avoided,
    )
    _BYTES_AVOIDED.inc(_avoided_bytes(plan_for_bytes, blocks))
    return partials, n_rows


def _reduce_epilogue(reduce_program, out_names: List[str], mode: str):
    """The reduce applied to one block's value columns: ``blocks`` mode
    runs the reduce program under the ``x_input`` naming contract;
    ``rows`` mode runs the SAME pairwise fold the eager reduce_rows runs
    (executor.make_pair_fold), so the semantics cannot diverge."""
    if mode == "rows":
        from ..ops.executor import make_pair_fold

        return make_pair_fold(reduce_program, out_names)

    def epilogue(env):
        outs = reduce_program.fn({f"{x}_input": env[x] for x in out_names})
        return {x: outs[x] for x in out_names}

    return epilogue


# ---------------------------------------------------------------------------
# incremental aggregate maintenance: per-chunk partial tables folded into
# the full aggregate. The eligibility gate (rules.incremental_fold_safe
# per (op, out dtype), pass-through group keys, no joins, no host
# callbacks) lives with the caller; THIS is the fold itself — plain host
# arithmetic, exact because every admitted (op, dtype) pair is exactly
# associative/commutative.
# ---------------------------------------------------------------------------

def _table_rows(table: Dict[str, object]) -> int:
    for v in table.values():
        return len(v)
    return 0


def _key_scalar(v):
    """Dict-key form of one group-key cell (numpy scalar → python)."""
    return v.item() if isinstance(v, np.generic) else v


def canonical_table_order(table: Dict[str, object],
                          keys: Sequence[str]) -> Dict[str, object]:
    """Sort an aggregate table's rows by its group-key columns — one
    deterministic row order, so a folded refresh, a full recompute and a
    ``TFTPU_FUSION=0`` run compare byte for byte whatever order each
    path found the groups in. Host sort over python key tuples (group
    counts, not row counts); value columns ride the same permutation."""
    n = _table_rows(table)
    keycols = [table[k] for k in keys if k in table]
    if n <= 1 or not keycols:
        return dict(table)
    order = sorted(
        range(n),
        key=lambda i: tuple(_key_scalar(c[i]) for c in keycols),
    )
    out: Dict[str, object] = {}
    for name, col in table.items():
        if isinstance(col, list):
            out[name] = [col[i] for i in order]
        else:
            arr = np.asarray(col)
            out[name] = arr[np.asarray(order, dtype=np.intp)]
    return out


#: fold op per admitted reducer — each exactly associative/commutative
#: for every dtype incremental_fold_safe admits.
_FOLD_OPS = {
    "reduce_sum": np.add,
    "reduce_min": np.minimum,
    "reduce_max": np.maximum,
}


def fold_partial_tables(
    partials: Sequence[Dict[str, object]],
    keys: Sequence[str],
    ops: Sequence[Tuple[str, str]],
    schema,
) -> Dict[str, object]:
    """Fold per-chunk aggregate partial tables into the full table.

    ``partials`` are the per-chunk aggregate outputs (each one row per
    group key seen in that chunk); ``ops`` is the terminal aggregate's
    ``[(out_name, op)]`` spec (every op a ``_FOLD_OPS`` member);
    ``schema`` the aggregate's result schema, used to type empty
    outputs. Groups accumulate in a dict keyed by the python key tuple;
    the result comes back in :func:`canonical_table_order`. Value dtypes
    are preserved end to end, so int sums fold modularly exactly like
    the segment reduction they replace."""
    keys = list(keys)
    for out_name, op in ops:
        if op not in _FOLD_OPS:
            raise ValueError(
                f"fold_partial_tables: {out_name!r} uses {op!r}, not a "
                f"foldable reducer {sorted(_FOLD_OPS)} — the "
                "eligibility walk must decline before folding"
            )
    acc: "OrderedDict[tuple, Dict[str, object]]" = OrderedDict()
    key_cells: Dict[tuple, tuple] = {}
    for table in partials:
        n = _table_rows(table)
        if n == 0:
            continue
        kcols = [table[k] for k in keys]
        for i in range(n):
            kt = tuple(_key_scalar(c[i]) for c in kcols)
            row = acc.get(kt)
            if row is None:
                acc[kt] = {
                    out: np.asarray(table[out])[i] for out, _ in ops
                }
                key_cells[kt] = tuple(c[i] for c in kcols)
            else:
                for out, op in ops:
                    row[out] = _FOLD_OPS[op](
                        row[out], np.asarray(table[out])[i]
                    )
    out: Dict[str, object] = {}
    groups = list(acc)
    for j, k in enumerate(keys):
        cells = [key_cells[g][j] for g in groups]
        info = schema[k] if schema is not None and k in schema else None
        np_dtype = getattr(getattr(info, "dtype", None), "np_dtype", None)
        if np_dtype is not None and np.dtype(np_dtype) != object:
            out[k] = np.asarray(cells, dtype=np_dtype)
        else:
            out[k] = np.asarray(cells, dtype=object)
    for out_name, _ in ops:
        cells = [acc[g][out_name] for g in groups]
        if cells:
            out[out_name] = np.stack([np.asarray(c) for c in cells])
        else:
            info = schema[out_name] if schema is not None else None
            np_dtype = getattr(getattr(info, "dtype", None),
                               "np_dtype", np.float64)
            out[out_name] = np.zeros((0,), dtype=np_dtype)
    return canonical_table_order(out, keys)
