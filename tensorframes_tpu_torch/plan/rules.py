"""Fusion rules: which stages of a plan chain run as ONE program.

Functions from node chains to :class:`SegmentPlan` descriptions — no
execution, no compilation; the only tracing is the (cached) host-
callback probe that keeps effectful stages out of pushdown pruning.
Four rules:

* **map∘map composition** — consecutive map stages compose into one
  traced function: map_rows stages contribute their already-vmapped
  form, so row-wise chains run under a single ``vmap`` and a row-wise
  stage feeding a block-wise stage composes block-level.
* **select pushdown** — a ``select`` restricts the needed-column set; a
  backward pass over the chain prunes whole stages whose outputs nobody
  consumes and drops dead pass-through columns, so pruned columns are
  never computed, gathered, or transferred.
* **filter fusion** — a device-evaluable predicate's mask program joins
  the upstream fused run (one dispatch computes upstream outputs AND
  the mask); the row subsetting itself is a fusion barrier (its output
  row count is data-dependent), so the chain splits after it and
  downstream stages start a new segment.
* **join pushdown** — a trailing ``join`` node ends its segment (its
  output row count is data-dependent, like a filter's), but the
  needed-columns pass maps the segment's requirements back THROUGH the
  join's rename tables: only the probe-side originals of needed output
  columns flow into the upstream map fusion, and only the needed
  build-side columns are read off the right frame.

The module also hosts the **cost model** (:class:`Decision` and the
``decide_*`` functions): pure functions from segment descriptions +
memoized ``Program.cost_analysis`` + live metric readings to lowering
choices (fuse vs split, aggregate-epilogue strategy, and which
lowering — CUDA kernel or torch route — serves a keyed reduction,
ragged staging and decode attention). The lowering (:mod:`.lower`) counts and traces every
decision; this module never touches metrics itself.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .ir import PlanNode, program_has_callback
from .stats import STRATEGY_WALL_MIN_SAMPLES

__all__ = [
    "SegmentPlan",
    "split_segments",
    "plan_segment",
    "Decision",
    "decide_fuse",
    "decide_epilogue",
    "decide_segment_reduce",
    "decide_decode_attention",
    "decide_ragged_gather",
    "LOWERING_KINDS",
    "reassoc_safe",
    "PushdownPlan",
    "PushdownLevel",
    "plan_pushdown",
    "decide_pushdown",
    "plan_join_chain",
    "decide_join_order",
    "PUSHDOWN_MIN_SURVIVAL",
    "LATENCY_FLIP_MARGIN",
    "pick_by_observed_wall",
]


@dataclasses.dataclass
class SegmentPlan:
    """The lowering-ready description of one chain segment."""

    nodes: List[PlanNode]            # the segment's nodes, in order
    included: List[PlanNode]         # map stages that actually run
    excluded: List[PlanNode]         # map stages pruned by pushdown
    final_names: List[str]           # the segment result's column names
    computed_names: List[str]        # final names produced by stages
    pass_through: List[str]          # final names read straight off source
    source_inputs: List[str]         # source columns the fused program feeds
    mask_name: Optional[str]         # filter mask output (segment-final)
    #: stage outputs computed but never materialized by the fused run —
    #: either consumed by a later stage or pruned by a select; the
    #: intermediate-bytes-avoided accounting reads this
    avoided_outputs: List[Tuple[str, object]]
    #: trailing join node (the segment ends at it) and the pruned
    #: column sets the join actually reads: ``final_names`` then names
    #: the PROBE-side columns the upstream fusion must produce, while
    #: ``join_out_names`` names the join outputs the consumer needs.
    join_node: Optional[PlanNode] = None
    right_needed: Optional[List[str]] = None
    join_out_names: Optional[List[str]] = None

    @property
    def has_filter(self) -> bool:
        return self.mask_name is not None

    @property
    def has_join(self) -> bool:
        return self.join_node is not None

    @property
    def fusable(self) -> bool:
        """Worth the fused dispatch: >= 2 composed stages, a filter
        whose mask joins the upstream program, or a select that pruned
        stages/outputs. A bare single map keeps the single-verb path
        (identical behavior, including map_rows lead-dim bucketing)."""
        if len(self.included) >= 2 or self.has_filter:
            return True
        if self.excluded or self.avoided_outputs:
            return True
        return False


def split_segments(nodes: Sequence[PlanNode]) -> List[List[PlanNode]]:
    """Split a chain at filter and join nodes: both have data-dependent
    output row counts, which bars fusing across them, so each ends its
    segment (a filter's mask program — and a join's probe-side maps —
    still fuse upstream)."""
    segs: List[List[PlanNode]] = []
    cur: List[PlanNode] = []
    for n in nodes:
        cur.append(n)
        if n.kind in ("filter", "join"):
            segs.append(cur)
            cur = []
    if cur:
        segs.append(cur)
    return segs


def plan_segment(
    nodes: Sequence[PlanNode],
    final_names: Sequence[str],
    source_names: Sequence[str],
) -> SegmentPlan:
    """Backward needed-columns pass over one segment.

    ``final_names`` is what the segment's consumer needs (the segment
    schema for the last segment; the next segment's source requirements
    otherwise). Stages none of whose outputs are needed are pruned —
    with their exclusive source inputs, which therefore never gather.

    A segment ending in a ``join`` node maps the needed output columns
    back through the join's rename tables first: the backward pass then
    runs over the probe-side stages with the probe-side requirements,
    and the build-side requirements are recorded as ``right_needed``.
    """
    nodes = list(nodes)
    join_node: Optional[PlanNode] = None
    right_needed: Optional[List[str]] = None
    join_out_names: Optional[List[str]] = None
    if nodes and nodes[-1].kind == "join":
        join_node = nodes[-1]
        spec = join_node.spec
        # keys are always required on both sides (they drive the match);
        # non-key outputs map back to their side's original name
        inv_l = {out: orig for orig, out in spec.lname}
        inv_r = {out: orig for orig, out in spec.rname}
        join_out_names = [
            n for n in join_node.schema.names
            if n in set(final_names) or n in spec.keys
        ]
        left_needed = list(spec.keys)
        right_needed = list(spec.keys)
        for name in join_out_names:
            if name in spec.keys:
                continue
            if name in inv_l:
                left_needed.append(inv_l[name])
            elif name in inv_r:
                right_needed.append(inv_r[name])
        nodes = nodes[:-1]
        final_names = left_needed

    needed: Set[str] = set(final_names)
    mask_name: Optional[str] = None
    included_rev: List[PlanNode] = []
    excluded: List[PlanNode] = []
    for n in reversed(nodes):
        if n.kind == "filter":
            # the mask column is consumed by the subsetting step; every
            # final column passes through the filter unchanged
            mask_name = n.mask_name
            needed.add(n.mask_name)
        elif n.kind == "select":
            # downstream references are validated against the selected
            # schema at verb time, so needed is already a subset of
            # n.names; the node itself adds no requirement
            continue
        elif n.kind == "map":
            outs = set(n.out_names)
            if needed & outs or program_has_callback(n.program):
                # a host-callback stage is kept even when its outputs
                # are all dead: pruning it would elide the callback's
                # side effect, diverging from TFTPU_FUSION=0 (which
                # executes every recorded stage). Keeping it also makes
                # the lowering's callback check see it and replay the
                # segment per-stage — single-verb semantics exactly.
                included_rev.append(n)
                needed = (needed - outs) | set(n.program.input_names)
            else:
                excluded.append(n)
    included = list(reversed(included_rev))

    # forward pass: which included-stage inputs come from the source
    # (vs an earlier included stage's output)
    computed_before: Set[str] = set()
    source_inputs: List[str] = []
    for n in included:
        for i in n.program.input_names:
            if i not in computed_before and i not in source_inputs:
                source_inputs.append(i)
        computed_before |= set(n.out_names)

    src = set(source_names)
    missing = [c for c in source_inputs if c not in src]
    if missing:  # defensive: verb-time validation should make this dead
        raise ValueError(
            f"plan_segment: stage input(s) {missing} are neither source "
            f"columns ({sorted(src)}) nor upstream stage outputs"
        )

    computed = [n for n in final_names if n in computed_before]
    if mask_name is not None and mask_name not in computed:
        computed = computed + [mask_name]
    pass_through = [n for n in final_names if n not in computed_before]
    stray = [c for c in pass_through if c not in src]
    if stray:  # defensive, as above
        raise ValueError(
            f"plan_segment: final column(s) {stray} are neither computed "
            "by a stage nor present on the source"
        )

    fused_outputs = set(computed)
    avoided: List[Tuple[str, object]] = []
    for n in included:
        for o in (n.program.outputs or []):
            if o.name not in fused_outputs:
                avoided.append((o.name, o))
    for n in excluded:
        for o in (n.program.outputs or []):
            avoided.append((o.name, o))

    # NOTE: ``nodes`` holds the segment's INNER (pre-join) nodes only;
    # the trailing join rides in ``join_node`` so the per-stage replay
    # and the fused result schema both see the probe-side chain.
    return SegmentPlan(
        nodes=list(nodes),
        included=included,
        excluded=excluded,
        final_names=list(final_names),
        computed_names=computed,
        pass_through=pass_through,
        source_inputs=source_inputs,
        mask_name=mask_name,
        avoided_outputs=avoided,
        join_node=join_node,
        right_needed=right_needed,
        join_out_names=join_out_names,
    )


# ---------------------------------------------------------------------------
# cost model: pure decision functions. The lowering counts + traces
# every Decision (tftpu_plan_cost_decisions_total{decision=}); this
# module only DECIDES, consulting the memoized Program.cost_analysis
# and whatever live metric readings the caller hands in.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Decision:
    """One lowering choice: ``kind`` is the pre-registered counter label
    (``fuse`` | ``split_single_stage`` | ``epilogue_per_block`` |
    ``epilogue_concat`` | the kernel and adaptive kinds of
    :mod:`.lower`), ``reason`` the
    human-readable why, ``details`` the numbers that drove it (logged on
    the trace event so a decision is reconstructible post-hoc)."""

    kind: str
    reason: str
    details: Dict[str, object] = dataclasses.field(default_factory=dict)


#: An observed-wall flip engages only when the alternative's EWMA beats
#: the static choice's by at least this factor — hysteresis against
#: noisy walls oscillating the strategy (and retracing) every force.
LATENCY_FLIP_MARGIN = 0.8


def pick_by_observed_wall(
    static_kind: str,
    alternatives: Sequence[str],
    observed_walls: Optional[Dict[str, dict]],
) -> Optional[Tuple[str, Dict[str, object]]]:
    """The latency-feedback core of the non-kernel decisions (``fuse``,
    the aggregate epilogue): given the
    statically-preferred strategy, the alternatives the CALLER verified
    are eligible AND bit-identical for this workload, and the observed
    per-strategy wall table (:func:`..stats.strategy_walls`), pick the
    observed-fastest alternative when it beats the static choice's EWMA
    by :data:`LATENCY_FLIP_MARGIN` with enough samples on both sides.
    Returns ``(flipped_kind, evidence_details)`` or None (keep static).
    """
    if not observed_walls:
        return None
    cur = observed_walls.get(static_kind)
    if not cur or int(cur.get("n", 0)) < STRATEGY_WALL_MIN_SAMPLES:
        return None
    cur_w = float(cur.get("ewma_s", 0.0))
    best: Optional[Tuple[str, float]] = None
    for alt in alternatives:
        if alt == static_kind:
            continue
        ent = observed_walls.get(alt)
        if not ent or int(ent.get("n", 0)) < STRATEGY_WALL_MIN_SAMPLES:
            continue
        w = float(ent.get("ewma_s", 0.0))
        if w < cur_w * LATENCY_FLIP_MARGIN and (
            best is None or w < best[1]
        ):
            best = (alt, w)
    if best is None:
        return None
    alt, w = best
    return alt, {
        "latency_flip": True,
        "observed_wall_s": {
            static_kind: round(cur_w, 6), alt: round(w, 6),
        },
        "wall_samples": {
            static_kind: int(cur.get("n", 0)),
            alt: int(observed_walls[alt].get("n", 0)),
        },
    }


def _stage_costs(plan: SegmentPlan) -> Dict[str, float]:
    """Summed memoized cost_analysis over the segment's included stages
    (``FlopCounterMode`` counts matmul-class flops only). No decision
    reads these numbers: they ride the ``plan.cost`` trace event. Costing
    a stage runs its function once more (under FakeTensorMode), so the
    port costs stages only while the event tracer is on, and reads zero
    otherwise."""
    from ..observability import events as _events

    flops = 0.0
    bytes_accessed = 0.0
    if not _events.TRACER.enabled:
        return {"flops": flops, "bytes_accessed": bytes_accessed}
    for n in plan.included:
        try:
            c = n.program.cost_analysis()
            flops += float(c.get("flops", 0.0) or 0.0)
            bytes_accessed += float(c.get("bytes accessed", 0.0) or 0.0)
        except Exception:  # pragma: no cover - cost query must not gate
            pass
    return {"flops": flops, "bytes_accessed": bytes_accessed}


def decide_fuse(
    plan: SegmentPlan, lowering_seconds_mean: Optional[float] = None,
    observed_walls: Optional[Dict[str, dict]] = None,
) -> Decision:
    """Fuse-vs-split for one map segment. Composition is essentially
    always a win once two stages (or a mask/pruning select) are in
    play: the fused dispatch saves one executor round-trip, one
    device<->host materialization, and one output-validation pass PER
    ELIDED STAGE, while the composed program's cost is the sum of its
    parts (the stages run the same ops on device-resident tensors). A bare single map keeps
    the single-verb path — fusing it buys nothing and would bypass the
    specialized lead-dim bucketing.

    ``observed_walls`` (the stats sidecar's per-strategy EWMA table)
    can flip a fusable segment BACK to the per-stage replay when the
    measured per-stage wall beats the fused wall — the replay is the
    TFTPU_FUSION=0 path, bit-identical by the core contract, so the
    flip is always safe."""
    details = _stage_costs(plan)
    details["stages"] = len(plan.included)
    if lowering_seconds_mean is not None:
        details["lowering_seconds_mean"] = round(lowering_seconds_mean, 6)
    if plan.fusable:
        flip = pick_by_observed_wall(
            "fuse", ("split_single_stage",), observed_walls
        )
        if flip is not None:
            kind, evidence = flip
            details.update(evidence)
            return Decision(
                kind,
                "observed walls: the per-stage replay runs faster than "
                "the fused dispatch for this workload (bit-identical — "
                "it IS the TFTPU_FUSION=0 path)",
                details,
            )
        why = (
            f"{len(plan.included)} composable stage(s)"
            + (", mask fuses upstream" if plan.has_filter else "")
            + (
                f", {len(plan.excluded)} stage(s) pruned"
                if plan.excluded else ""
            )
        )
        return Decision("fuse", why, details)
    return Decision(
        "split_single_stage",
        "bare single map keeps the specialized single-verb path "
        "(lead-dim bucketing included); fusing buys no elided dispatch",
        details,
    )


#: ops whose cross-block tree-combine is exact for ANY value dtype
_EXACT_COMBINE_OPS = ("reduce_min", "reduce_max")


def reassoc_safe(op: str, np_dtype) -> bool:
    """True when per-block partials of ``op`` tree-combine to the SAME
    bits as one global reduction over row order: min/max always (order
    free); sum/mean only for integer/bool values (exact associative
    arithmetic). Float sums reassociate — the bit-identical contract
    then requires the concat epilogue instead."""
    import numpy as _np

    if op in _EXACT_COMBINE_OPS:
        return True
    kind = _np.dtype(np_dtype).kind
    return kind in ("i", "u", "b")


def incremental_fold_safe(op: str, np_dtype) -> bool:
    """True when per-CHUNK partials of ``op`` fold across arriving scan
    chunks to the same bits as one aggregation over the whole table —
    the eligibility gate of registered-query incremental maintenance.
    Strictly the :func:`reassoc_safe` contract minus ``reduce_mean``: a
    mean's partials fold only as a (sum, count) companion pair, which
    the partial tables don't carry yet (a named decline, not a wrong
    answer). min/max fold exactly for any
    dtype; sums only for integer/bool accumulation — a float sum's
    fold order differs from the global reduction's row order."""
    if op == "reduce_mean":
        return False
    return reassoc_safe(op, np_dtype)


def decide_epilogue(
    ops_and_dtypes: Sequence[Tuple[str, object]],
    num_groups: int,
    value_bytes: float,
    observed_walls: Optional[Dict[str, dict]] = None,
) -> Decision:
    """Aggregate-epilogue strategy for a fused map→aggregate segment.

    * ``epilogue_per_block`` — the segment reduction fuses INTO each
      block's program (one dispatch per block yields a ``[K, ...]``
      partial table; tables tree-combine). Chosen when every (op,
      value-dtype) pair is reassociation-safe: the combine is then
      bit-identical to the unfused global reduction.
    * ``epilogue_concat`` — the fused map runs per block with outputs
      kept on device, the concatenated values feed ONE segment-reduce
      call (the very route the unfused path runs, over the same values
      in the same row order — bit-identical by construction, at the
      cost of holding the mapped columns in device memory once).

    When every op is reassociation-safe BOTH strategies are exact, so
    the choice is pure latency: ``observed_walls`` (the stats
    sidecar's per-strategy EWMA table) flips per_block → concat when
    the concat epilogue measured faster. Unsafe ops always take concat
    (correctness, never overridden).
    """
    unsafe = [
        (op, str(getattr(dt, "name", dt)))
        for op, dt in ops_and_dtypes
        if not reassoc_safe(op, dt)
    ]
    details = {
        "num_groups": int(num_groups),
        "value_bytes": int(value_bytes),
        "ops": [op for op, _ in ops_and_dtypes],
    }
    if not unsafe:
        flip = pick_by_observed_wall(
            "epilogue_per_block", ("epilogue_concat",), observed_walls
        )
        if flip is not None:
            kind, evidence = flip
            details.update(evidence)
            return Decision(
                kind,
                "observed walls: the concat epilogue runs faster than "
                "per-block partial tables for this workload (both are "
                "exact for reassociation-safe ops — bit-identical "
                "either way)",
                details,
            )
        return Decision(
            "epilogue_per_block",
            "all ops tree-combine exactly (min/max or integer sums): "
            "per-block partial tables, mapped columns never leave the "
            "dispatch",
            details,
        )
    return Decision(
        "epilogue_concat",
        "float sum/mean reassociates across blocks — one segment "
        f"dispatch over device-concatenated values keeps {unsafe} "
        "bit-identical to the unfused path",
        details,
    )


# ---------------------------------------------------------------------------
# kernel selection: which lowering serves each keyed reduction, ragged
# staging and decode attention — the port's CUDA kernel or its torch
# route. Pure decisions; the dispatch sites count them through
# lower._note_decision.
# ---------------------------------------------------------------------------

#: The reference package's kernel-decision labels and the port's. The
#: port has no bincount host route (so no ``host_segment_reduce``), and
#: its kernels are hand-written CUDA, not Pallas; every other decision
#: kind keeps the reference's label. ``None``: no counterpart.
LOWERING_KINDS: Dict[str, Optional[str]] = {
    "pallas_segment_reduce": "cuda_segment_reduce",
    "jit_segment_reduce": "torch_segment_reduce",
    "host_segment_reduce": None,
    "pallas_ragged_gather": "cuda_ragged_gather",
    "pallas_decode_attn": "cuda_decode_attn",
    "xla_decode_attn": "torch_decode_attn",
}
CUDA_SEGMENT_REDUCE = LOWERING_KINDS["pallas_segment_reduce"]
TORCH_SEGMENT_REDUCE = LOWERING_KINDS["jit_segment_reduce"]
CUDA_RAGGED_GATHER = LOWERING_KINDS["pallas_ragged_gather"]
CUDA_DECODE_ATTN = LOWERING_KINDS["pallas_decode_attn"]
TORCH_DECODE_ATTN = LOWERING_KINDS["xla_decode_attn"]


def _on_cuda(device) -> bool:
    return device is not None and getattr(device, "type", str(device)) == "cuda"


def decide_segment_reduce(ops_key, val_cols, num_segments: int, device=None) -> Decision:
    """Keyed-reduction strategy for one segment reduce: ``cuda_segment_reduce``
    (the fused multi-op kernel, ``kernels/segment_reduce.py``) on a CUDA
    device when the kernel's eligibility holds, else
    ``torch_segment_reduce`` (:func:`..ops.verbs.run_segment_fast`: the
    ``segment_sum`` kernel for float32/bfloat16 sums, PyTorch scatter ops
    for the rest). On the CPU every route is torch; an eligible feed
    still computes the kernel's plain version there. Eligibility alone
    decides: no observed wall moves an eligible feed off the kernel."""
    from ..kernels import segment_reduce as _ksr

    details = {
        "num_groups": int(num_segments),
        "ops": [op for _, op in ops_key],
    }
    if _on_cuda(device) and _ksr.eligible(ops_key, val_cols, num_segments):
        return Decision(
            CUDA_SEGMENT_REDUCE,
            "fused multi-op CUDA kernel: every (column, op) partial in ONE "
            "coalesced pass over the rows instead of one scatter per fetch",
            details,
        )
    return Decision(
        TORCH_SEGMENT_REDUCE,
        "per-op route (segment_sum kernel for float sums, PyTorch "
        "scatter ops otherwise): fused kernel ineligible or not on CUDA",
        details,
    )


def _np_dtype(v):
    """numpy dtype of an array or a torch tensor (bfloat16 has none:
    it reads as float32, which classifies the same way)."""
    import numpy as _np

    dtype = getattr(v, "dtype", None)
    if isinstance(dtype, _np.dtype):
        return dtype
    name = str(dtype).removeprefix("torch.")
    if name == "bfloat16":
        return _np.dtype(_np.float32)
    return _np.dtype(name)


def decide_decode_attention(
    num_heads: int, head_dim: int, page_size: int, max_pages: int, device=None,
) -> Decision:
    """Decode-attention lowering for a serving decode engine, chosen
    ONCE at engine build (batched and solo steps run the same choice, so
    the batched==solo and preemption-replay bit-identity gates hold):
    ``cuda_decode_attn`` (the paged int8-KV kernel) on a CUDA device,
    ``torch_decode_attn`` (the plain gather → dequant → attend chain)
    otherwise."""
    details = {
        "heads": int(num_heads), "head_dim": int(head_dim),
        "page_size": int(page_size), "max_pages": int(max_pages),
    }
    if _on_cuda(device):
        return Decision(
            CUDA_DECODE_ATTN,
            "paged int8-KV CUDA kernel: each slot's pages copied in bulk "
            "through its page table and dequantized in registers — no "
            "materialized gather copy",
            details,
        )
    return Decision(
        TORCH_DECODE_ATTN,
        "gather→dequant→attend chain in PyTorch (not on CUDA)",
        details,
    )


def decide_ragged_gather(
    n_rows: int, n_groups: int, cell_dtype, device=None,
) -> Optional[Decision]:
    """Ragged map_rows staging on a CUDA device: the flat-buffer gather
    kernel (``cuda_ragged_gather``) for a single 1-D ragged column of a
    numeric cell dtype; None keeps host staging (``np.stack`` per group
    — the ordinary path, not a counted decision). Off CUDA there is no
    choice to count (the CPU computes the gather's plain version)."""
    import numpy as _np

    if n_rows == 0 or not _on_cuda(device):
        return None
    cell = _np.dtype(cell_dtype)
    # bfloat16 (ml_dtypes' kind "V") is a float the kernel moves too
    if cell.kind not in ("f", "i", "u", "b") and cell.name != "bfloat16":
        return None
    return Decision(
        CUDA_RAGGED_GATHER,
        "single 1-D ragged column: cells move as one flat buffer and "
        "the kernel stages every shape group's padded batch on the device "
        f"({n_groups} shape group(s) — host np.stack and per-group "
        "copies eliminated)",
        {"rows": int(n_rows), "shape_groups": int(n_groups)},
    )


# ---------------------------------------------------------------------------
# adaptive optimizer: aggregate pushdown below joins, join
# reordering, and stats-fed re-optimization. Pure planning/decision
# functions — the lowering executes and counts; TFTPU_REOPT=0 keeps
# all of it off. Every rewrite here is gated on exactness: only
# reassoc_safe (op, dtype) pairs push below a join, only m=1 joins
# (unique build keys, verified at runtime by the lowering) rewrite at
# all, so the rewritten plan is bit-identical to TFTPU_FUSION=0 by
# construction — group encoding is lexicographic (ops/keys.py), hence
# row-order independent, and the surviving-group filter preserves it.
# ---------------------------------------------------------------------------

#: Observed fraction of base rows surviving the pushed-below joins
#: under which pushdown is re-optimized AWAY: aggregating everything
#: below the join costs O(base rows), while highly selective joins
#: leave the aggregate-above path with far fewer rows to reduce.
PUSHDOWN_MIN_SURVIVAL = 0.05


@dataclasses.dataclass
class PushdownLevel:
    """One join the aggregate pushes below (outermost level first)."""

    plan_index: int          # index of the join's segment in ``plans``
    spec: object             # the join's _JoinSpec
    how: str
    #: group-key OUTPUT names aligned 1:1 with ``spec.keys`` — the
    #: lowering's semi-join filter reads these group key columns.
    key_finals: List[str]


@dataclasses.dataclass
class PushdownPlan:
    """Lowering-ready description of an aggregate-below-join rewrite."""

    side: str                # 'left' (probe chain) | 'right' (build frame)
    start: int               # plans index of the innermost pushed segment
    levels: List[PushdownLevel]
    key_base: List[str]      # group-key originals at the pushed side
    val_base: Dict[str, str]  # fetch output name -> pushed-side original


def _miss(cause: str, subject: str, detail: str, fix: str) -> Dict[str, str]:
    return {"cause": cause, "subject": subject, "detail": detail,
            "fix": fix}


def plan_pushdown(plans, keys, seg_info, agg_schema):
    """Static eligibility walk for aggregate pushdown below a trailing
    join chain. Returns ``(PushdownPlan | None, misses)`` — ``misses``
    holds the *fixable* blocking causes (each names the blocking
    column/fetch and a fix; ``ir.mark_pushdown_miss`` records them). Pure: no execution, no
    forcing; the runtime conditions (unique build-side keys, dense
    value cells) are verified by the lowering, which falls back to the
    static path when they fail.

    Eligibility (every rewrite bit-identical to ``TFTPU_FUSION=0``):

    * every fetch's (op, value dtype) is :func:`reassoc_safe` — the
      order-sensitive float sums/means already excluded from
      tree-combining stay excluded here;
    * walking joins outermost→inner, the group keys and every value
      column map to ONE side (join keys live on both); the probe
      (left) side may be descended through multiple bare join
      segments, the build (right) side only at the outermost level
      under ``how='inner'``;
    * each pushed join's keys are covered by the group keys (the group
      then functionally determines the join key, so a group is matched
      or unmatched as a whole — the join degenerates to a semi-join
      filter over whole groups);
    * ``how`` is ``inner`` (groups filter to matched keys) or ``left``
      (no filter) — ``outer`` appends fill-valued rows and never
      pushes.
    """
    misses: List[Dict[str, str]] = []
    L = len(plans)
    if L == 0 or not plans[L - 1].has_join:
        return None, misses
    unsafe = []
    for x, op, _ in seg_info:
        np_dt = getattr(agg_schema[x].dtype, "np_dtype", None)
        if np_dt is None or not reassoc_safe(op, np_dt):
            unsafe.append((x, op))
    if unsafe:
        for x, op in unsafe:
            misses.append(_miss(
                "float_reassoc", x,
                f"fetch {x!r} ({op}) reassociates: a float sum/mean "
                "computed below the join is not bit-identical to the "
                "unfused reduction over joined rows",
                f"aggregate an integer-typed column, or accept the "
                f"epilogue-above path for {x!r} (bit-identity is "
                "mandatory, so order-sensitive float reductions never "
                "push below joins)",
            ))
        return None, misses

    # needs: final (aggregate-schema) name -> name at the current level
    needs: Dict[str, str] = {
        n: n for n in list(keys) + [x for x, _, _ in seg_info]
    }
    levels: List[PushdownLevel] = []
    side: Optional[str] = None
    i = L - 1
    start = i
    while i >= 0 and plans[i].has_join:
        spec = plans[i].join_node.spec
        inv_l = {out: orig for orig, out in spec.lname}
        inv_r = {out: orig for orig, out in spec.rname}
        cur_to_final = {cur: fin for fin, cur in needs.items()}
        gcur = {needs[f] for f in keys}
        missing = [k for k in spec.keys if k not in gcur]
        if missing:
            misses.append(_miss(
                "key_not_grouped", missing[0],
                f"join key(s) {missing} are not group keys, so a group "
                "can span matched and unmatched join keys — the join "
                "cannot degenerate to a whole-group semi-join filter",
                f"group by {missing} as well (the join key then rides "
                "the group), or aggregate before joining",
            ))
            break
        mapped: Dict[str, str] = {}
        left_cols, right_cols = [], []
        for fin, cur in needs.items():
            if cur in spec.keys:
                mapped[fin] = cur
            elif cur in inv_l:
                mapped[fin] = inv_l[cur]
                left_cols.append(fin)
            elif cur in inv_r:
                mapped[fin] = inv_r[cur]
                right_cols.append(fin)
        if right_cols and left_cols:
            misses.append(_miss(
                "mixed_sides", right_cols[0],
                f"column(s) {sorted(left_cols)} come from the probe "
                f"side but {sorted(right_cols)} from the build side — "
                "a partial aggregate below either side cannot produce "
                "both",
                "restrict the group keys and fetches to one side of "
                "the join (join keys count as either side)",
            ))
            break
        if right_cols:
            # build-side pushdown: outermost level only, inner only —
            # unmatched probe rows under how='left' would inject fill
            # values into the groups.
            if levels:
                misses.append(_miss(
                    "mixed_sides", right_cols[0],
                    f"column(s) {sorted(right_cols)} come from an "
                    "inner join's build side below an already-pushed "
                    "level",
                    "restrict the fetches to the probe side, or "
                    "aggregate before the outer joins",
                ))
                break
            if spec.how != "inner":
                misses.append(_miss(
                    "outer_or_left_build", right_cols[0],
                    f"how={spec.how!r} keeps unmatched probe rows "
                    "whose build-side columns take fill values — fills "
                    "would enter the pushed-down groups",
                    "use an inner join, or aggregate probe-side "
                    "columns instead",
                ))
                break
            side = "right"
            levels.append(PushdownLevel(
                plan_index=i, spec=spec, how=spec.how,
                key_finals=[cur_to_final[k] for k in spec.keys],
            ))
            needs = mapped
            start = i
            break
        # probe-side descent
        if spec.how not in ("inner", "left"):
            misses.append(_miss(
                "outer_join", "+".join(spec.keys),
                f"how={spec.how!r} appends unmatched build rows with "
                "fill-valued probe columns — fills would enter the "
                "pushed-down groups",
                "use an inner or left join, or aggregate before "
                "joining",
            ))
            break
        side = "left"
        levels.append(PushdownLevel(
            plan_index=i, spec=spec, how=spec.how,
            key_finals=[cur_to_final[k] for k in spec.keys],
        ))
        needs = mapped
        start = i
        if plans[i].included or i == 0:
            # this segment's own map stages compute below its join —
            # it becomes the base level (maps run, aggregate above
            # them, semi-join filters above that)
            break
        i -= 1
    if not levels:
        return None, misses
    return PushdownPlan(
        side=side,
        start=start,
        levels=levels,
        key_base=[needs[f] for f in keys],
        val_base={x: needs[x] for x, _, _ in seg_info},
    ), misses


def decide_pushdown(
    push: PushdownPlan, stats_record: Optional[dict]
) -> Tuple[bool, Decision, bool]:
    """Push-vs-keep for an eligible aggregate-below-join rewrite.
    Statically pushdown always wins (the join's match expansion and
    gather disappear); the observed-survival feedback re-optimizes it
    AWAY when a previous execution measured that the joins discard
    almost every row (aggregating the full base side then costs more
    than joining first). Returns ``(push?, decision, used_stats)``."""
    details: Dict[str, object] = {
        "levels": len(push.levels), "side": push.side,
    }
    survival = None
    if stats_record:
        survival = (stats_record.get("push") or {}).get("survival")
    if survival is not None:
        details["observed_survival"] = round(float(survival), 4)
        if float(survival) < PUSHDOWN_MIN_SURVIVAL:
            return False, Decision(
                "pushdown_skipped_selective",
                f"observed survival {float(survival):.3f} < "
                f"{PUSHDOWN_MIN_SURVIVAL}: the joins discard nearly "
                "every row, so aggregating above them reduces far "
                "fewer rows than the full pushed-down side",
                details,
            ), True
        return True, Decision(
            "pushdown_aggregate",
            f"{len(push.levels)} join(s) degenerate to whole-group "
            "semi-join filters (observed survival "
            f"{float(survival):.3f}): partial aggregate runs below, "
            "rows never match-expand",
            details,
        ), True
    return True, Decision(
        "pushdown_aggregate",
        f"{len(push.levels)} join(s) degenerate to whole-group "
        "semi-join filters: partial aggregate runs below, rows never "
        "match-expand through the join",
        details,
    ), False


# ---------------------------------------------------------------------------
# multi-join reordering
# ---------------------------------------------------------------------------

def plan_join_chain(jplans) -> Tuple[Optional[dict], str]:
    """Static eligibility + rename maps for reordering a run of
    consecutive join segments. Returns ``(chain_info, reason)`` —
    ``chain_info`` is None when ineligible (``reason`` says why).

    Eligibility (reordering must be bit-identical, like every rewrite):

    * every join is ``inner`` (left/outer fills depend on position);
    * every join's keys trace back to the BASE probe frame (a key
      produced by an earlier join's build side pins that order);
    * no build-side chain contains a host callback (reordering would
      reorder its side effects);
    * with the runtime m=1 condition (unique build keys, checked by
      the lowering), inner joins then commute: the output rows are the
      base rows, in base order, that match EVERY build side — the same
      set whatever the order.

    ``chain_info`` maps every column to its FINAL (output-schema) name
    so the lowering can pre-rename both sides and execute the joins in
    any order without rename chains interfering:

    * ``base_rename``: base column -> final name;
    * per level: ``exec_keys`` (final key names), ``right_rename``
      (build column -> final, key columns included), ``key_base``
      (base-frame names of the keys, for stats/selectivity).
    """
    from .ir import program_has_callback, resolve_chain

    for p in jplans:
        if p.join_node.spec.how != "inner":
            return None, f"how={p.join_node.spec.how!r} join pins its " \
                         "position (only inner joins commute)"
    for p in jplans:
        right = p.join_node.right
        node = getattr(right, "_plan", None)
        if node is not None and not right.is_materialized:
            _, rnodes = resolve_chain(node)
            if any(
                n.kind == "map" and program_has_callback(n.program)
                for n in rnodes
            ):
                return None, "a build-side chain contains a host " \
                             "callback (reordering would reorder its " \
                             "side effects)"

    base_names = list(jplans[0].final_names)
    live: Dict[str, Tuple[str, object]] = {
        n: ("base", n) for n in base_names
    }
    levels: List[dict] = []
    for i, p in enumerate(jplans):
        spec = p.join_node.spec
        lname = dict(spec.lname)
        key_base = []
        for k in spec.keys:
            if k not in live:
                return None, f"join key {k!r} is not visible on the " \
                             "pruned probe side"
            tag, orig = live[k]
            if tag != "base":
                return None, f"join key {k!r} comes from an earlier " \
                             "join's build side — that join must run " \
                             "first"
            key_base.append(orig)
        new_live: Dict[str, Tuple[str, object]] = {}
        for n, origin in live.items():
            if n in spec.keys:
                new_live[n] = origin
            elif n in lname:
                new_live[lname[n]] = origin
            else:  # pragma: no cover - lname covers the full schema
                return None, f"column {n!r} has no rename entry at " \
                             f"join {i}"
        needed_r = set(p.right_needed or [])
        for orig, out in spec.rname:
            if orig in needed_r:
                new_live[out] = (f"right{i}", orig)
        levels.append({"spec": spec, "keys": tuple(spec.keys),
                       "key_base": key_base})
        live = new_live

    finals = list(live)
    if len(set(finals)) != len(finals):  # pragma: no cover - defensive
        return None, "final column names collide"
    base_rename = {orig: fin for fin, (tag, orig) in live.items()
                   if tag == "base"}
    for i, (lev, p) in enumerate(zip(levels, jplans)):
        spec = lev["spec"]
        rr = {orig: fin for fin, (tag, orig) in live.items()
              if tag == f"right{i}"}
        for k, kb in zip(lev["keys"], lev["key_base"]):
            rr[k] = base_rename[kb]
        lev["right_rename"] = rr
        lev["exec_keys"] = tuple(
            base_rename[kb] for kb in lev["key_base"]
        )
        lev["nonkey_finals"] = tuple(
            fin for fin, (tag, _) in live.items() if tag == f"right{i}"
        )
    return {
        "base_rename": base_rename,
        "levels": levels,
        "all_finals": finals,
    }, ""


def decide_join_order(
    build_rows: Sequence[int],
    observed_sels: Sequence[Optional[float]],
    estimates: Sequence[Optional[int]] = (),
) -> Tuple[List[int], Decision, bool]:
    """Execution order for an eligible join run. Static rule: smallest
    build side first (a smaller hash table probes cheaper and — on
    star schemas — correlates with selectivity). Feedback rule: once a
    previous execution observed per-join row selectivity, the most
    selective join runs first so later joins probe fewer rows.
    Returns ``(order, decision, used_stats)``."""
    n = len(build_rows)
    details: Dict[str, object] = {
        "build_rows": [int(b) for b in build_rows],
    }
    if estimates:
        details["estimated_rows"] = [
            (int(e) if e is not None else None) for e in estimates
        ]
    used_stats = all(s is not None for s in observed_sels) and n > 0
    if used_stats:
        details["observed_sel"] = [round(float(s), 4)
                                  for s in observed_sels]
        order = sorted(
            range(n),
            key=lambda i: (float(observed_sels[i]), int(build_rows[i]), i),
        )
        why = "observed per-join row selectivity (stats sidecar): " \
              "most selective join first, later joins probe fewer rows"
    else:
        order = sorted(range(n), key=lambda i: (int(build_rows[i]), i))
        why = "estimated build-side size: smallest hash table first"
    details["order"] = list(order)
    if order == list(range(n)):
        return order, Decision(
            "join_order_static",
            "recorded order already optimal by " + why, details,
        ), used_stats
    return order, Decision("reorder_joins", why, details), used_stats


