"""Lazy verb-chain fusion: logical plans over frames, lowered to one
composed program per block on the device.

A chain like ``map_blocks -> map_rows -> select`` run eagerly reads every
intermediate column back to the host and sends it up again for the
next stage. This package records chains as a small plan IR instead
(:mod:`.ir`), prunes and segments them (:mod:`.rules`), and lowers each
maximal fusable run into a single composed Program dispatched once per
block through the unchanged ``map_blocks`` machinery (:mod:`.lower`).
Keyed aggregates, ``reduce_blocks`` and ``reduce_rows`` fuse as
epilogues: the mapped value columns stay on the device and feed the
segment kernels (or the reduce program) directly.

Fused and per-stage execution are bit-identical by contract; barriers
(ragged cells, host callbacks, trim row-count changes, data-dependent
filters, a change of device, explicit materialization) split the plan
instead of changing semantics. ``TFTPU_FUSION=0`` /
``configure(plan_fusion=False)`` disables planning entirely.

The package is also the adaptive query optimizer: eligible aggregates
push below joins (the join degenerates to a whole-group semi-join
filter), multi-join chains reorder by estimated — then observed —
selectivity, and a per-plan-fingerprint stats sidecar (:mod:`.stats`,
under ``TFTPU_COMPILE_CACHE``) feeds measured cardinalities back into
the cost model, so a recurring pipeline's second execution is counted
``reoptimized``. Every rewrite is gated on exactness, so results stay
bit-identical; ``TFTPU_REOPT=0`` / ``configure(plan_reopt=False)``
restores the static cost model.

Verified UDF lifting (:mod:`.lift`) turns a ``numpy_udf`` stage into a
torch program when it verifies bit for bit on the stage's device, so it
fuses instead of splitting the chain as a host stage.

Importing this package registers the ``tftpu_plan_*`` and
``tftpu_lift_total`` metrics families, so expositions carry them from
process start.
"""

from .ir import (  # noqa: F401
    PlanNode,
    chain_barriers,
    explain_plan,
    fusion_enabled,
    mark_barrier,
    mark_pushdown_miss,
    mark_unfused,
    node_for_parent,
    parent_is_fusable,
    program_has_callback,
    pushdown_miss_log,
    resolve_chain,
    unfused_epilogues,
)
from .lower import execute_aggregate, execute_plan, lower_reduce  # noqa: F401
from . import lift  # noqa: F401  (registers tftpu_lift_total)
from .rules import (  # noqa: F401
    Decision,
    PushdownPlan,
    SegmentPlan,
    decide_epilogue,
    decide_fuse,
    decide_join_order,
    decide_pushdown,
    plan_join_chain,
    plan_pushdown,
    plan_segment,
    reassoc_safe,
    split_segments,
)
from .stats import (  # noqa: F401
    chain_fingerprint,
    reopt_enabled,
)

__all__ = [
    "Decision",
    "PlanNode",
    "PushdownPlan",
    "SegmentPlan",
    "chain_barriers",
    "chain_fingerprint",
    "decide_epilogue",
    "decide_fuse",
    "decide_join_order",
    "decide_pushdown",
    "execute_aggregate",
    "execute_plan",
    "explain_plan",
    "fusion_enabled",
    "lower_reduce",
    "plan_join_chain",
    "plan_pushdown",
    "plan_segment",
    "pushdown_miss_log",
    "reassoc_safe",
    "reopt_enabled",
    "split_segments",
    "unfused_epilogues",
]
