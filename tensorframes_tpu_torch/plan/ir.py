"""The logical-plan IR: verb chains recorded as linked nodes.

Every lazy verb on a frame appends one :class:`PlanNode` instead of
nesting another compute thunk, so at force time the whole chain is
visible at once and :mod:`.lower` can fuse each maximal run of map
stages into a single composed program per block: the stages' functions
run one after another over the block's tensors on the device, and the
intermediate columns never come back to the host.

Node kinds:

* ``source`` — wraps a frame with no (live) plan: the chain's input.
* ``map`` — one map_blocks (``rows=False``) or map_rows (``rows=True``)
  stage carrying its normalized, feed_dict-renamed :class:`Program`.
* ``select`` — column projection; drives pushdown pruning in
  :mod:`.rules` so dead columns are never computed, gathered, or
  transferred.
* ``filter`` — row subsetting by the mask column its parent ``map``
  stage computes; fuses the mask program into the upstream run and
  splits the chain for downstream stages (a data-dependent row count is
  a fusion barrier by nature).
* ``join`` — a hash join whose probe (left) side is this chain;
  ``right`` holds the build-side frame (an independent plan input, so a
  strong reference) and ``spec`` the normalized join description
  (:class:`tensorframes_tpu_torch.frame._JoinSpec`). Like ``filter`` it
  ends its segment, but the upstream probe-side maps fuse into the
  probe dispatch and the needed-columns pass prunes through it on both
  sides.
* ``aggregate`` — a keyed segment-reduce epilogue: ``program`` is the
  normalized reduce program, ``keys`` the group-by columns, ``spec`` the
  ``segment_reduce_info`` op list. Terminal: the lowering composes the
  upstream fused maps with the segment reduction, so the mapped value
  columns are never materialized on the host.
* ``reduce`` — a whole-frame ``reduce_blocks``/``reduce_rows`` epilogue
  (``spec`` is the mode string); terminal like ``aggregate``.

Every node records the ``device`` its stage runs on (the port's verbs
take ``device=``): a stage that asks for another device than the chain
it extends starts a new chain on the parent frame instead — a barrier
named ``device change: <a> -> <b>``.

Nodes hold a **weak** reference to the frame they describe: if an
intermediate frame was already forced, :func:`resolve_chain` re-roots
the chain there instead of recomputing upstream stages.

Fusion barriers that do NOT create nodes (trim maps, ``repartition``,
device changes, host-callback programs) mark the frames they produce
via :func:`mark_barrier`; :func:`chain_barriers` reads the marks.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

__all__ = [
    "PlanNode",
    "allow_planning",
    "fusion_enabled",
    "lowering",
    "lowering_active",
    "node_for_parent",
    "resolve_chain",
    "mark_barrier",
    "mark_unfused",
    "unfused_epilogues",
    "mark_pushdown_miss",
    "pushdown_miss_log",
    "parent_is_fusable",
    "program_has_callback",
    "chain_barriers",
    "explain_plan",
]


class PlanNode:
    """One step of a logical plan (immutable after construction)."""

    __slots__ = (
        "kind",        # 'source'|'map'|'select'|'filter'|'join'|'aggregate'|'reduce'
        "parent",      # upstream PlanNode (None for source)
        "source_frame",  # kind == 'source': the wrapped frame (strong ref)
        "program",     # 'map': stage Program; 'aggregate'/'reduce': reduce Program
        "rows",        # kind == 'map': True for map_rows semantics
        "out_names",   # 'map': program outputs; 'aggregate'/'reduce': fetch names
        "names",       # kind == 'select': kept column names, in order
        "mask_name",   # kind == 'filter': the mask column (parent map's out)
        "right",       # kind == 'join': the build-side frame (strong ref)
        "spec",        # 'join': _JoinSpec; 'aggregate': seg_info; 'reduce': mode
        "keys",        # kind == 'aggregate': group-by column names
        "schema",      # result Schema of this node's frame
        "device",      # torch.device the stage runs on (None: inherits)
        "_frame_ref",  # weakref to the frame this node describes
        "_extended",   # a downstream node already chains on this one
    )

    def __init__(
        self,
        kind: str,
        parent: Optional["PlanNode"] = None,
        source_frame=None,
        program=None,
        rows: bool = False,
        out_names: Sequence[str] = (),
        names: Sequence[str] = (),
        mask_name: Optional[str] = None,
        right=None,
        spec=None,
        keys: Sequence[str] = (),
        schema=None,
        device=None,
    ):
        self.kind = kind
        self.parent = parent
        self.source_frame = source_frame
        self.program = program
        self.rows = rows
        self.out_names = tuple(out_names)
        self.names = tuple(names)
        self.mask_name = mask_name
        self.right = right
        self.spec = spec
        self.keys = tuple(keys)
        self.schema = schema
        if device is None and parent is not None:
            device = parent.device
        self.device = device
        self._frame_ref = None
        self._extended = False

    def bind(self, frame) -> "PlanNode":
        self._frame_ref = weakref.ref(frame)
        return self

    def frame(self):
        return self._frame_ref() if self._frame_ref is not None else None

    def __repr__(self) -> str:
        if self.kind == "map":
            verb = "map_rows" if self.rows else "map_blocks"
            return f"{verb}({', '.join(self.out_names)})"
        if self.kind == "select":
            return f"select({list(self.names)})"
        if self.kind == "filter":
            return f"filter(mask={self.mask_name!r})"
        if self.kind == "join":
            return (
                f"join(on={list(self.spec.keys)}, how={self.spec.how!r})"
            )
        if self.kind == "aggregate":
            ops = [op for _, op, _ in (self.spec or ())]
            return f"aggregate(keys={list(self.keys)}, ops={ops})"
        if self.kind == "reduce":
            return f"reduce_{self.spec}({', '.join(self.out_names)})"
        return "source"


# ---------------------------------------------------------------------------
# lowering re-entrancy guard: the lowering pass executes stages through
# the ordinary verbs, which must not re-plan while it runs
# ---------------------------------------------------------------------------

_TLS = threading.local()


def lowering_active() -> bool:
    return getattr(_TLS, "depth", 0) > 0


@contextlib.contextmanager
def lowering():
    _TLS.depth = getattr(_TLS, "depth", 0) + 1
    try:
        yield
    finally:
        _TLS.depth -= 1


@contextlib.contextmanager
def allow_planning():
    """Escape the re-entrancy guard for an INDEPENDENT chain: the
    lowering pass must not re-plan the chain it is executing, but a
    join's build side is its own pipeline — planning (and therefore
    pushdown-pruning) it is both safe and required. Restores the ambient
    depth on exit."""
    depth = getattr(_TLS, "depth", 0)
    _TLS.depth = 0
    try:
        yield
    finally:
        _TLS.depth = depth


def fusion_enabled() -> bool:
    """True when verbs should record plan nodes: the ``plan_fusion``
    knob is on (``TFTPU_FUSION=0`` is the escape hatch) and we are not
    inside the lowering pass itself."""
    from ..config import get_config

    return bool(get_config().plan_fusion) and not lowering_active()


def node_for_parent(frame, device=None) -> PlanNode:
    """The plan node a new stage should chain onto: the parent's own
    plan when it is still lazy, unbranched and on the same device, else
    a fresh source wrapping the frame. The branch rule bounds duplicate
    work on DAG-shaped pipelines: the FIRST consumer extends the chain;
    every LATER consumer sources on the frame itself, so forcing it
    materializes the shared prefix exactly once. A stage on another
    device than the chain's also sources on the frame, which is marked
    as a barrier (``device change``)."""
    node = getattr(frame, "_plan", None)
    if node is not None and not frame.is_materialized:
        if (
            device is not None
            and node.device is not None
            and node.device != device
        ):
            mark_barrier(
                frame, f"device change: {node.device} -> {device}", frame
            )
        elif not node._extended:
            node._extended = True
            return node
    return PlanNode("source", source_frame=frame, schema=frame.schema)


def resolve_chain(node: PlanNode) -> Tuple[object, List[PlanNode]]:
    """Walk ``node``'s ancestry to the effective source: the first
    source node, or the first intermediate frame that has already been
    forced (its cached blocks are authoritative). Returns
    ``(source_frame, nodes)`` with ``nodes`` ordered source-most first,
    ending at ``node``."""
    nodes: List[PlanNode] = []
    cur = node
    while True:
        if cur.kind == "source":
            return cur.source_frame, list(reversed(nodes))
        f = cur.frame()
        if f is not None and f.is_materialized and nodes:
            return f, list(reversed(nodes))
        nodes.append(cur)
        cur = cur.parent


# ---------------------------------------------------------------------------
# barrier bookkeeping
# ---------------------------------------------------------------------------

def parent_is_fusable(frame) -> bool:
    """True when ``frame`` came out of a (fusable) map chain."""
    return (
        getattr(frame, "_plan", None) is not None
        or getattr(frame, "_produced_by_map", False)
    )


def mark_barrier(frame, reason: str, parent) -> None:
    """Record that ``frame`` was produced by (or ends at) a fusion
    barrier, so :func:`chain_barriers` can name it. No change in
    semantics."""
    try:
        frame._fusion_barrier = reason
        frame._fusion_barrier_upstream = parent_is_fusable(parent)
    except AttributeError:  # pragma: no cover - exotic frame-likes
        pass


def mark_unfused(frame, verb: str, reason: str) -> None:
    """Record that ``frame`` came out of an ``aggregate``/``join`` whose
    epilogue stayed a fusion barrier for a *fusable* reason. Called at
    verb time for causes known then (non-algebraic fetches) and at force
    time for runtime ones (ragged value cells, a group key computed by a
    chained stage)."""
    try:
        log = getattr(frame, "_plan_unfused", None)
        if log is None:
            log = frame._plan_unfused = []
        log.append({"verb": verb, "reason": reason})
    except AttributeError:  # pragma: no cover - exotic frame-likes
        pass


def unfused_epilogues(frame) -> List[dict]:
    """The evidence recorded by :func:`mark_unfused` (empty when every
    epilogue fused, or nothing was recorded)."""
    return list(getattr(frame, "_plan_unfused", ()) or ())


def mark_pushdown_miss(frame, miss: dict) -> None:
    """Record that an aggregate above a join missed the pushdown rewrite
    for a *fixable* cause: static ones (order-sensitive float fetches,
    group keys not covering the join key, mixed-side columns) from the
    eligibility walk, runtime ones (duplicate build-side keys) when the
    lowering's m=1 check fails."""
    try:
        log = getattr(frame, "_plan_pushdown_miss", None)
        if log is None:
            log = frame._plan_pushdown_miss = []
        log.append(dict(miss))
    except AttributeError:  # pragma: no cover - exotic frame-likes
        pass


def pushdown_miss_log(frame) -> List[dict]:
    """The evidence recorded by :func:`mark_pushdown_miss`."""
    return list(getattr(frame, "_plan_pushdown_miss", ()) or ())


def program_has_callback(program) -> bool:
    """True when the program reaches back to the host while it runs —
    such a stage executes per stage, so its side effects happen exactly
    as with fusion off. A numpy_udf stage says so itself (plan/lift): a
    verified lift (``_tftpu_lifted``) never is one, its host stage
    (``_tftpu_has_callback = True``) always is, though that stage runs
    under ``FakeTensorMode`` without touching data. Any other program
    counts as a callback when running it under ``FakeTensorMode`` fails
    (``.item()``, ``.numpy()``, ``.tolist()`` and data-dependent shapes
    do): a trace failure is treated as a callback, never fusing what
    cannot be seen. Cached on the Program."""
    if getattr(program, "_tftpu_lifted", False):
        return False
    cached = getattr(program, "_tftpu_has_callback", None)
    if cached is not None:
        return cached
    try:
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode

        from ..program import _probe_inputs

        device = torch.device(
            program.device if getattr(program, "device", None) is not None
            else "cpu"
        )
        with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
            program.fn(_probe_inputs(program.inputs, 3, device))
        has = False
    except Exception:
        has = True
    try:
        program._tftpu_has_callback = has
    except AttributeError:  # pragma: no cover
        pass
    return has


def chain_barriers(frame):
    """Inspect ``frame``'s plan chain for fusion barriers sitting
    between otherwise-fusable maps. Returns ``(n_map_stages, barriers)``
    where each barrier is a dict with ``reason``, ``upstream_maps``,
    ``downstream_maps``. Never forces a lazy frame."""
    node = getattr(frame, "_plan", None)
    barriers: List[dict] = []
    if node is None:
        return 0, barriers
    source, nodes = resolve_chain(node)
    maps = [n for n in nodes if n.kind == "map"]
    # host-callback stages inside the chain split the fused run as soon
    # as they have a fusable neighbor on either side
    for i, n in enumerate(maps):
        if len(maps) >= 2 and program_has_callback(n.program):
            barriers.append({
                "reason": "host callback in "
                          + ("map_rows" if n.rows else "map_blocks")
                          + f" stage producing {list(n.out_names)}",
                "upstream_maps": i,
                "downstream_maps": len(maps) - i - 1,
            })
    # a source frame produced by a barrier op, with fusable maps both
    # upstream (recorded on the source) and downstream (this chain)
    reason = getattr(source, "_fusion_barrier", None)
    if reason and getattr(source, "_fusion_barrier_upstream", False) and maps:
        barriers.append({
            "reason": reason,
            "upstream_maps": 1,
            "upstream_exact": False,
            "downstream_maps": len(maps),
        })
    # ragged source columns feeding a fusable run execute per stage;
    # only checkable without forcing when the source is materialized
    if len(maps) >= 2 and getattr(source, "is_materialized", False):
        try:
            from ..ops.executor import block_is_ragged

            src_names = set(source.schema.names)
            ragged_ins = sorted({
                i
                for n in maps
                for i in n.program.input_names
                if i in src_names and any(
                    block_is_ragged(b, [i]) for b in source.blocks()
                )
            })
            if ragged_ins:
                barriers.append({
                    "reason": "ragged regrouping: column(s) "
                              f"{ragged_ins} hold ragged cells",
                    "upstream_maps": 1,
                    "upstream_exact": False,
                    "downstream_maps": len(maps) - 1,
                })
        except Exception:  # pragma: no cover - inspection never raises
            pass
    return len(maps), barriers


def explain_plan(frame, analyze: bool = False) -> str:
    """Render a frame's logical plan, one node per line (source first).
    Frames without a plan render as a single ``source`` line. With
    ``analyze=True`` (EXPLAIN ANALYZE) the tree is followed by the
    per-stage profile the plan's last execution recorded into the stats
    sidecar — wall, rows, bytes, chosen strategy, lowering time — plus
    observed join selectivities, pushdown history and the barrier,
    unfused-epilogue and missed-pushdown evidence
    (``observability/profile.py``)."""
    node = getattr(frame, "_plan", None)
    if node is None:
        state = "materialized" if frame.is_materialized else "lazy"
        lines = [f"source ({state}, {len(frame.schema.names)} column(s))"]
    else:
        source, nodes = resolve_chain(node)
        lines = [
            "source ("
            + ("materialized" if source.is_materialized else "lazy")
            + f", columns={list(source.schema.names)})"
        ]
        for n in nodes:
            lines.append(f"  -> {n!r}")
    if analyze:
        from ..observability import profile as _profile

        lines.append("")
        lines.extend(_profile.profile_lines(frame))
    return "\n".join(lines)
