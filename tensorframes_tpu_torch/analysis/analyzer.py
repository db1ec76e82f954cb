"""The pre-execution static pass: capture once, run the rule catalog.

The reference package's ``analysis/analyzer.py``. ``lint_program(program)``
captures the program's function as an FX graph of aten ops
(:func:`~tensorframes_tpu_torch.program.capture_graph`: ``make_fx`` under
``FakeTensorMode``, probe rows for the Unknown dims) and hands it to
every rule in :mod:`.rules`. No data moves and no kernel runs: a lint
leaves the executor's dispatch keys and the kernels' launch counts where
they were.

Three surfaces share this pass:

* ``program.lint(...)`` / ``lint_program(program, ...)`` — the API;
* ``analyze_frame(frame, fetches, ...)`` — lints fetches *against a
  frame*, normalized as the verbs normalize them, with the frame's
  distinct block sizes when it is already materialized (a lazy frame is
  never forced);
* ``python -m tensorframes_tpu_torch.analysis`` — lints ``save_program``
  artifacts from disk (:mod:`.cli`).

``lint_plan(frame)`` reads the evidence the plan layer and the serving
engines record (barriers, unfused epilogues, missed pushdowns, forced
materializations, prefix-cache and registered-query events).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .diagnostics import DiagnosticReport
from .rules import RuleContext, run_rules

__all__ = ["lint_program", "analyze_frame", "lint_plan"]


def _capture(program, probe: int):
    """Capture ``program`` at probe inputs. Returns (graph, in_names,
    in_avals, out_names, out_avals); when the capture fails (the program
    raises under fake tensors) everything is empty and the spec-level
    rules still run."""
    from ..program import capture_graph

    try:
        graph = capture_graph(program, probe)
    except Exception:
        return None, (), (), (), ()
    return (
        graph,
        [n for n, _, _ in graph.inputs],
        [(s, d) for _, s, d in graph.inputs],
        [n for n, _, _ in graph.outputs],
        [(s, d) for _, s, d in graph.outputs],
    )


def lint_program(
    program,
    probe: int = 8,
    rules: Optional[Sequence[str]] = None,
    block_mode: Optional[bool] = None,
    block_row_counts: Optional[Tuple[int, ...]] = None,
    hbm_budget_bytes: Optional[int] = None,
    subject: str = "",
    mesh=None,
    shardings=None,
) -> DiagnosticReport:
    """Statically lint a :class:`~tensorframes_tpu_torch.program.Program`.

    ``rules`` selects diagnostic codes (default: all). ``probe``
    substitutes Unknown dims for the capture. ``hbm_budget_bytes``
    overrides the device budget for TFG106 (by default the GPU's total
    memory when the program runs on one; silent on the CPU). ``mesh``
    and ``shardings`` lint a program as its sharded dispatches key: the
    TFG108 stability probes fingerprint with the layout in the key.
    """
    graph, in_names, in_avals, out_names, out_avals = _capture(program, probe)
    ctx = RuleContext(
        program=program,
        probe=probe,
        graph=graph,
        in_names=in_names,
        in_avals=in_avals,
        out_names=out_names,
        out_avals=out_avals,
        block_mode=block_mode,
        block_row_counts=block_row_counts,
        hbm_budget_bytes=hbm_budget_bytes,
        mesh=mesh,
        shardings=shardings,
    )
    diags = run_rules(ctx, codes=rules)
    return DiagnosticReport(
        diags,
        subject=subject or f"Program(inputs={[s.name for s in program.inputs]})",
    )


def analyze_frame(
    frame,
    fetches,
    block: bool = True,
    feed_dict=None,
    reduce_mode: Optional[str] = None,
    rules: Optional[Sequence[str]] = None,
    probe: int = 8,
    hbm_budget_bytes: Optional[int] = None,
    device=None,
) -> DiagnosticReport:
    """Lint fetches *as a verb would run them* against ``frame``.

    The fetches normalize through the verbs' own path (DSL nodes, plain
    functions, Programs, ``feed_dict`` renames) for ``device`` (default
    ``config.device``: captured tensors live there), then lint with the
    frame's block sizes — only when the frame is already materialized:
    analysis never forces a lazy frame. A sharded frame lints with its
    mesh and the batch sharding of each device column it feeds, as its
    dispatches key.
    """
    from ..config import resolve_device
    from ..ops.verbs import _apply_feed_dict, _normalize_program

    program, _ = _normalize_program(
        fetches, frame.schema, block=block, device=resolve_device(device),
        reduce_mode=reduce_mode, feed_dict=feed_dict,
    )
    program = _apply_feed_dict(program, feed_dict)
    counts: Optional[Tuple[int, ...]] = None
    if frame.is_materialized:
        from ..frame import _block_num_rows

        counts = tuple(_block_num_rows(b) for b in frame.blocks())
    mesh = shardings = None
    if frame.is_sharded:
        from ..config import get_config
        from ..parallel.mesh import batch_sharding

        mesh = frame.mesh
        axis = getattr(frame, "_axis", None) or get_config().batch_axis
        shardings = {}
        for spec in program.inputs:
            if spec.name not in frame.schema.names or not frame.schema[spec.name].is_device:
                continue  # a feed_dict host array: fed placement-free
            shardings[spec.name] = batch_sharding(mesh, max(1, len(spec.shape.dims)), axis)
    return lint_program(
        program,
        probe=probe,
        rules=rules,
        block_mode=block,
        block_row_counts=counts,
        hbm_budget_bytes=hbm_budget_bytes,
        subject=f"fetches×frame({', '.join(frame.schema.names)})",
        mesh=mesh,
        shardings=shardings,
    )


def lint_plan(frame) -> DiagnosticReport:
    """Lint a frame's *logical plan*: TFG107 fusion-barrier, TFG109
    unfused-aggregate, TFG110 missed-aggregate-pushdown, TFG111
    larger-than-budget materialization, TFG112 liftable-callback /
    lift-declined, TFG113 prefix-cache-ineligible and TFG114
    query-not-incremental, from the evidence the plan layer, the lifter
    and the serving engines record. Each finding's ``explain()`` names
    the cause. Purely static over the recorded plan chain — never
    forces a lazy frame."""
    from ..plan.ir import chain_barriers, resolve_chain, unfused_epilogues
    from ..plan.lower import oversized_materializations, pushdown_misses

    n_maps, barriers = chain_barriers(frame)
    # verified-lift decisions (TFG112): each numpy UDF stage carries its
    # capture record — lifted (barrier cleared) or declined (reason +
    # offending AST node) — on the program plan/lift built
    lift_events = []
    node = getattr(frame, "_plan", None)
    if node is not None:
        _, nodes = resolve_chain(node)
        for n in nodes:
            info = getattr(getattr(n, "program", None),
                           "_tftpu_lift_info", None)
            if info:
                lift_events.append(dict(info))
    # serving evidence; import-guarded — linting must work where the
    # serving modules cannot load
    try:
        from ..serving.decode import prefix_cache_events

        prefix_events = prefix_cache_events()
    except Exception:  # pragma: no cover - serving unavailable
        prefix_events = []
    try:
        from ..serving.query import query_cache_events

        query_events = query_cache_events()
    except Exception:  # pragma: no cover - serving unavailable
        query_events = []
    ctx = RuleContext(
        program=None,
        plan_barriers=barriers,
        unfused_epilogues=unfused_epilogues(frame),
        pushdown_misses=pushdown_misses(frame),
        oversized_materializations=oversized_materializations(frame),
        lift_events=lift_events,
        prefix_cache_events=prefix_events,
        query_cache_events=query_events,
    )
    diags = run_rules(
        ctx,
        codes=["TFG107", "TFG109", "TFG110", "TFG111", "TFG112", "TFG113",
               "TFG114"],
    )
    return DiagnosticReport(
        diags, subject=f"plan({n_maps} map stage(s))"
    )
