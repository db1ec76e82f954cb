"""The five verbs: map_blocks, map_rows, reduce_blocks, reduce_rows,
aggregate.

Public surface parity with the reference
(``OperationsInterface``, Operations.scala:20-135; Python client
core.py:144-419), executed with PyTorch on one device — the GPU unless
the caller passes ``device="cpu"`` (or configures it):

* ``map_blocks`` — the program runs once per block on the device.
* ``map_rows`` — ``torch.func.vmap`` over the block's rows; ragged rows
  group by cell shape, and a single 1-D ragged column is staged on the
  device through the ragged-gather kernel.
* ``reduce_rows`` — a sequential pairwise fold per block, then across
  block partials (≙ performReducePairwise, DebugRowOps.scala:939-979).
* ``reduce_blocks`` — per-block program run, partials stacked and reduced
  once more (≙ performReduceBlock + Spark's pairwise RDD.reduce,
  DebugRowOps.scala:510-533).
* ``aggregate`` — keyed aggregation: algebraic reducer fetches through
  the segment-reduce kernels (the segment fast path), any other program
  through level-batched compaction (the generic UDAF route).

Programs may be DSL nodes or plain Python functions over torch tensors
(see program.py). With ``plan_fusion`` on (the default, ``TFTPU_FUSION``),
``map_blocks``/``map_rows`` on a host frame and ``aggregate`` on a
plan-carrying frame record plan nodes instead of running
(:mod:`..plan`), and ``reduce_blocks``/``reduce_rows`` fuse a recorded
chain into their epilogue; ``TFTPU_FUSION=0`` runs every verb eagerly,
stage by stage, with the same bits.

A sharded frame (``to_device``, ``parallel.frame_from_process_local``)
holds each rank's rows as tensors on the rank's device: its verbs run
eagerly on that device, maps leave their outputs there, and the reduces
and the keyed aggregate cross ranks through the process group
(``ops/device_agg.py``, :mod:`..parallel.collectives`).
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import dtypes as dt
from ..config import get_config, resolve_device
from ..dsl.node import Node, compile_fetches, segment_reduce_info
from ..frame import Block, GroupedData, TensorFrame, _block_num_rows, carry_layout
from ..program import Program, TensorSpec, analyze_program, program_from_function
from ..schema import ColumnInfo, Schema
from ..shape import Shape, Unknown
from ..utils import get_logger
from ..utils import profiling
from ..validation import (
    ValidationError,
    validate_map,
    validate_reduce_blocks,
    validate_reduce_rows,
)
from .executor import (
    block_is_ragged,
    bucket_rows,
    gather_feeds,
    make_pair_fold,
    Readback,
    pad_lead_dim,
)

logger = get_logger(__name__)

Fetches = Union[Node, Sequence[Node], Program, Callable, "NumpyUDF"]


def _plan_map_result(
    frame, program: Program, schema: Schema, rows: bool, device
) -> Optional["TensorFrame"]:
    """Record this map stage on the frame's logical plan instead of
    nesting another compute thunk (:mod:`..plan`): at force time the
    whole chain lowers to one composed program per block. Returns None
    when planning is off (``TFTPU_FUSION=0``) or re-entrant (the lowering
    pass executes through these same verbs)."""
    from ..plan import ir as plan_ir

    if not plan_ir.fusion_enabled():
        return None
    node = plan_ir.PlanNode(
        "map",
        parent=plan_ir.node_for_parent(frame, device),
        program=program,
        rows=rows,
        out_names=[o.name for o in program.outputs],
        schema=schema,
        device=device,
    )

    def pending():
        from ..plan.lower import execute_plan

        return execute_plan(node)

    result = TensorFrame(None, schema, pending=pending)
    node.bind(result)
    result._plan = node
    result._produced_by_map = True
    return result


def _verb_device(frame, device) -> torch.device:
    """The device a verb runs on: the explicit ``device``, else a sharded
    frame's rank device, else ``config.device``."""
    if device is None and getattr(frame, "is_sharded", False):
        from ..parallel.distributed import rank_device

        device = rank_device()
    return resolve_device(device)


class _OnDevice:
    """Outputs that stay where they were computed (a sharded frame's main
    block): ``wait()`` returns them as they are."""

    def __init__(self, outs):
        self.outs = outs

    def wait(self):
        return self.outs


def _on(v, device) -> torch.Tensor:
    """A block column as a tensor on ``device`` (host arrays copied up,
    tensors moved only when elsewhere)."""
    if torch.is_tensor(v):
        return v if v.device == device else v.to(device)
    return dt.to_torch(v, device)


def _host_row(v):
    """Row 0 of a column as a host array."""
    return dt.to_numpy(v[0]) if torch.is_tensor(v) else np.asarray(v[0])


def _is_pandas(obj) -> bool:
    """True for a pandas DataFrame; pandas is imported only when the
    caller has loaded it, so the package runs where it is not installed."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(obj, pd.DataFrame)


def _map_pandas(fetches, pdf, feed_dict, device, strict: bool = False):
    """Local pandas path (≙ ``_map_pd``, core.py:171-183): run the program
    on the pandas columns (block semantics, whole columns, as the
    reference's ``_map_pd`` feeds them) and append the outputs to a copy
    of the frame. ``strict`` rides through to the converted frame's
    ``map_blocks``, as in the reference."""
    from ..frame import frame_from_pandas

    result = map_blocks(fetches, frame_from_pandas(pdf, num_blocks=1),
                        feed_dict=feed_dict, strict=strict, device=device)
    out = pdf.copy()
    for name in result.schema.names:
        if name not in pdf.columns:
            out[name] = list(result.column_values(name))
    return out


def _input_specs_from_schema(schema: Schema, block: bool) -> Dict[str, TensorSpec]:
    specs = {}
    for c in schema.device_columns:
        shape = c.block_shape if block else c.cell_shape
        specs[c.name] = TensorSpec(c.name, c.dtype, shape)
    return specs


class NumpyUDF:
    """A numpy UDF captured for verified lifting (``numpy_udf``).

    The wrapped function receives one *numpy* array per parameter
    (parameter name = column name, block-level) and returns arrays /
    a dict / a tuple of arrays. Capture goes one of two ways, decided for
    the device the verb runs on:

    * the static lifter (analysis/lifting + plan/lift) synthesizes an
      equivalent torch Program and verifies it bit-exactly on a
      boundary-value corpus and seeded random blocks, on that device —
      the lifted stage fuses like any other (no TFG107 barrier), or
    * anything that does not verify runs as a host stage — exactly what
      the user wrote, once per block, with the decline reason counted
      and surfaced via TFG112 / ``--lift-report``.

    Results are bit-identical either way (both write NaN as one
    canonical NaN); the lift exists purely for speed. Block-level only:
    ``map_rows`` raises. Capture warns (TFG112) when the UDF closes over
    mutable state — the host stage re-reads such state per block, so
    later mutations silently rebind its behavior (stale-closure hazard).
    """

    def __init__(self, fn: Callable):
        if not callable(fn) or isinstance(fn, (Node, Program)):
            raise TypeError(
                "numpy_udf wraps a plain Python function over numpy "
                f"arrays; got {type(fn).__name__}")
        self.fn = fn
        self._programs: Dict[tuple, Program] = {}
        self._prog_lock = threading.Lock()
        self._warn_mutable_closures()

    def _warn_mutable_closures(self) -> None:
        from ..analysis.lifting import detect_mutable_closures

        names = detect_mutable_closures(self.fn)
        if not names:
            return
        from ..analysis.diagnostics import Diagnostic, DiagnosticReport

        udf = getattr(self.fn, "__name__", "<udf>")
        DiagnosticReport([
            Diagnostic(
                code="TFG112",
                severity="warn",
                message=(
                    f"numpy_udf {udf!r} closes over mutable state "
                    f"({', '.join(sorted(names))}): the callback re-reads "
                    "it on every block, so mutating it after capture "
                    "silently rebinds the UDF's behavior (stale-closure "
                    "hazard); lifting declines it"
                ),
                subject=udf,
                fix=(
                    "snapshot the captured value into an immutable "
                    "scalar, pass it as a column, or freeze it "
                    "(tuple / float) before capture"
                ),
            )
        ])

    def _materialize(
        self,
        schema: Schema,
        block: bool,
        reduce_mode: Optional[str],
        feed_dict: Optional[Dict[str, str]],
        device,
    ) -> Program:
        if not block:
            raise ValidationError(
                "numpy_udf programs are block-level (the host callback "
                "runs once per block, and lifting targets block "
                "expressions); use map_blocks / aggregate, not map_rows"
            )
        specs = _input_specs_from_schema(schema, block)
        for ph, col in (feed_dict or {}).items():
            if col in specs and ph not in specs:
                specs[ph] = TensorSpec(ph, specs[col].dtype, specs[col].shape)
        if reduce_mode == "blocks":
            for c in schema.device_columns:
                specs[f"{c.name}_input"] = TensorSpec(
                    f"{c.name}_input", c.dtype, c.block_shape
                )
        # cache the analyzed Program per capture context so steady-state
        # calls reuse one object; the device is part of the context, as a
        # stage verified on one device proves nothing on another
        key = (
            tuple(sorted(
                (n, str(s.dtype), tuple(repr(d) for d in s.shape.dims))
                for n, s in specs.items()
            )),
            reduce_mode,
            bool(get_config().udf_lifting),
            str(device),
        )
        with self._prog_lock:
            cached = self._programs.get(key)
        if cached is not None:
            return cached
        from ..plan import lift as plan_lift

        program = plan_lift.build_udf_program(self.fn, specs, device=device)
        with self._prog_lock:
            self._programs.setdefault(key, program)
            return self._programs[key]


def numpy_udf(fn: Callable) -> NumpyUDF:
    """Capture a numpy host function for verified lifting — see
    :class:`NumpyUDF`. Usable anywhere block-level fetches are:
    ``map_blocks(numpy_udf(f), frame)``, ``aggregate``,
    ``reduce_blocks``."""
    return NumpyUDF(fn)


def _normalize_program(
    fetches: Fetches,
    schema: Schema,
    block: bool,
    device,
    reduce_mode: Optional[str] = None,
    feed_dict: Optional[Dict[str, str]] = None,
    shape_hints: Optional[Dict[str, object]] = None,
) -> Tuple[Program, Optional[List[Tuple[str, str, str]]]]:
    """Accept DSL nodes / a python function / a Program; return an analyzed
    Program plus (for DSL reducer fetches) segment-lowering info.

    ``reduce_mode`` ('rows' | 'blocks') extends the input-spec namespace for
    plain-function fetches so parameters may follow the reduce naming
    contracts (``x_1``/``x_2``, ``x_input``) in addition to column names.
    ``feed_dict`` (placeholder → column) extends it with the renamed
    placeholders (core.py:128-142).
    """
    seg_info = None
    if isinstance(fetches, Program):
        # already-analyzed Programs pass through untouched (their dispatch
        # bookkeeping survives across verb calls); seg_info recorded at
        # compile time keeps the aggregate fast path.
        if fetches.outputs:
            return fetches, getattr(fetches, "seg_info", None)
        program = fetches
    elif isinstance(fetches, Node) or (
        isinstance(fetches, (list, tuple))
        and fetches
        and all(isinstance(f, Node) for f in fetches)
    ):
        nodes = [fetches] if isinstance(fetches, Node) else list(fetches)
        program = compile_fetches(nodes)
        seg_info = segment_reduce_info(nodes)
    elif isinstance(fetches, NumpyUDF):
        # capture -> lifted-or-host-stage Program, fully analyzed and
        # cached on the UDF per device (like the Program passthrough
        # above, its dispatch bookkeeping survives across verb calls)
        program = fetches._materialize(schema, block, reduce_mode, feed_dict,
                                       device)
        return program, getattr(program, "seg_info", None)
    elif callable(fetches):
        specs = _input_specs_from_schema(schema, block)
        for ph, col in (feed_dict or {}).items():
            if col in specs and ph not in specs:
                specs[ph] = TensorSpec(ph, specs[col].dtype, specs[col].shape)
        if reduce_mode == "rows":
            for c in schema.device_columns:
                specs[f"{c.name}_1"] = TensorSpec(f"{c.name}_1", c.dtype, c.cell_shape)
                specs[f"{c.name}_2"] = TensorSpec(f"{c.name}_2", c.dtype, c.cell_shape)
        elif reduce_mode == "blocks":
            for c in schema.device_columns:
                specs[f"{c.name}_input"] = TensorSpec(
                    f"{c.name}_input", c.dtype, c.block_shape
                )
        program = program_from_function(fetches, specs)
    else:
        raise TypeError(
            "fetches must be a DSL Node, a list of Nodes, a Program, or a "
            f"callable; got {type(fetches).__name__}"
        )
    hints = (
        {k: Shape.from_any(v) for k, v in shape_hints.items()}
        if shape_hints
        else None
    )
    program = analyze_program(program, hints=hints, device=device)
    program.seg_info = seg_info  # survives Program reuse via compile_program
    return program, seg_info


def _apply_feed_dict(program: Program, feed_dict: Optional[Dict[str, str]]) -> Program:
    """feed_dict: placeholder name → column name (≙ core.py:128-142).
    Placeholders not mentioned keep their own name as the column name."""
    if not feed_dict:
        return program
    unknown = [k for k in feed_dict if k not in program.input_names]
    if unknown:
        raise ValidationError(
            f"feed_dict key(s) {unknown} do not match any program input; "
            f"inputs: {program.input_names}"
        )
    return program.rename_inputs(dict(feed_dict))


def _strict_lint(program: Program, frame, block_mode: Optional[bool]) -> None:
    """The verbs' ``strict=True`` hook: run the static analyzer
    (:mod:`tensorframes_tpu_torch.analysis`) on the normalized program and
    raise :class:`~tensorframes_tpu_torch.validation.StaticAnalysisError`
    on any error-severity diagnostic — before any block is staged or
    dispatched. Block shapes feed the recompile-storm rule only when the
    frame is already materialized (lint never forces a pending
    computation)."""
    from ..analysis import lint_program

    counts = None
    if getattr(frame, "is_materialized", False):
        counts = tuple(_block_num_rows(b) for b in frame.blocks())
    lint_program(
        program, block_mode=block_mode, block_row_counts=counts,
    ).raise_on_errors()


def _sorted_output_infos(program: Program, block_mode: bool) -> List[ColumnInfo]:
    """Output columns first, sorted by name (≙ DebugRowOps.scala:353-379)."""
    infos = []
    for o in sorted(program.outputs, key=lambda s: s.name):
        if block_mode:
            block_shape = o.shape if o.shape.rank > 0 else Shape((Unknown,))
            block_shape = block_shape.with_leading_unknown()
        else:
            block_shape = o.shape.prepend(Unknown)
        infos.append(ColumnInfo(o.name, o.dtype, block_shape))
    return infos


def compile_program(
    fetches: Fetches,
    frame,
    block: bool = True,
    reduce_mode: Optional[str] = None,
    feed_dict: Optional[Dict[str, str]] = None,
    shape_hints: Optional[Dict[str, object]] = None,
    device=None,
) -> Program:
    """Pre-compile fetches against a frame's schema into a reusable Program.

    ``shape_hints`` ({output name → shape}) override discovered output
    shapes wherever the hint dim is known — the per-call shape side
    channel (≙ ShapeDescription + the hint-override rule,
    TensorFlowOps.scala:126-133).
    """
    program, _ = _normalize_program(
        fetches,
        frame.schema,
        block=block,
        device=resolve_device(device),
        reduce_mode=reduce_mode,
        shape_hints=shape_hints,
    )
    return _apply_feed_dict(program, feed_dict)


# ---------------------------------------------------------------------------
# map_blocks
# ---------------------------------------------------------------------------

def map_blocks(
    fetches: Fetches,
    frame,
    feed_dict: Optional[Dict[str, str]] = None,
    trim: bool = False,
    strict: bool = False,
    device=None,
) -> "TensorFrame":
    """Transform a frame block by block, appending one column per output
    (or replacing all columns when ``trim=True``, in which case the output
    row count may differ from the input's).

    ≙ ``tfs.map_blocks`` (core.py:267-313) → DebugRowOps.mapBlocks
    (DebugRowOps.scala:305-400); trimmed variant ≙ mapBlocksTrimmed.
    Lazy: returns a frame with a pending computation (core.py:278-279).
    A pandas DataFrame in ``frame`` is mapped eagerly and returned as a
    pandas DataFrame with the outputs appended.

    Blocks pipeline: a worker thread stages up to ``map_prefetch_depth``
    blocks' feeds on the device ahead of the one computing, and up to
    ``map_pipeline_depth`` blocks stay in flight before the oldest one's
    outputs are read back (config.py). ``strict=True`` additionally runs
    the static analyzer and raises on error-severity diagnostics before
    any dispatch.
    """
    if _is_pandas(frame):
        return _map_pandas(fetches, frame, feed_dict, device, strict=strict)
    dev = _verb_device(frame, device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=True, device=dev, feed_dict=feed_dict
    )
    program = _apply_feed_dict(program, feed_dict)
    validate_map(program, frame.schema, block=True, trim=trim)
    if strict:
        _strict_lint(program, frame, block_mode=True)
    out_infos = _sorted_output_infos(program, block_mode=True)
    schema = Schema(out_infos if trim else out_infos + frame.schema.columns)
    sharded = frame.is_sharded
    if not trim and not sharded:
        planned = _plan_map_result(frame, program, schema, False, dev)
        if planned is not None:
            return planned
    compiled = program.compiled()
    parent = frame
    input_names = program.input_names

    def compute() -> List[Block]:
        out_blocks: List[Block] = []
        t0 = time.perf_counter()
        n_total = 0
        # pipelined execution: up to `depth` blocks stay in flight, so
        # block k+1's copy in and compute overlap block k's copy out; the
        # host waits on a block's own readback event, never on the device
        cfg = get_config()
        # a sharded frame's main block keeps its outputs on the device:
        # nothing to read back, no window
        depth = 0 if sharded else max(0, cfg.map_pipeline_depth)
        in_flight: deque = deque()

        def finish(b: Block, n: int, pending) -> None:
            outs = pending.wait()
            if trim:
                out_blocks.append({i.name: outs[i.name] for i in out_infos})
                return
            for o in program.outputs:
                got = outs[o.name].shape[0] if outs[o.name].ndim > 0 else None
                if got != n:
                    raise ValidationError(
                        f"map_blocks output {o.name!r} produced {got} rows "
                        f"for a block of {n} rows. Appending requires "
                        "matching row counts; use trim=True for "
                        "row-count-changing programs."
                    )
            nb: Block = {i.name: outs[i.name] for i in out_infos}
            nb.update(b)
            out_blocks.append(nb)

        blocks = parent.blocks()
        # a worker thread stages upcoming blocks' feeds on the device
        # (pinned memory, a side stream) while this one computes
        feeds_seq = (gather_feeds(b, input_names, program) for b in blocks)
        prefetch = 0 if sharded else max(0, cfg.map_prefetch_depth)
        if prefetch > 0 and len(blocks) > 1:
            from .. import io as _io

            feeds_seq = _io.prefetch_to_device(feeds_seq, size=prefetch, device=dev)
        try:
            for bi, (b, feeds) in enumerate(zip(blocks, feeds_seq)):
                n = _block_num_rows(b)
                n_total += n
                outs = compiled.run_block(feeds, dev, to_numpy=False)
                del feeds
                in_flight.append((b, n, _OnDevice(outs) if sharded and bi == 0
                                  else Readback(outs)))
                if len(in_flight) > depth:
                    finish(*in_flight.popleft())
            while in_flight:
                finish(*in_flight.popleft())
        finally:
            close = getattr(feeds_seq, "close", None)
            if close is not None:
                close()  # stops the prefetch worker on an early exit
        profiling.record("map_blocks.dispatch" if sharded else "map_blocks",
                         time.perf_counter() - t0, n_total)
        return out_blocks

    result = TensorFrame(None, schema, pending=compute)
    result._produced_by_map = True
    carry_layout(frame, result)
    if trim:
        # a row-count-changing map is a fusion barrier: downstream
        # chains re-root here
        from ..plan import ir as plan_ir

        plan_ir.mark_barrier(
            result, "trim map_blocks (row-count-changing output)", frame
        )
    return result


# ---------------------------------------------------------------------------
# map_rows
# ---------------------------------------------------------------------------

def _stack_group(col, idx) -> np.ndarray:
    """Stack the cells ``col[i] for i in idx`` (one shape by grouping)
    into ``[len(idx), *cell]``: one native memcpy pass
    (``native.stack_cells``), ``np.stack`` where the pass does not take
    the cells (disabled, a non-contiguous or object cell, mixed dtypes,
    which ``np.stack`` promotes)."""
    from .. import native

    cells = [col[i] for i in idx]
    try:
        stacked = native.stack_cells(cells)
    except (ValueError, TypeError, BufferError):
        stacked = None
    if stacked is not None:
        return stacked
    return np.stack([np.asarray(c) for c in cells])


def _group_rows_by_shape(
    b: Dict[str, object], input_names: Sequence[str], n: int
) -> List[np.ndarray]:
    """Row indices grouped by input cell shape — the ragged dispatch
    unit. The common case (ONE 1-D ragged column) grouped vectorized;
    multi-input / higher-rank cells keep the general tuple-key path."""
    if n == 0:
        return []
    if len(input_names) == 1:
        col = b[input_names[0]]
        cells = col if isinstance(col, list) else list(col)
        if cells and all(
            isinstance(c, np.ndarray) and c.ndim == 1 for c in cells
        ):
            lens = np.fromiter(
                (c.shape[0] for c in cells), np.int64, count=n
            )
            uniq, inv = np.unique(lens, return_inverse=True)
            order = np.argsort(inv, kind="stable")
            bounds = np.searchsorted(inv[order], np.arange(1, len(uniq)))
            return [g for g in np.split(order, bounds)]
    groups: Dict[tuple, List[int]] = {}
    for i in range(n):
        key = tuple(np.shape(b[name][i]) for name in input_names)
        groups.setdefault(key, []).append(i)
    return [np.asarray(v) for v in groups.values()]


# ragged staging byte cap (≙ the reference's): consecutive shape groups
# whose bucket-padded feeds fit it make one wave, staged at once and
# dispatched before the next wave stages, so peak device memory is one
# wave's inputs plus the window of outputs in flight
_RAGGED_STAGE_BYTES = 1 << 28  # 256 MB


def _ragged_gather_plan(cols, input_names, n, device, n_groups):
    """Device-side ragged staging: a single 1-D ragged column's cells move
    ONCE as a flat buffer, and the shape groups' bucket-padded batches are
    gathered on the device by the ragged-gather kernel
    (``kernels/ragged_gather.py``), every group of a wave in one launch
    (one per ``LAUNCH_BUDGET_BYTES`` of padded output). Returns a
    ``gather(groups) -> iterator of feeds`` closure, one feeds dict per
    group in order, or None when the column is not that shape (then
    groups stage on the host). On a CUDA device the choice is the cost
    model's counted decision (``plan/rules.decide_ragged_gather``); on
    the CPU the gather computes its plain version."""
    if len(input_names) != 1:
        return None
    name = input_names[0]
    cells = cols[name]
    if not cells or not all(
        isinstance(c, np.ndarray) and c.ndim == 1 and c.shape[0] > 0
        for c in cells
    ):
        return None
    if len({c.dtype for c in cells}) != 1:
        return None
    decision = None
    if device.type == "cuda":
        from ..plan import rules as _prules

        decision = _prules.decide_ragged_gather(n, n_groups, cells[0].dtype, device=device)
        if decision is None:
            return None
    from ..kernels import ragged_gather as _krg

    lens = np.fromiter((c.shape[0] for c in cells), np.int64, count=n)
    if int(lens.sum()) > np.iinfo(np.int32).max:
        # start offsets are int32; a flat buffer past 2^31 elements would
        # wrap them — host staging handles it
        return None
    if decision is not None:
        from ..plan.lower import _note_decision

        _note_decision(decision)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat_dev = dt.to_torch(np.concatenate(cells), device)

    def gather(group_list):
        groups = []
        for idx in group_list:
            st = np.zeros(bucket_rows(len(idx)), np.int32)  # padding rows re-read offset 0;
            st[:len(idx)] = starts[np.asarray(idx)]         # their outputs are sliced off
            groups.append((st, int(lens[int(idx[0])])))
        # every launch's table and starts go up in one copy; a launch's
        # batches are handed out (and dropped here) before the next launch
        # allocates its own, so one launch's output is alive at a time
        for launch in _krg.plan_launches(flat_dev, groups):
            batches = _krg.gather_launch(flat_dev, launch)
            while batches:
                yield {name: batches.pop(0)}

    return gather


def _ragged_waves(cols, input_names, group_list) -> List[List[np.ndarray]]:
    """Consecutive groups whose staged bytes (bucket-padded rows × cell
    bytes, computed without staging) fit ``_RAGGED_STAGE_BYTES``; a group
    past the cap makes a wave of its own."""
    waves: List[List[np.ndarray]] = [[]]
    wave_bytes = 0
    for idx in group_list:
        rows = bucket_rows(len(idx))
        bts = sum(rows * np.asarray(cols[name][int(idx[0])]).nbytes
                  for name in input_names)
        if waves[-1] and wave_bytes + bts > _RAGGED_STAGE_BYTES:
            waves.append([])
            wave_bytes = 0
        waves[-1].append(idx)
        wave_bytes += bts
    return waves


def _ragged_rows_outs(
    cols: Dict[str, list],
    input_names: Sequence[str],
    n: int,
    program: Program,
    compiled,
    device,
) -> Dict[str, object]:
    """Run a row-wise program over ``n`` ragged rows (``cols`` maps each
    input to its per-row cells): group rows by input cell shape, stage the
    groups' bucket-padded feeds wave by wave (on the device through the
    gather kernel where it applies, else stacked on the host), dispatch
    every group of a wave with up to ``map_pipeline_depth`` groups'
    outputs on their way back, and scatter the results to row order.
    Returns one value per output: a dense ``[n, *cell]`` array (uniform
    cell shapes) or a per-row cell list (ragged outputs)."""
    if n == 0:
        out0: Dict[str, object] = {}
        for o in program.outputs:
            dims = tuple(0 if d == Unknown else d for d in o.shape.dims)
            out0[o.name] = np.empty((0,) + dims, dtype=o.dtype.np_dtype)
        return out0
    group_list = [g for g in _group_rows_by_shape(cols, input_names, n)
                  if len(g)]
    gather = _ragged_gather_plan(cols, input_names, n, device, len(group_list))
    window = max(0, get_config().map_pipeline_depth)

    def group_feeds(idx):
        g = len(idx)
        feeds = {name: _stack_group(cols[name], idx) for name in input_names}
        return pad_lead_dim(feeds, g, bucket_rows(g))

    def host_wave(wave):
        # the wave's feeds all go up before its first dispatch
        staged = [{k: dt.to_torch(v, device) for k, v in group_feeds(idx).items()}
                  for idx in wave]
        while staged:
            yield staged.pop(0)

    outs_list: List[Dict[str, np.ndarray]] = []
    in_flight: deque = deque()
    for wave in _ragged_waves(cols, input_names, group_list):
        for feeds in (gather(wave) if gather is not None else host_wave(wave)):
            in_flight.append(Readback(
                compiled.run_rows(feeds, device, to_numpy=False)))
            del feeds  # its batch views a gather launch's buffer: free it first
            if len(in_flight) > window:
                outs_list.append(in_flight.popleft().wait())
    while in_flight:
        outs_list.append(in_flight.popleft().wait())
    # scatter: a uniform output column writes whole groups via index
    # assignment; ragged outputs (cell shapes differ across groups) keep
    # the per-row list form.
    outs: Dict[str, object] = {}
    for o in program.outputs:
        cell_shapes = {outs_g[o.name].shape[1:] for outs_g in outs_list}
        if len(cell_shapes) == 1:
            first = outs_list[0][o.name]
            dest = np.empty((n,) + first.shape[1:], dtype=first.dtype)
            for idx, outs_g in zip(group_list, outs_list):
                dest[np.asarray(idx)] = outs_g[o.name][: len(idx)]
            outs[o.name] = dest
        else:
            cells: List = [None] * n
            for idx, outs_g in zip(group_list, outs_list):
                og = outs_g[o.name]
                for j, i in enumerate(idx):
                    cells[i] = og[j]
            outs[o.name] = cells  # ragged output column
    return outs


def map_rows(
    fetches: Fetches,
    frame,
    feed_dict: Optional[Dict[str, str]] = None,
    strict: bool = False,
    device=None,
) -> "TensorFrame":
    """Transform a frame row by row (placeholders are cell-shaped).

    ≙ ``tfs.map_rows`` (core.py:224-265) → DebugRowOps.mapRows
    (DebugRowOps.scala:403-484). Uniform blocks run as one vmapped
    program; ragged blocks group rows by cell shape. A pandas DataFrame
    takes the reference's pandas path (whole columns, as ``map_blocks``).
    """
    if _is_pandas(frame):
        return _map_pandas(fetches, frame, feed_dict, device, strict=strict)
    dev = _verb_device(frame, device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=False, device=dev, feed_dict=feed_dict
    )
    program = _apply_feed_dict(program, feed_dict)
    validate_map(program, frame.schema, block=False)
    if strict:
        _strict_lint(program, frame, block_mode=False)
    out_infos = _sorted_output_infos(program, block_mode=False)
    schema = Schema(out_infos + frame.schema.columns)
    sharded = frame.is_sharded
    if not sharded:
        planned = _plan_map_result(frame, program, schema, True, dev)
        if planned is not None:
            return planned
    compiled = program.compiled()
    parent = frame
    input_names = program.input_names

    def compute() -> List[Block]:
        t0 = time.perf_counter()
        blocks = parent.blocks()
        results: List[Optional[Block]] = [None] * len(blocks)
        ragged_entries: List[Tuple[int, Block, int]] = []
        n_total = 0
        for bi, b in enumerate(blocks):
            n = _block_num_rows(b)
            n_total += n
            if n == 0:
                nb: Block = {}
                for i in out_infos:
                    # preserve the cell rank so cross-block concatenation
                    # works; Unknown inner dims degrade to 0
                    dims = tuple(
                        0 if d == Unknown else d for d in i.cell_shape.dims
                    )
                    nb[i.name] = np.empty((0,) + dims, dtype=i.dtype.np_dtype)
                nb.update(b)
                results[bi] = nb
                continue
            if block_is_ragged(b, input_names):
                ragged_entries.append((bi, b, n))
                continue
            feeds = gather_feeds(b, input_names, program)
            if sharded and bi == 0:
                # a sharded frame's main block: one stable size, outputs
                # stay on the device
                outs = compiled.run_rows(feeds, dev, to_numpy=False)
                nb = {i.name: outs[i.name] for i in out_infos}
                nb.update(b)
                results[bi] = nb
                continue
            # adaptive lead-dim bucketing: the partitioner yields at most
            # two block sizes, so the first few distinct shapes run exactly
            # (zero padded work); once the dispatch cache shows shape
            # proliferation (>= 3 distinct sizes), pad to power-of-two
            # buckets
            target = n
            if compiled.cache_sizes()["vmap"] >= 3:
                target = bucket_rows(n)
            feeds = pad_lead_dim(feeds, n, target)
            outs = compiled.run_rows(feeds, dev)
            nb = {i.name: outs[i.name][:n] for i in out_infos}
            nb.update(b)
            results[bi] = nb
        if ragged_entries:
            # GLOBAL ragged pass: group rows by input cell shape across
            # every ragged block at once — #dispatches is the number of
            # DISTINCT shapes, not shapes x blocks
            merged: Dict[str, list] = {name: [] for name in input_names}
            for _, b, _ in ragged_entries:
                for name in input_names:
                    col = b[name]
                    merged[name].extend(
                        col if isinstance(col, list) else list(col)
                    )
            big_n = sum(nr for _, _, nr in ragged_entries)
            outs_global = _ragged_rows_outs(
                merged, input_names, big_n, program, compiled, dev
            )
            off = 0
            for bi, b, nr in ragged_entries:
                nb = {
                    i.name: outs_global[i.name][off:off + nr]
                    for i in out_infos
                }
                nb.update(b)
                results[bi] = nb
                off += nr
        profiling.record("map_rows.dispatch" if sharded else "map_rows",
                         time.perf_counter() - t0, n_total)
        return results

    result = TensorFrame(None, schema, pending=compute)
    result._produced_by_map = True
    carry_layout(frame, result)
    return result


# ---------------------------------------------------------------------------
# reduce_rows
# ---------------------------------------------------------------------------

def _rank_partials(local: Optional[Dict[str, np.ndarray]]) -> List[Dict[str, np.ndarray]]:
    """Every rank's partial of a sharded frame's main block, in rank
    order (one allgather of the pickled partials; a rank with no rows
    contributes none). Alone, this rank's."""
    import pickle

    from ..parallel.collectives import allgather_bytes

    got = [pickle.loads(b) for b in allgather_bytes(pickle.dumps(local))]
    return [p for p in got if p is not None]


def _unpack_results(program: Program, finals: Dict[str, np.ndarray]):
    """Return numpy results in fetch order; single fetch unwraps
    (≙ _unpack_row, core.py:111-125)."""
    out = []
    for name in program.fetch_order or program.output_names:
        arr = np.asarray(finals[name])
        out.append(arr if arr.ndim > 0 else arr.item())
    return out[0] if len(out) == 1 else out


def reduce_rows(
    fetches: Fetches, frame, strict: bool = False, device=None
) -> Union[np.ndarray, list]:
    """Pairwise-reduce all rows to a single row. Each fetch ``x`` consumes
    placeholders ``x_1``/``x_2`` (Operations.scala:83-96). Eager
    (core.py:197 "not lazy").

    Execution: within each block, a sequential fold on the device; block
    partials are folded the same way. Reduction order is unspecified by
    contract (core.py:186-187); this fold takes the reference's order. On
    a sharded frame each rank folds its own rows on its device, the ranks'
    partials are allgathered in rank order and folded, then the host tail.
    """
    dev = _verb_device(frame, device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=False, device=dev, reduce_mode="rows"
    )
    validate_reduce_rows(program, frame.schema)
    if strict:
        _strict_lint(program, frame, block_mode=False)
    out_names = [o.name for o in program.outputs]
    fold = make_pair_fold(program, out_names)
    t0 = time.perf_counter()
    # whole-pipeline route: a lazy plan-carrying frame fuses its map
    # chain WITH the pairwise-fold epilogue (plan/lower.lower_reduce) —
    # the mapped columns never come back to the host; the per-block
    # partials then combine exactly as always
    from ..plan.lower import lower_reduce

    planned = None if frame.is_sharded else lower_reduce(frame, program, out_names, "rows", dev)
    partials: List[Dict[str, np.ndarray]] = (
        list(planned[0]) if planned is not None else []
    )

    def block_partial(b):
        n = _block_num_rows(b)
        if n == 0:
            return None
        feeds = {}
        for x in out_names:
            v = b[x]
            if isinstance(v, list):
                spec = program.input(f"{x}_1")
                try:
                    v = np.asarray(v, dtype=spec.dtype.np_dtype)
                except (ValueError, TypeError):
                    raise ValueError(
                        f"Column {x!r} holds ragged cells; reduce_rows "
                        "needs dense blocks (run analyze() first)."
                    ) from None
            feeds[x] = v
        if n == 1:
            return {x: _host_row(feeds[x]) for x in out_names}
        res = fold({x: _on(feeds[x], dev) for x in out_names})
        return {x: dt.to_numpy(res[x]) for x in out_names}

    blocks = [] if planned is not None else frame.blocks()
    if frame.is_sharded and blocks:
        partials.extend(_rank_partials(block_partial(blocks[0])))
        blocks = blocks[1:]  # the host tail folds in below
    for b in blocks:
        p = block_partial(b)
        if p is not None:
            partials.append(p)
    if not partials:
        raise ValueError("reduce_rows on an empty frame")
    if len(partials) == 1:
        finals = partials[0]
    else:
        res = fold({
            x: dt.to_torch(np.stack([p[x] for p in partials]), dev)
            for x in out_names
        })
        finals = {x: dt.to_numpy(res[x]) for x in out_names}
    n_rows = planned[1] if planned is not None else frame.num_rows
    profiling.record("reduce_rows", time.perf_counter() - t0, n_rows)
    return _unpack_results(program, finals)


# ---------------------------------------------------------------------------
# reduce_blocks
# ---------------------------------------------------------------------------

def reduce_blocks(
    fetches: Fetches, frame, strict: bool = False, device=None
) -> Union[np.ndarray, list]:
    """Block-reduce all rows to a single row. Each fetch ``x`` consumes a
    placeholder ``x_input`` with one extra (Unknown) leading dim
    (Operations.scala:98-108). Eager.

    Execution ≙ performReduceBlock per partition + pairwise merge
    (DebugRowOps.scala:510-533), except partials are stacked and reduced in
    one final program run instead of pairwise merging coordinated by Spark.
    On a sharded frame each rank runs the program on its own rows on its
    device; the ranks' partials (allgathered in rank order) and the host
    tail's stack into the final run.
    """
    dev = _verb_device(frame, device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=True, device=dev, reduce_mode="blocks"
    )
    validate_reduce_blocks(program, frame.schema)
    if strict:
        _strict_lint(program, frame, block_mode=True)
    out_names = [o.name for o in program.outputs]
    compiled = program.compiled()
    t0 = time.perf_counter()
    # whole-pipeline route: fuse the recorded map chain with the reduce
    # program into one dispatch per block (plan/lower.lower_reduce) —
    # the mapped columns never come back to the host; partials combine
    # as always
    from ..plan.lower import lower_reduce

    planned = None if frame.is_sharded else lower_reduce(frame, program, out_names, "blocks", dev)
    partials: List[Dict[str, np.ndarray]] = (
        list(planned[0]) if planned is not None else []
    )

    def block_partial(b):
        if _block_num_rows(b) == 0:
            return None
        feeds = {}
        for x in out_names:
            v = b[x]
            if isinstance(v, list):
                spec = program.input(f"{x}_input")
                try:
                    v = np.asarray(v, dtype=spec.dtype.np_dtype)
                except (ValueError, TypeError):
                    raise ValueError(
                        f"Column {x!r} holds ragged cells; reduce_blocks "
                        "needs dense blocks (run analyze() first)."
                    ) from None
            feeds[f"{x}_input"] = v
        return compiled.run_block(feeds, dev)

    blocks = [] if planned is not None else frame.blocks()
    if frame.is_sharded and blocks:
        partials.extend(_rank_partials(block_partial(blocks[0])))
        blocks = blocks[1:]  # the host tail's partial follows the ranks'
    for b in blocks:
        p = block_partial(b)
        if p is not None:
            partials.append(p)
    if not partials:
        raise ValueError("reduce_blocks on an empty frame")
    if len(partials) == 1:
        finals = partials[0]
    else:
        feeds = {
            f"{x}_input": np.stack([p[x] for p in partials]) for x in out_names
        }
        finals = compiled.run_block(feeds, dev)
    n_rows = planned[1] if planned is not None else frame.num_rows
    profiling.record("reduce_blocks", time.perf_counter() - t0, n_rows)
    return _unpack_results(program, finals)


# ---------------------------------------------------------------------------
# aggregate (keyed)
# ---------------------------------------------------------------------------

_SEGMENT_OPS = ("reduce_sum", "reduce_min", "reduce_max")


def _agg_schema_infos(schema, keys, program) -> List[ColumnInfo]:
    """Result schema of a keyed aggregate: key columns (Unknown lead)
    then the program outputs sorted by name."""
    infos: List[ColumnInfo] = []
    for k in keys:
        infos.append(schema[k].with_block_shape(
            schema[k].cell_shape.prepend(Unknown)
        ))
    for o in sorted(program.outputs, key=lambda s: s.name):
        infos.append(ColumnInfo(o.name, o.dtype, o.shape.prepend(Unknown)))
    return infos


def _empty_agg_blocks(schema) -> List[Block]:
    """The zero-row aggregate result for ``schema``."""
    empty: Block = {}
    for i in schema:
        dims = tuple(0 if d == Unknown else d for d in i.cell_shape.dims)
        if i.is_device:
            empty[i.name] = np.empty((0,) + dims, dtype=i.dtype.np_dtype)
        else:
            empty[i.name] = []
    return [empty]


def _segment_reduce_device(ops_key, num_groups, vals, sids, device) -> Dict[str, torch.Tensor]:
    """Keyed-reduction dispatch on tensors, recorded as a cost-model
    decision (``plan/rules.decide_segment_reduce``): the fused
    segment-reduce kernel (``kernels/segment_reduce.py`` — ONE call for
    every fetch) serves every eligible feed on a CUDA device, and
    :func:`run_segment_fast` (the per-op route: the segment-sum kernel
    for float32/bfloat16 sums, PyTorch scatter ops for the rest) the
    others. On the CPU an eligible feed computes the fused kernel's plain
    version. Every keyed reduction — the eager aggregate and the plan's
    epilogues and pushdown — dispatches here, so fused and unfused
    outputs stay bit-identical. ``vals`` and the int32 ``sids`` are
    tensors on ``device``; returns tensors there."""
    from ..kernels import segment_reduce as _ksr
    from ..plan import rules as _prules
    from ..plan.lower import _note_decision

    _reject_bool_sum_mean(ops_key, vals)
    decision = _prules.decide_segment_reduce(ops_key, vals, num_groups, device=device)
    _note_decision(decision)
    if decision.kind == _prules.CUDA_SEGMENT_REDUCE or (
            device.type == "cpu" and _ksr.eligible(ops_key, vals, num_groups)):
        return _ksr.segment_reduce(ops_key, num_groups, vals, sids)
    return run_segment_fast(ops_key, num_groups, vals, sids)


def _segment_tables_device(ops_key, num_groups, vals, sids, device):
    """The raw per-group tables of a keyed reduction, for a merge across
    ranks before any finalize: ``({name: table}, counts)`` with sums and
    means as raw sums in their accumulator (float32 for float32/bfloat16
    values, the kernel's wrapping int32 for the narrow ints), min/max
    exact, and int32 row counts per group. Recorded as the same cost-model
    decision as :func:`_segment_reduce_device` (the counts ride as one more
    int32 sum): on a CUDA device an eligible feed launches the fused
    kernel ONCE (``kernels/segment_reduce.segment_reduce_tables``); the
    rest take ``segment_total`` (the ``segment_sum`` kernel for
    float32/bfloat16 sums) and PyTorch scatter ops, which on the CPU give
    the kernel's plain tables."""
    from ..kernels import segment_reduce as _ksr
    from ..plan import rules as _prules
    from ..plan.lower import _note_decision
    from .segment import segment_minmax, segment_total

    _reject_bool_sum_mean(ops_key, vals)
    key = tuple(ops_key) + (("__count__", "reduce_sum"),)
    cols = dict(vals)
    cols["__count__"] = torch.ones(int(sids.shape[0]), dtype=torch.int32, device=sids.device)
    decision = _prules.decide_segment_reduce(key, cols, num_groups, device=device)
    _note_decision(decision)
    # a rank holding no rows launches nothing: its tables are the
    # identities the scatter route fills in
    if decision.kind == _prules.CUDA_SEGMENT_REDUCE and int(sids.shape[0]) > 0:
        raw, _ = _ksr.segment_reduce_tables(key, num_groups, cols, sids)
        tables = {}
        for x, op in ops_key:
            t = raw[x][:, 0] if vals[x].ndim == 1 else raw[x]
            if op in ("reduce_min", "reduce_max"):
                t = t.to(vals[x].dtype)  # exact: the identities or a value
            tables[x] = t
        return tables, raw["__count__"][:, 0]
    tables = {}
    with torch.inference_mode():
        for x, op in ops_key:
            if op in ("reduce_sum", "reduce_mean"):
                tables[x] = segment_total(vals[x], sids, num_groups)
            else:
                tables[x] = segment_minmax(vals[x], sids, num_groups, op)
        counts = torch.bincount(sids.long(), minlength=num_groups).to(torch.int32)
    return tables, counts


def _segment_reduce_best(ops_key, num_groups, val_cols, seg_ids, device):
    """:func:`_segment_reduce_device` over host or device columns: numpy
    values and ids move to the device (device tensors are used as they
    are); returns numpy columns."""
    vals = {
        x: (val_cols[x].to(device) if torch.is_tensor(val_cols[x])
            else dt.to_torch(val_cols[x], device))
        for x, _ in ops_key
    }
    _reject_bool_sum_mean(ops_key, vals)
    sids = dt.to_torch(np.asarray(seg_ids).astype(np.int32), device)
    res = _segment_reduce_device(ops_key, num_groups, vals, sids, device)
    return {x: dt.to_numpy(res[x]) for x, _ in ops_key}


def _reject_bool_sum_mean(ops_key, vals) -> None:
    """A keyed sum or mean of a bool column raises the reference's
    ``TypeError`` (its segment sum of bool does not exist), before any
    route is chosen: the fused kernel and the per-op route would return a
    sum or a mean cast back to bool."""
    for out_name, op in ops_key:
        if op in ("reduce_sum", "reduce_mean") and (
                str(vals[out_name].dtype).removeprefix("torch.") == "bool"):
            raise TypeError(
                "add does not accept dtype bool at position 0. Accepted dtypes "
                "at position 0 are subtypes of integer, floating, complexfloating.")


def run_segment_fast(ops_key, num_groups, vals, sids) -> Dict[str, torch.Tensor]:
    """The per-op keyed reduction (≙ the reference's ``_seg_fast_for``):
    sums through :func:`~tensorframes_tpu_torch.ops.segment.segment_sum`,
    min/max through scatter reductions. A float mean divides the sum,
    still in its accumulator (float32, float64 for float64), by an int64
    row count and is cast to the value dtype once, as the reference's
    float64 host route does. An integer mean sums and counts in the value
    dtype, wrapping as the reference's segment sums do, and divides in the
    reference's inexact type. ``sids`` may arrive in any order."""
    from .segment import segment_minmax, segment_sum, segment_total

    _reject_bool_sum_mean(ops_key, vals)
    outs = {}
    with torch.inference_mode():
        for out_name, op in ops_key:
            v = vals[out_name]
            if op == "reduce_mean":
                s = segment_total(v, sids, num_groups)
                count = torch.int64 if v.is_floating_point() else v.dtype
                c = torch.zeros(num_groups, dtype=count, device=v.device).index_add_(
                    0, sids.long(), torch.ones(v.shape[:1], dtype=count, device=v.device)
                )
                c = c.reshape((-1,) + (1,) * (v.ndim - 1))
                # integer true division computes in the reference's inexact
                # type (int64 -> float64, else float32)
                inexact = s.dtype if s.is_floating_point() else (
                    torch.float64 if v.dtype == torch.int64 else torch.float32)
                # cast back: fetch dtype == input dtype by contract
                outs[out_name] = (s.to(inexact) / c.to(inexact)).to(v.dtype)
            elif op == "reduce_sum":
                outs[out_name] = segment_sum(v, sids, num_groups)
            else:
                outs[out_name] = segment_minmax(v, sids, num_groups, op)
    return outs


def _value_columns(frame, out_names) -> Dict[str, np.ndarray]:
    """The aggregated value columns, gathered across blocks; a ragged
    one raises."""
    val_cols = {}
    for x in out_names:
        vals = frame.column_values(x)
        if vals.dtype == object:
            raise ValueError(
                f"Column {x!r} is ragged; aggregate requires uniform cells "
                "(run analyze() first)."
            )
        val_cols[x] = vals
    return val_cols


def _host_fast_aggregate(frame, keys, seg_info, out_names, device):
    """The segment fast path over a (forced) frame: gather value columns,
    encode group keys on the host (:func:`~tensorframes_tpu_torch.ops.keys.frame_group_ids`
    — lexicographic group order, as in the reference), one vectorized
    segment reduction on the device. Returns
    ``(out_key_cols, out_cols, n_rows)``."""
    from .keys import frame_group_ids

    val_cols = _value_columns(frame, out_names)
    seg_ids, group_key_cols, num_groups = frame_group_ids(frame, keys)
    ops_key = tuple((out_name, op) for out_name, op, _ in seg_info)
    out_cols = _segment_reduce_best(ops_key, num_groups, val_cols, seg_ids, device)
    return dict(zip(keys, group_key_cols)), out_cols, len(seg_ids)


def _batched_compaction(program, val_cols, seg_ids, num_groups, out_names, device):
    """Arbitrary-combiner aggregation as level-batched compaction on the
    device (≙ the reference's ``_batched_compaction``, its stand-in for
    ``TensorFlowUDAF``'s compact-every-bufferSize fold,
    DebugRowOps.scala:608-702): the program is applied to chunks of at
    most ``aggregate_buffer_size`` rows of one group, and the partials
    stack and compact again — the UDAF's algebraic contract. Each level
    runs every full chunk of every group as ONE vmapped dispatch and the
    remainder chunks as one dispatch per size, so a level takes at most
    ``buf`` dispatches. Rows are grouped by a stable host argsort of the
    ids; the level state stays on the device, chunks are gathered there
    by ``index_select`` over host-built index matrices (the chunk count
    padded to a power-of-two bucket by repeating the last row; padded
    chunks are never scattered back), and results go into the next level
    by ``index_copy_``."""
    if num_groups == 0:
        out = {}
        for o in program.outputs:
            dims = tuple(0 if d == Unknown else d for d in o.shape.dims)
            out[o.name] = np.empty((0,) + dims, o.dtype.np_dtype)
        return out
    buf = max(2, get_config().aggregate_buffer_size)
    compiled = program.compiled()
    order = np.argsort(seg_ids, kind="stable")
    counts = np.bincount(seg_ids, minlength=num_groups).astype(np.int64)

    def run_chunks(cur, mat):
        """One vmapped dispatch over a [n_chunks, size] row-index matrix."""
        n_chunks = mat.shape[0]
        target = bucket_rows(n_chunks)
        if target > n_chunks:
            mat = np.concatenate(
                [mat, np.repeat(mat[-1:], target - n_chunks, axis=0)])
        idx = dt.to_torch(mat.reshape(-1).astype(np.int32), device)
        feeds = {
            f"{x}_input": cur[x].index_select(0, idx).reshape(
                mat.shape + tuple(cur[x].shape[1:]))
            for x in out_names
        }
        res = compiled.run_rows(feeds, device, to_numpy=False)
        return {x: res[x][:n_chunks] for x in out_names}

    def scatter(parts, rows):
        nxt = {}
        for x in out_names:
            first = parts[0][1][x]
            acc = torch.zeros((rows,) + tuple(first.shape[1:]), dtype=first.dtype,
                              device=first.device)
            for pos, res in parts:
                acc.index_copy_(0, dt.to_torch(pos, device), res[x])
            nxt[x] = acc
        return nxt

    with torch.inference_mode():
        order_t = None
        cur = {}
        for x in out_names:
            v = val_cols[x]
            if torch.is_tensor(v):  # a sharded frame's rows, on their device
                if order_t is None:
                    order_t = dt.to_torch(order, v.device)
                cur[x] = v.index_select(0, order_t).to(device)
            else:
                cur[x] = dt.to_torch(np.asarray(v)[order], device)
        while int(counts.max(initial=0)) > buf:
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            k, r = counts // buf, counts % buf
            new_counts = k + (r > 0)
            new_starts = np.concatenate(([0], np.cumsum(new_counts)[:-1]))
            parts = []  # (positions in the next level's state, results)
            if int(k.sum()):
                # every full chunk of every group: one dispatch
                g_of = np.repeat(np.arange(num_groups), k)
                rank = np.arange(len(g_of)) - np.repeat(np.cumsum(k) - k, k)
                base = starts[g_of] + rank * buf
                mat = base[:, None] + np.arange(buf)[None, :]
                parts.append((new_starts[g_of] + rank, run_chunks(cur, mat)))
            for rv in np.unique(r[r > 0]):
                # remainder chunks, one dispatch per size
                sel = np.flatnonzero(r == rv)
                base = starts[sel] + k[sel] * buf
                mat = base[:, None] + np.arange(int(rv))[None, :]
                parts.append((new_starts[sel] + k[sel], run_chunks(cur, mat)))
            cur, counts = scatter(parts, int(new_counts.sum())), new_counts
        # final application: the program runs at least once per group,
        # single-row groups too (the UDAF's final evaluate)
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        parts = []
        for cv in np.unique(counts):
            sel = np.flatnonzero(counts == cv)
            mat = starts[sel][:, None] + np.arange(int(cv))[None, :]
            parts.append((sel, run_chunks(cur, mat)))
        finals = scatter(parts, num_groups)
    return Readback(finals).wait()


def _allgather_rows(arr: np.ndarray, ks: Optional[np.ndarray] = None) -> np.ndarray:
    """Every rank's ``[k_r, *cell]`` rows concatenated in rank order (the
    union order of ``device_agg._allgather_dicts``), through one
    allgather of the pickled arrays."""
    import pickle

    from ..blockstore.store import HOSTGATHER_BYTES
    from ..parallel.collectives import allgather_bytes

    bufs = allgather_bytes(pickle.dumps(np.asarray(arr), protocol=pickle.HIGHEST_PROTOCOL))
    HOSTGATHER_BYTES.inc(float(len(bufs) * max(len(b) for b in bufs)))
    return np.concatenate([pickle.loads(b) for b in bufs])


def _aggregate_multiprocess_generic(program, frame, keys, out_names, device):
    """Arbitrary-combiner aggregation across ranks (the UDAF merge at
    multi-rank scale). Per rank: local group-id encode and level-batched
    compaction of its own rows on its device to ONE partial row per local
    group (the program's algebraic contract, the reference UDAF's merge
    assumption, DebugRowOps.scala:668-683). Then one small allgather of
    (keys, partial rows) and a final combine of the union — every rank
    computes the same replicated result — or, with the file shuffle armed,
    a hash-partitioned merge through spill files. Returns None when
    ineligible (ragged values, a host tail, outputs with Unknown dims — an
    empty rank could not shape its partials)."""
    from .device_agg import (
        _allgather_dicts,
        assemble_key_cols,
        extract_local_rows,
        uniform_ok,
    )
    from .exchange import _file_shuffle_ctx
    from .keys import group_ids
    from ..parallel.distributed import process_count

    blocks = frame.blocks()
    main = blocks[0]
    tail = blocks[1] if len(blocks) > 1 else None
    if frame.num_rows == 0:
        return None
    ok = True
    if tail is not None and any(_block_num_rows({c: tail[c]}) for c in tail):
        ok = False  # host-tail rows are held by every rank
    if any(d == Unknown for o in program.outputs for d in o.shape.dims):
        ok = False
    cols = {}
    if ok:
        for c in list(keys) + list(out_names):
            v = main[c]
            if c in out_names:
                if isinstance(v, list):
                    ok = False  # ragged value cells can't batch
                    break
                cols[c] = v
            else:
                cols[c] = extract_local_rows(v)
        if ok:
            n_local = len(cols[keys[0]])
            ok = all(len(cols[c]) == n_local for c in cols)
    fctx = _file_shuffle_ctx()
    if fctx is not None and fctx.nprocs != process_count():
        fctx = None  # a stale/foreign shuffle dir must not hijack a fleet
    if fctx is not None and fctx.nprocs > 1:
        # the eligibility vote goes through spill files too
        from ..blockstore import shuffle as _fs

        agree = _fs.vote_all(ok, name="agg.ok")
    else:
        agree = uniform_ok(ok)
    if not agree:
        return None
    if len(cols[keys[0]]):
        ids_local, local_dict, k_local = group_ids([cols[k] for k in keys])
    else:
        ids_local = np.zeros(0, np.int64)
        local_dict = [np.asarray(cols[k])[:0] for k in keys]
        k_local = 0
    partials = _batched_compaction(
        program, {x: cols[x] for x in out_names}, ids_local, k_local, out_names, device,
    )
    if fctx is not None and fctx.nprocs > 1:
        return _merge_partials_shuffled(
            program, frame, keys, out_names, list(local_dict), partials, device,
        )
    union_key_cols, _ = _allgather_dicts(list(local_dict))
    union_vals = {x: _allgather_rows(partials[x]) for x in out_names}
    union_ids, group_key_cols, K = group_ids(union_key_cols)
    out_cols = _batched_compaction(program, union_vals, union_ids, K, out_names, device)
    return assemble_key_cols(frame, keys, group_key_cols), out_cols


def _merge_partials_shuffled(program, frame, keys, out_names, local_dict, partials, device):
    """Merge per-rank partial tables through the file shuffle
    (``blockstore.shuffle``) instead of allgathering them: partials
    hash-partition by group key through spill files, each rank combines
    only its key partition, and only the small finals are shared back.
    Returns the same replicated ``(key_cols, out_cols)`` as the allgather
    path, groups in lexicographic key order."""
    from ..blockstore import shuffle as _fs
    from .device_agg import assemble_key_cols
    from .exchange import partition_by_hash
    from .keys import group_ids

    key_names = [f"__k{i}" for i in range(len(local_dict))]
    table = {n: np.asarray(a) for n, a in zip(key_names, local_dict)}
    for x in out_names:
        table[x] = np.asarray(partials[x])
    nprocs = _fs.context().nprocs
    part = partition_by_hash([table[n] for n in key_names], nprocs)
    mine = _fs.shuffle_rows(table, part, name="agg.partials")
    kcols = [np.asarray(mine[n]) for n in key_names]
    if len(kcols[0]):
        ids, gk, K = group_ids(kcols)
        combined = _batched_compaction(
            program, {x: np.asarray(mine[x]) for x in out_names},
            ids.astype(np.int64), K, out_names, device,
        )
    else:
        gk = [a[:0] for a in kcols]
        combined = {x: np.asarray(mine[x])[:0] for x in out_names}
    final = {n: np.asarray(g) for n, g in zip(key_names, gk)}
    for x in out_names:
        final[x] = np.asarray(combined[x])
    union = _fs.allshare_table(final, name="agg.finals")
    union_key_cols = [
        np.asarray(union[n], dtype=object)
        if isinstance(union[n], list) else np.asarray(union[n])
        for n in key_names
    ]
    union_ids, group_key_cols, K = group_ids(union_key_cols)
    out_cols = _batched_compaction(
        program, {x: np.asarray(union[x]) for x in out_names},
        union_ids.astype(np.int64), K, out_names, device,
    )
    return assemble_key_cols(frame, keys, group_key_cols), out_cols


def _generic_aggregate(program, frame, keys, out_names, device):
    """The generic (UDAF) route over a non-empty frame: value columns
    gathered, keys encoded on the host as the fast path encodes them, and
    :func:`_batched_compaction` on the device. Returns
    ``(out_key_cols, out_cols, n_rows)``."""
    from .keys import frame_group_ids

    val_cols = _value_columns(frame, out_names)
    seg_ids, group_key_cols, num_groups = frame_group_ids(frame, keys)
    out_cols = _batched_compaction(
        program, val_cols, seg_ids, num_groups, out_names, device
    )
    return dict(zip(keys, group_key_cols)), out_cols, len(seg_ids)


def aggregate(
    fetches: Fetches, grouped: GroupedData, strict: bool = False, device=None
) -> "TensorFrame":
    """Algebraic aggregation over grouped data: one output row per key.

    ≙ ``tfs.aggregate`` (core.py:401-419) → DebugRowOps.aggregate via
    ``TensorFlowUDAF`` (DebugRowOps.scala:554-599, 608-702). Fetches follow
    the ``x`` / ``x_input`` naming contract, like reduce_blocks.

    Keys encode to dense group ids on the host (value columns are never
    reordered). Fetches that are DSL ``reduce_sum/min/max/mean`` reducers
    over placeholders lower to one segment reduction on the device fed
    UNSORTED ids; any other program takes the generic UDAF route
    (:func:`_batched_compaction`), which must be algebraic: re-applying it
    to stacked partials must be valid.

    A sharded frame first tries the device plans (``ops/device_agg.py``:
    per-rank segment tables and one all-reduce per op and dtype), then,
    across ranks, the generic merge of per-rank partials; what neither
    takes runs the host paths (one rank) or raises (ranks).
    """
    frame = grouped.frame
    keys = grouped.keys
    dev = _verb_device(frame, device)
    t0 = time.perf_counter()
    program, seg_info = _normalize_program(
        fetches, frame.schema, block=True, device=dev, reduce_mode="blocks"
    )
    validate_reduce_blocks(program, frame.schema)
    if strict:
        _strict_lint(program, frame, block_mode=True)
    out_names = [o.name for o in program.outputs]
    algebraic = seg_info is not None and all(
        op in _SEGMENT_OPS or op == "reduce_mean" for _, op, _ in seg_info
    )
    schema = Schema(_agg_schema_infos(frame.schema, keys, program))
    unfused_reason: Optional[str] = None
    # whole-pipeline route: a lazy plan-carrying frame records an
    # `aggregate` node instead of forcing its chain — the lowering
    # composes the fused upstream maps with the keyed reduction
    # (plan/lower.execute_aggregate), so the mapped value columns never
    # come back to the host. Non-algebraic fetches keep the generic
    # path, with the reason recorded.
    from ..plan import ir as plan_ir

    if (getattr(frame, "_plan", None) is not None and plan_ir.fusion_enabled()
            and not frame.is_sharded):
        if algebraic:
            node = plan_ir.PlanNode(
                "aggregate",
                parent=plan_ir.node_for_parent(frame, dev),
                program=program,
                out_names=out_names,
                keys=keys,
                spec=tuple(seg_info),
                schema=schema,
                device=dev,
            )
            node._extended = True  # terminal: consumers re-source on it

            def agg_pending():
                from ..plan.lower import execute_aggregate

                return execute_aggregate(node)

            result = TensorFrame(None, schema, pending=agg_pending)
            node.bind(result)
            result._plan = node
            return result
        unfused_reason = (
            "non-algebraic fetches (no segment lowering): the chain "
            "materializes before the generic UDAF path runs — use "
            "reduce_sum/min/max/mean DSL fetches to fuse the epilogue"
        )
    def assembled(out_key_cols, out_cols, n):
        block: Block = dict(out_key_cols)
        for o in program.outputs:
            block[o.name] = out_cols[o.name]
        profiling.record("aggregate", time.perf_counter() - t0, n)
        return TensorFrame([block], schema)

    if seg_info is not None and frame.is_sharded:
        from .device_agg import try_aggregate_device

        got = try_aggregate_device(frame, keys, seg_info, out_names, dev)
        if got is not None:
            return assembled(got[0], got[1], frame.num_rows)
    # the multi-rank generic merge re-applies the program to stacked
    # partials: right for any UDAF and for sum/min/max, not for a mean
    # (a mean of partial means is not the group mean)
    mean_free = seg_info is None or all(op != "reduce_mean" for _, op, _ in seg_info)
    if frame.is_sharded and mean_free:
        from ..parallel.distributed import process_count

        if process_count() > 1:
            got = _aggregate_multiprocess_generic(program, frame, keys, out_names, dev)
            if got is not None:
                return assembled(got[0], got[1], frame.num_rows)
    if frame.num_rows == 0:
        profiling.record("aggregate", time.perf_counter() - t0, 0)
        return TensorFrame(_empty_agg_blocks(schema), schema)
    if algebraic:
        out_key_cols, out_cols, n = _host_fast_aggregate(
            frame, keys, seg_info, out_names, dev
        )
    else:
        out_key_cols, out_cols, n = _generic_aggregate(
            program, frame, keys, out_names, dev
        )
    block: Block = dict(out_key_cols)
    for o in program.outputs:
        block[o.name] = out_cols[o.name]
    profiling.record("aggregate", time.perf_counter() - t0, n)
    result = TensorFrame([block], schema)
    if unfused_reason is not None:
        plan_ir.mark_unfused(result, "aggregate", unfused_reason)
    return result
