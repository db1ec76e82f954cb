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
stage by stage, with the same bits. No sharded frames.
"""

from __future__ import annotations

import sys
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import dtypes as dt
from ..config import get_config, resolve_device
from ..dsl.node import Node, compile_fetches, segment_reduce_info
from ..frame import Block, GroupedData, TensorFrame, _block_num_rows
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

Fetches = Union[Node, Sequence[Node], Program, Callable]


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


def _is_pandas(obj) -> bool:
    """True for a pandas DataFrame; pandas is imported only when the
    caller has loaded it, so the package runs where it is not installed."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(obj, pd.DataFrame)


def _map_pandas(fetches, pdf, feed_dict, device):
    """Local pandas path (≙ ``_map_pd``, core.py:171-183): run the program
    on the pandas columns (block semantics, whole columns, as the
    reference's ``_map_pd`` feeds them) and append the outputs to a copy
    of the frame."""
    from ..frame import frame_from_pandas

    result = map_blocks(fetches, frame_from_pandas(pdf, num_blocks=1),
                        feed_dict=feed_dict, device=device)
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
    outputs are read back (config.py).
    """
    if _is_pandas(frame):
        return _map_pandas(fetches, frame, feed_dict, device)
    dev = resolve_device(device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=True, device=dev, feed_dict=feed_dict
    )
    program = _apply_feed_dict(program, feed_dict)
    validate_map(program, frame.schema, block=True, trim=trim)
    out_infos = _sorted_output_infos(program, block_mode=True)
    schema = Schema(out_infos if trim else out_infos + frame.schema.columns)
    if not trim:
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
        depth = max(0, cfg.map_pipeline_depth)
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
        prefetch = max(0, cfg.map_prefetch_depth)
        if prefetch > 0 and len(blocks) > 1:
            from .. import io as _io

            feeds_seq = _io.prefetch_to_device(feeds_seq, size=prefetch, device=dev)
        try:
            for b, feeds in zip(blocks, feeds_seq):
                n = _block_num_rows(b)
                n_total += n
                outs = compiled.run_block(feeds, dev, to_numpy=False)
                del feeds
                in_flight.append((b, n, Readback(outs)))
                if len(in_flight) > depth:
                    finish(*in_flight.popleft())
            while in_flight:
                finish(*in_flight.popleft())
        finally:
            close = getattr(feeds_seq, "close", None)
            if close is not None:
                close()  # stops the prefetch worker on an early exit
        profiling.record("map_blocks", time.perf_counter() - t0, n_total)
        return out_blocks

    result = TensorFrame(None, schema, pending=compute)
    result._produced_by_map = True
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
        feeds = {
            name: np.stack([np.asarray(cols[name][i]) for i in idx])
            for name in input_names
        }
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
    device=None,
) -> "TensorFrame":
    """Transform a frame row by row (placeholders are cell-shaped).

    ≙ ``tfs.map_rows`` (core.py:224-265) → DebugRowOps.mapRows
    (DebugRowOps.scala:403-484). Uniform blocks run as one vmapped
    program; ragged blocks group rows by cell shape. A pandas DataFrame
    takes the reference's pandas path (whole columns, as ``map_blocks``).
    """
    if _is_pandas(frame):
        return _map_pandas(fetches, frame, feed_dict, device)
    dev = resolve_device(device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=False, device=dev, feed_dict=feed_dict
    )
    program = _apply_feed_dict(program, feed_dict)
    validate_map(program, frame.schema, block=False)
    out_infos = _sorted_output_infos(program, block_mode=False)
    schema = Schema(out_infos + frame.schema.columns)
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
        profiling.record("map_rows", time.perf_counter() - t0, n_total)
        return results

    result = TensorFrame(None, schema, pending=compute)
    result._produced_by_map = True
    return result


# ---------------------------------------------------------------------------
# reduce_rows
# ---------------------------------------------------------------------------

def _unpack_results(program: Program, finals: Dict[str, np.ndarray]):
    """Return numpy results in fetch order; single fetch unwraps
    (≙ _unpack_row, core.py:111-125)."""
    out = []
    for name in program.fetch_order or program.output_names:
        arr = np.asarray(finals[name])
        out.append(arr if arr.ndim > 0 else arr.item())
    return out[0] if len(out) == 1 else out


def reduce_rows(
    fetches: Fetches, frame, device=None
) -> Union[np.ndarray, list]:
    """Pairwise-reduce all rows to a single row. Each fetch ``x`` consumes
    placeholders ``x_1``/``x_2`` (Operations.scala:83-96). Eager
    (core.py:197 "not lazy").

    Execution: within each block, a sequential fold on the device; block
    partials are folded the same way. Reduction order is unspecified by
    contract (core.py:186-187); this fold takes the reference's order.
    """
    dev = resolve_device(device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=False, device=dev, reduce_mode="rows"
    )
    validate_reduce_rows(program, frame.schema)
    out_names = [o.name for o in program.outputs]
    fold = make_pair_fold(program, out_names)
    t0 = time.perf_counter()
    # whole-pipeline route: a lazy plan-carrying frame fuses its map
    # chain WITH the pairwise-fold epilogue (plan/lower.lower_reduce) —
    # the mapped columns never come back to the host; the per-block
    # partials then combine exactly as always
    from ..plan.lower import lower_reduce

    planned = lower_reduce(frame, program, out_names, "rows", dev)
    partials: List[Dict[str, np.ndarray]] = (
        list(planned[0]) if planned is not None else []
    )
    for b in ([] if planned is not None else frame.blocks()):
        n = _block_num_rows(b)
        if n == 0:
            continue
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
            partials.append({x: np.asarray(feeds[x][0]) for x in out_names})
        else:
            res = fold({x: dt.to_torch(feeds[x], dev) for x in out_names})
            partials.append({x: dt.to_numpy(res[x]) for x in out_names})
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
    fetches: Fetches, frame, device=None
) -> Union[np.ndarray, list]:
    """Block-reduce all rows to a single row. Each fetch ``x`` consumes a
    placeholder ``x_input`` with one extra (Unknown) leading dim
    (Operations.scala:98-108). Eager.

    Execution ≙ performReduceBlock per partition + pairwise merge
    (DebugRowOps.scala:510-533), except partials are stacked and reduced in
    one final program run instead of pairwise merging coordinated by Spark.
    """
    dev = resolve_device(device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=True, device=dev, reduce_mode="blocks"
    )
    validate_reduce_blocks(program, frame.schema)
    out_names = [o.name for o in program.outputs]
    compiled = program.compiled()
    t0 = time.perf_counter()
    # whole-pipeline route: fuse the recorded map chain with the reduce
    # program into one dispatch per block (plan/lower.lower_reduce) —
    # the mapped columns never come back to the host; partials combine
    # as always
    from ..plan.lower import lower_reduce

    planned = lower_reduce(frame, program, out_names, "blocks", dev)
    partials: List[Dict[str, np.ndarray]] = (
        list(planned[0]) if planned is not None else []
    )
    for b in ([] if planned is not None else frame.blocks()):
        if _block_num_rows(b) == 0:
            continue
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
        partials.append(compiled.run_block(feeds, dev))
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
            raise TypeError("add does not accept dtype bool")


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
        cur = {x: dt.to_torch(np.asarray(val_cols[x])[order], device)
               for x in out_names}
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
    fetches: Fetches, grouped: GroupedData, device=None
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
    """
    frame = grouped.frame
    keys = grouped.keys
    dev = resolve_device(device)
    t0 = time.perf_counter()
    program, seg_info = _normalize_program(
        fetches, frame.schema, block=True, device=dev, reduce_mode="blocks"
    )
    validate_reduce_blocks(program, frame.schema)
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

    if getattr(frame, "_plan", None) is not None and plan_ir.fusion_enabled():
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
