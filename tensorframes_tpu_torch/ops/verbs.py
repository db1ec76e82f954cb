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
* ``aggregate`` — keyed aggregation of algebraic reducer fetches through
  the segment-reduce kernels (the segment fast path).

Programs may be DSL nodes or plain Python functions over torch tensors
(see program.py). This is the reference's eager path
(``TFTPU_FUSION=0``): no plan layer, no sharded frames.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import dtypes as dt
from ..config import resolve_device
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
    pad_lead_dim,
)

logger = get_logger(__name__)

Fetches = Union[Node, Sequence[Node], Program, Callable]


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
    """
    dev = resolve_device(device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=True, device=dev, feed_dict=feed_dict
    )
    program = _apply_feed_dict(program, feed_dict)
    validate_map(program, frame.schema, block=True, trim=trim)
    out_infos = _sorted_output_infos(program, block_mode=True)
    schema = Schema(out_infos if trim else out_infos + frame.schema.columns)
    compiled = program.compiled()
    parent = frame
    input_names = program.input_names

    def compute() -> List[Block]:
        out_blocks: List[Block] = []
        t0 = time.perf_counter()
        n_total = 0
        for b in parent.blocks():
            n = _block_num_rows(b)
            n_total += n
            outs = compiled.run_block(gather_feeds(b, input_names, program), dev)
            if trim:
                out_blocks.append({i.name: outs[i.name] for i in out_infos})
                continue
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
        profiling.record("map_blocks", time.perf_counter() - t0, n_total)
        return out_blocks

    return TensorFrame(None, schema, pending=compute)


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


def _ragged_gather_plan(cols, input_names, n, device):
    """Device-side ragged staging: a single 1-D ragged column's cells move
    ONCE as a flat buffer, and each shape group's bucket-padded batch is
    gathered on the device by the ragged-gather kernel
    (``kernels/ragged_gather.py``). Returns a ``gather(idx) -> feeds``
    closure, or None when the column is not that shape (then groups stage
    on the host)."""
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
    from ..kernels import ragged_gather as _krg

    lens = np.fromiter((c.shape[0] for c in cells), np.int64, count=n)
    if int(lens.sum()) > np.iinfo(np.int32).max:
        # start offsets are int32; a flat buffer past 2^31 elements would
        # wrap them — host staging handles it
        return None
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat_dev = dt.to_torch(np.concatenate(cells), device)

    def gather(idx):
        g = len(idx)
        st = np.zeros(bucket_rows(g), np.int32)  # padding rows re-read offset 0;
        st[:g] = starts[np.asarray(idx)]          # their outputs are sliced off
        return {name: _krg.ragged_gather_rows(flat_dev, st, int(lens[int(idx[0])]))}

    return gather


def _ragged_rows_outs(
    cols: Dict[str, list],
    input_names: Sequence[str],
    n: int,
    program: Program,
    compiled,
    device,
) -> Dict[str, object]:
    """Run a row-wise program over ``n`` ragged rows (``cols`` maps each
    input to its per-row cells): group rows by input cell shape, stage each
    group's bucket-padded feeds (on the device through the gather kernel
    where it applies, else stacked on the host), dispatch, and scatter the
    results back to row order. Returns one value per output: a dense
    ``[n, *cell]`` array (uniform cell shapes) or a per-row cell list
    (ragged outputs)."""
    if n == 0:
        out0: Dict[str, object] = {}
        for o in program.outputs:
            dims = tuple(0 if d == Unknown else d for d in o.shape.dims)
            out0[o.name] = np.empty((0,) + dims, dtype=o.dtype.np_dtype)
        return out0
    group_list = [g for g in _group_rows_by_shape(cols, input_names, n)
                  if len(g)]
    gather = _ragged_gather_plan(cols, input_names, n, device)

    def group_feeds(idx):
        g = len(idx)
        feeds = {
            name: np.stack([np.asarray(cols[name][i]) for i in idx])
            for name in input_names
        }
        return pad_lead_dim(feeds, g, bucket_rows(g))

    outs_list: List[Dict[str, np.ndarray]] = []
    for idx in group_list:
        feeds = gather(idx) if gather is not None else group_feeds(idx)
        outs_list.append(compiled.run_rows(feeds, device))
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
    program; ragged blocks group rows by cell shape.
    """
    dev = resolve_device(device)
    program, _ = _normalize_program(
        fetches, frame.schema, block=False, device=dev, feed_dict=feed_dict
    )
    program = _apply_feed_dict(program, feed_dict)
    validate_map(program, frame.schema, block=False)
    out_infos = _sorted_output_infos(program, block_mode=False)
    schema = Schema(out_infos + frame.schema.columns)
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

    return TensorFrame(None, schema, pending=compute)


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
    partials: List[Dict[str, np.ndarray]] = []
    for b in frame.blocks():
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
    profiling.record("reduce_rows", time.perf_counter() - t0, frame.num_rows)
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
    partials: List[Dict[str, np.ndarray]] = []
    for b in frame.blocks():
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
    profiling.record("reduce_blocks", time.perf_counter() - t0, frame.num_rows)
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


def _segment_reduce_best(ops_key, num_groups, val_cols, seg_ids, device):
    """Keyed-reduction dispatch. The values and int32 ids move to the
    device; the fused segment-reduce kernel (``kernels/segment_reduce.py``
    — ONE call for every fetch) serves every eligible feed, and
    :func:`run_segment_fast` (the per-op route: the segment-sum kernel for
    float32/bfloat16 sums, PyTorch scatter ops for the rest) serves the
    others. Returns numpy columns."""
    from ..kernels import segment_reduce as _ksr

    vals = {x: dt.to_torch(val_cols[x], device) for x, _ in ops_key}
    sids = dt.to_torch(np.asarray(seg_ids).astype(np.int32), device)
    if _ksr.eligible(ops_key, vals, num_groups):
        res = _ksr.segment_reduce(ops_key, num_groups, vals, sids)
    else:
        res = run_segment_fast(ops_key, num_groups, vals, sids)
    return {x: dt.to_numpy(res[x]) for x, _ in ops_key}


def run_segment_fast(ops_key, num_groups, vals, sids) -> Dict[str, torch.Tensor]:
    """The per-op keyed reduction (≙ the reference's ``_seg_fast_for``):
    sums through :func:`~tensorframes_tpu_torch.ops.segment.segment_sum`,
    min/max through scatter reductions, means as sum / count cast back to
    the value dtype. ``sids`` may arrive in any order."""
    from .segment import segment_minmax, segment_sum

    outs = {}
    with torch.inference_mode():
        for out_name, op in ops_key:
            v = vals[out_name]
            if op == "reduce_mean":
                s = segment_sum(v, sids, num_groups)
                c = torch.zeros(num_groups, dtype=v.dtype, device=v.device).index_add_(
                    0, sids.long(), torch.ones(v.shape[:1], dtype=v.dtype, device=v.device)
                )
                c = c.reshape((-1,) + (1,) * (v.ndim - 1))
                if not v.is_floating_point():
                    # integer true division computes in the reference's
                    # inexact type (int64 -> float64, else float32)
                    inexact = torch.float64 if v.dtype == torch.int64 else torch.float32
                    s, c = s.to(inexact), c.to(inexact)
                # cast back: fetch dtype == input dtype by contract
                outs[out_name] = (s / c).to(v.dtype)
            elif op == "reduce_sum":
                outs[out_name] = segment_sum(v, sids, num_groups)
            else:
                outs[out_name] = segment_minmax(v, sids, num_groups, op)
    return outs


def _host_fast_aggregate(frame, keys, seg_info, out_names, device):
    """The segment fast path over a (forced) frame: gather value columns,
    encode group keys on the host (:func:`~tensorframes_tpu_torch.ops.keys.frame_group_ids`
    — lexicographic group order, as in the reference), one vectorized
    segment reduction on the device. Returns
    ``(out_key_cols, out_cols, n_rows)``."""
    from .keys import frame_group_ids

    val_cols = {}
    for x in out_names:
        vals = frame.column_values(x)
        if vals.dtype == object:
            raise ValueError(
                f"Column {x!r} is ragged; aggregate requires uniform "
                "cells (run analyze() first)."
            )
        val_cols[x] = vals
    seg_ids, group_key_cols, num_groups = frame_group_ids(frame, keys)
    ops_key = tuple((out_name, op) for out_name, op, _ in seg_info)
    out_cols = _segment_reduce_best(ops_key, num_groups, val_cols, seg_ids, device)
    return dict(zip(keys, group_key_cols)), out_cols, len(seg_ids)


def aggregate(
    fetches: Fetches, grouped: GroupedData, device=None
) -> "TensorFrame":
    """Algebraic aggregation over grouped data: one output row per key.

    ≙ ``tfs.aggregate`` (core.py:401-419) → DebugRowOps.aggregate via
    ``TensorFlowUDAF`` (DebugRowOps.scala:554-599, 608-702). Fetches follow
    the ``x`` / ``x_input`` naming contract, like reduce_blocks.

    Keys encode to dense group ids on the host (value columns are never
    reordered), and the fetches — DSL ``reduce_sum/min/max/mean`` reducers
    over placeholders — lower to one segment reduction on the device fed
    UNSORTED ids. Other (non-algebraic) fetches need the generic UDAF path,
    which this port does not have yet.
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
    if not algebraic:
        raise NotImplementedError(
            "aggregate with non-algebraic fetches (the generic UDAF "
            "compaction path) is not ported yet; see ROADMAP.md, queue 1, "
            "'Generic aggregate'. Use reduce_sum/min/max/mean DSL fetches."
        )
    schema = Schema(_agg_schema_infos(frame.schema, keys, program))
    if frame.num_rows == 0:
        profiling.record("aggregate", time.perf_counter() - t0, 0)
        return TensorFrame(_empty_agg_blocks(schema), schema)
    out_key_cols, out_cols, n = _host_fast_aggregate(
        frame, keys, seg_info, out_names, dev
    )
    block: Block = dict(out_key_cols)
    for o in program.outputs:
        block[o.name] = out_cols[o.name]
    profiling.record("aggregate", time.perf_counter() - t0, n)
    return TensorFrame([block], schema)
