"""Fused multi-op segment reduce — every (column, op) fetch of a keyed
``aggregate`` in one kernel call.

Replaces ``tensorframes_tpu/kernels/segment_reduce.py::segment_reduce_pallas``
(the Pallas TPU kernel: a sequential grid of row tiles, sums as a one-hot
``[tile, segments]`` MXU contraction, min/max as masked reductions). The
CUDA kernel is ``csrc/segment_reduce.cu``; its source note gives the
design. In short: what bounds it on the H100 is bytes (each id and value
read once); it reads them in one coalesced pass — :func:`num_chunks` row
chunks, each streamed by bulk copies into a block whose warps own the
segments and fold their rows into a shared-memory table in row order —
then folds the chunks' tables in chunk order (a second launch). No float
atomics: the order of every float sum depends on (n, chunks) alone, and
:func:`segment_sum_in_kernel_order` reproduces it on the CPU bit for bit.

Semantics, shared with the TPU kernel: sum/mean of float32/bfloat16
accumulate in f32; sum/mean of int32/int16/int8/uint8/bool accumulate in
a wrapping 32-bit integer; min/max are exact, seeded with the dtype
identities (empty segments read the identity); means divide by an i32
count table. The finalize step — ``s.astype(dt)`` for sums,
``(s / c).astype(dt)`` for means — runs in PyTorch on the kernel's raw
table (:func:`_finalize`), exactly as the TPU path runs it outside its
kernel.

Eligibility (re-derived for this kernel; the TPU bounds were VMEM
budgets): the dtype/op set above, 1-D or 2-D values of any inner width,
at most :data:`MAX_SEGMENTS` (4096) segments, at most :data:`MAX_COLS`
(16) columns, and fewer than 2^31 rows. The kernel folds the table's
lanes in groups whose ``[S, lanes]`` table fits in shared memory (128 KB),
one pass over the rows per group, and a column wider than a group in
slices, so any width is served.

:func:`segment_reduce` launches the kernel for CUDA tensors and computes
:func:`segment_reduce_plain` (the plain PyTorch version) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import check, launch_target, library

MAX_SEGMENTS = 4096
MAX_COLS = 16
MAX_ROWS = 2**31 - 1

_FLOAT_OK = ("float32", "bfloat16")
_INT_OK = ("int32", "int16", "int8", "uint8", "bool")
_OPS = ("reduce_sum", "reduce_mean", "reduce_min", "reduce_max")
# codes shared with csrc/segment_reduce.cu (enum DType / enum Op)
_DTYPE_CODE = {"float32": 0, "bfloat16": 1, "int32": 2, "int16": 3,
               "int8": 4, "uint8": 5, "bool": 6}
_OP_CODE = {"reduce_sum": 0, "reduce_mean": 1, "reduce_min": 2, "reduce_max": 3}
_IDENTITY = {  # min/max seeds of the integer types, as in the TPU kernel
    "int32": (2**31 - 1, -(2**31)), "int16": (32767, -32768),
    "int8": (127, -128), "uint8": (255, 0), "bool": (1, 0),
}

__all__ = ["eligible", "segment_reduce", "segment_reduce_plain", "segment_reduce_tables",
           "segment_sum_in_kernel_order", "num_chunks", "chunk_starts", "MAX_SEGMENTS"]


def dtype_name(v) -> str:
    """The name of a tensor's or array's dtype (``float32``, ``int16``, …)."""
    if torch.is_tensor(v):
        return str(v.dtype).removeprefix("torch.")
    return str(v.dtype)


def _col_meta(ops_key, val_cols) -> Tuple[Tuple[str, str, int, int, str], ...]:
    """Per-column (name, dtype, inner dim, ndim, op)."""
    meta = []
    for x, op in ops_key:
        v = val_cols[x]
        ndim = int(v.ndim)
        d = 1 if ndim == 1 else int(v.shape[1])
        meta.append((x, dtype_name(v), d, ndim, op))
    return tuple(meta)


def _lanes(meta) -> int:
    return sum(d for _, _, d, _, _ in meta) + int(
        any(op == "reduce_mean" for *_, op in meta)
    )


def eligible(ops_key, val_cols, num_segments: int) -> bool:
    """True when the fused kernel serves this keyed reduction: bounded
    segment, column and row counts, and 1-D/2-D values of a supported
    dtype."""
    if not 0 < num_segments <= MAX_SEGMENTS or not 0 < len(ops_key) <= MAX_COLS:
        return False
    for x, op in ops_key:
        v = val_cols[x]
        if op not in _OPS or v.ndim not in (1, 2) or int(v.shape[0]) > MAX_ROWS:
            return False
        if dtype_name(v) not in _FLOAT_OK + _INT_OK:
            return False
    return True


def _inexact(t: torch.dtype) -> torch.dtype:
    # the float type an integer true division computes in (the reference
    # package's promotion: int64 -> float64, narrower ints/bool -> float32)
    return torch.float64 if t == torch.int64 else torch.float32


def _finalize(meta, raw: Dict[str, torch.Tensor], counts) -> Dict[str, torch.Tensor]:
    """Cast the raw [S, d] tables to the fetch dtypes: ``s.astype(dt)``
    for sums, ``(s / c).astype(dt)`` for means, the exact min/max as
    they are; 1-D columns come back 1-D."""
    out = {}
    for x, name, _, ndim, op in meta:
        t = getattr(torch, name)
        p = raw[x]
        if op == "reduce_mean":
            s = p.to(t)
            c = counts[:, None].to(t)
            if not s.is_floating_point():
                s, c = s.to(_inexact(t)), c.to(_inexact(t))
            r = (s / c).to(t)
        else:
            r = p.to(t)
        out[x] = r[:, 0] if ndim == 1 else r
    return out


def segment_reduce_plain(
    ops_key, num_segments: int, val_cols, seg_ids
) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the kernel: the same raw tables (f32
    or wrapping-i32 sums, exact min/max from the identities, i32 counts)
    through torch scatter ops, then the same :func:`_finalize`."""
    meta = _col_meta(ops_key, val_cols)
    ids = seg_ids.long()
    n = int(ids.shape[0])
    raw = {}
    for x, name, d, _, op in meta:
        v = val_cols[x].reshape(n, d)
        is_float = name in _FLOAT_OK
        if op in ("reduce_sum", "reduce_mean"):
            if is_float:
                acc = torch.zeros((num_segments, d), dtype=torch.float32, device=v.device)
                raw[x] = acc.index_add_(0, ids, v.float())
            else:
                acc = torch.zeros((num_segments, d), dtype=torch.int64, device=v.device)
                # int64 sums truncated to 32 bits == the wrapping i32 sum
                raw[x] = acc.index_add_(0, ids, v.long()).to(torch.int32)
        else:
            mn = op == "reduce_min"
            work = torch.float32 if is_float else torch.int32
            ident = (float("inf") if mn else float("-inf")) if is_float else _IDENTITY[name][0 if mn else 1]
            acc = torch.full((num_segments, d), ident, dtype=work, device=v.device)
            raw[x] = acc.scatter_reduce_(
                0, ids[:, None].expand(n, d), v.to(work),
                reduce="amin" if mn else "amax", include_self=True,
            )
    counts = None
    if any(op == "reduce_mean" for *_, op in meta):
        counts = torch.bincount(ids, minlength=num_segments).to(torch.int32)
    return _finalize(meta, raw, counts)


MAX_CHUNKS = 132             # row chunks at most: one per SM of an H100, a constant
MIN_CHUNK_ROWS = 2048        # rows per chunk at least
MAX_PARTIAL_WORDS = 1 << 24  # the chunks' [chunks, S, lanes] partials, 64 MiB at most


def num_chunks(n: int, num_segments: int, lanes: int) -> int:
    """Row chunks of the kernel for ``n`` rows and an ``[S, lanes]`` table:
    a function of the feed alone (not of the card), so the order of its
    sums, and hence their bits, is the same on every card."""
    return max(1, min(MAX_CHUNKS, -(-n // MIN_CHUNK_ROWS),
                      MAX_PARTIAL_WORDS // (num_segments * lanes)))


def chunk_starts(n: int, chunks: int) -> list:
    """The chunks' first rows, and ``n`` last: multiples of 16 (as
    ``chunk_lo`` in ``csrc/segment_reduce.cu``)."""
    n16 = -(-n // 16)
    return [min(n, 16 * (n16 * c // chunks)) for c in range(chunks + 1)]


def scratch_for(chunks: int, num_segments: int, lanes: int, device) -> torch.Tensor:
    """The kernel's scratch: the chunks' partial tables, 32-bit words
    (none needed for one chunk, which writes the output itself)."""
    words = chunks * num_segments * lanes if chunks > 1 else 1
    return torch.empty(words, dtype=torch.int32, device=device)


def segment_sum_in_kernel_order(values: torch.Tensor, seg_ids: torch.Tensor,
                                num_segments: int, chunks: int) -> torch.Tensor:
    """The kernel's f32 sum of ``[n, d]`` (or ``[n]``) values by segment,
    computed on the CPU in the kernel's order: in each chunk of
    :func:`chunk_starts`, every segment's rows added one by one in row
    order to 0 (``index_add_`` on the CPU adds in index order), then the
    chunks' tables added in chunk order. Ids outside ``[0, S)`` match
    nothing. Equal bit for bit to the kernel's sums and means' sums."""
    n = int(seg_ids.shape[0])
    v = values.detach().to("cpu", torch.float32).reshape(n, -1)
    ids = seg_ids.detach().to("cpu", torch.int64)
    out = None
    bounds = chunk_starts(n, chunks)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        i, x = ids[lo:hi], v[lo:hi]
        keep = (i >= 0) & (i < num_segments)
        part = torch.zeros((num_segments, v.shape[1])).index_add_(0, i[keep], x[keep])
        out = part if out is None else out + part
    return out


def segment_reduce_tables(ops_key, num_segments, val_cols, seg_ids):
    """Launch the kernel on CUDA tensors and return its raw tables before
    the finalize: ``({name: [S, d] f32 or i32 table}, i32 counts or None)``.
    Counts come back when a mean is among the ops. An ineligible feed or
    a CPU tensor raises."""
    if not eligible(ops_key, val_cols, num_segments):
        raise ValueError(
            "segment_reduce: feed not eligible for the kernel (dtype/op set, "
            f"1-D/2-D values, <= {MAX_SEGMENTS} segments, <= {MAX_COLS} columns, < 2^31 rows)"
        )
    if seg_ids.device.type == "cpu":
        raise ValueError("segment_reduce_tables: the kernel runs on CUDA tensors only")
    meta = _col_meta(ops_key, val_cols)
    device = seg_ids.device
    n = int(seg_ids.shape[0])
    if seg_ids.dtype != torch.int32 or seg_ids.ndim != 1 or not seg_ids.is_contiguous():
        raise ValueError("segment_reduce: seg_ids must be a contiguous 1-D int32 tensor")
    for x, _, _, _, _ in meta:
        v = val_cols[x]
        if v.device != device or not v.is_contiguous() or int(v.shape[0]) != n:
            raise ValueError(
                f"segment_reduce: column {x!r} must be a contiguous tensor on "
                f"{device} with {n} rows"
            )
    need_counts = any(op == "reduce_mean" for *_, op in meta)
    lanes = _lanes(meta)
    chunks = num_chunks(n, num_segments, lanes)
    scratch = scratch_for(chunks, num_segments, lanes, device)
    out = torch.empty((num_segments, lanes), dtype=torch.int32, device=device)
    k = len(meta)
    vals = (ctypes.c_void_p * k)(*[val_cols[x].data_ptr() for x, *_ in meta])
    codes = (ctypes.c_int * k)(*[_DTYPE_CODE[m[1]] for m in meta])
    ops = (ctypes.c_int * k)(*[_OP_CODE[m[4]] for m in meta])
    ds = (ctypes.c_int * k)(*[m[2] for m in meta])
    rc = library().tft_segment_reduce(
        seg_ids.data_ptr(), n, num_segments, k, vals, codes, ops, ds,
        int(need_counts), chunks, scratch.data_ptr(), out.data_ptr(),
        *launch_target(device),
    )
    check("segment_reduce", rc)
    raw, lane = {}, 0
    for x, name, d, _, op in meta:
        words = out[:, lane:lane + d]
        # float sums and float min/max travel as f32 bits, the rest as i32
        raw[x] = words.view(torch.float32) if name in _FLOAT_OK else words
        lane += d
    return raw, (out[:, lane] if need_counts else None)


def segment_reduce(
    ops_key, num_segments: int, val_cols, seg_ids
) -> Dict[str, torch.Tensor]:
    """Every (name, op) of ``ops_key`` over ``val_cols`` (1-D/2-D tensors,
    rows aligned with the int32 ``seg_ids``). CUDA tensors launch the
    kernel; CPU tensors compute the plain version. Callers gate
    :func:`eligible` first; an ineligible CUDA feed raises."""
    if seg_ids.device.type == "cpu":
        return segment_reduce_plain(ops_key, num_segments, val_cols, seg_ids)
    return _finalize(_col_meta(ops_key, val_cols),
                     *segment_reduce_tables(ops_key, num_segments, val_cols, seg_ids))

