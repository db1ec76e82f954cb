"""Single-op segment reductions for the per-op ``aggregate`` route.

Replaces ``tensorframes_tpu/ops/segment.py``: its ``segment_sum_pallas``
(a one-hot ``[tile, segments]`` MXU contraction over a sequential grid of
256-row tiles) becomes :func:`segment_sum_kernel`, a single-op launch of
the segment-reduce CUDA kernel (``csrc/segment_reduce.cu``, entry point
``tft_segment_sum``): f32/bf16 values ``[n, d]`` → f32 ``[S, d]``,
deterministic per feed (each chunk's rows added in row order, then the
chunks in order: ``kernels.segment_reduce.segment_sum_in_kernel_order``),
bounded by bytes (ids and values read once in one coalesced pass, the
table written once). It keeps its own C entry point, wrapper and launch
count.

:func:`segment_sum` dispatches like the reference's: the kernel for
1-D/2-D float32/bfloat16 values and at most ``MAX_SEGMENTS`` segments
(cast back to the values' dtype), and otherwise — float16, int64,
float64, more segments — PyTorch's ``index_add_``. Floats accumulate
there in float32 (float64 for float64 values) and are cast back once, as
the reference's CPU route accumulates in float64 (``np.bincount``):
a float16 or bfloat16 accumulator stops growing once the sum outgrows
its step. Integers and bools add in their own dtype, wrapping as
``jax.ops.segment_sum`` does.
"""

from __future__ import annotations

import torch

from .. import kernels as _k
from ..kernels.segment_reduce import MAX_ROWS, MAX_SEGMENTS, num_chunks, scratch_for

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def segment_sum_plain(values: torch.Tensor, seg_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 ``index_add_`` of
    ``[n, d]`` values into ``[S, d]``."""
    out = torch.zeros((num_segments, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    return out.index_add_(0, seg_ids.long(), values.float())


def _kernel_eligible(values: torch.Tensor, num_segments: int) -> bool:
    return (
        values.ndim == 2
        and values.dtype in _DTYPE_CODE
        and 0 < num_segments <= MAX_SEGMENTS
        and int(values.shape[0]) <= MAX_ROWS
    )


def segment_sum_kernel(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum of ``[n, d]`` float32/bfloat16 values into f32
    ``[num_segments, d]``; ids are int32 in any order (ids outside
    ``[0, num_segments)`` match nothing). CUDA tensors launch the kernel,
    CPU tensors compute :func:`segment_sum_plain`."""
    if seg_ids.device.type == "cpu":
        return segment_sum_plain(values, seg_ids, num_segments)
    if not _kernel_eligible(values, num_segments):
        raise ValueError(
            "segment_sum_kernel: needs [n, d] float32/bfloat16 values and "
            f"0 < num_segments <= {MAX_SEGMENTS} (and < 2^31 rows)"
        )
    device = seg_ids.device
    n, d = int(values.shape[0]), int(values.shape[1])
    if (seg_ids.dtype != torch.int32 or seg_ids.ndim != 1 or int(seg_ids.shape[0]) != n
            or not seg_ids.is_contiguous()):
        raise ValueError("segment_sum_kernel: seg_ids must be contiguous int32 [n]")
    if values.device != device or not values.is_contiguous():
        raise ValueError(f"segment_sum_kernel: values must be contiguous on {device}")
    chunks = num_chunks(n, num_segments, d)
    scratch = scratch_for(chunks, num_segments, d, device)
    out = torch.empty((num_segments, d), dtype=torch.float32, device=device)
    rc = _k.library().tft_segment_sum(
        seg_ids.data_ptr(), n, num_segments, values.data_ptr(),
        _DTYPE_CODE[values.dtype], d, chunks, scratch.data_ptr(), out.data_ptr(),
        *_k.launch_target(device),
    )
    _k.check("segment_sum", rc)
    return out


def accumulator_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a segment sum of ``dtype`` values adds in: float64 for
    float64, float32 for the other floats, the dtype itself otherwise."""
    if dtype == torch.float64 or not dtype.is_floating_point:
        return dtype
    return torch.float32


def segment_total(values: torch.Tensor, seg_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Segment sum with kernel dispatch, left in
    :func:`accumulator_dtype` (not yet cast back to ``values.dtype``)."""
    v2 = values[:, None] if values.ndim == 1 else values
    if _kernel_eligible(v2, num_segments):
        out = segment_sum_kernel(v2.contiguous(), seg_ids, num_segments)
        return out[:, 0] if values.ndim == 1 else out
    acc = accumulator_dtype(values.dtype)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=acc,
                      device=values.device)
    return out.index_add_(0, seg_ids.long(), values.to(acc))


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment sum with kernel dispatch; result dtype matches ``values``
    (one cast from the accumulator)."""
    return segment_total(values, seg_ids, num_segments).to(values.dtype)


def _identity(dtype: torch.dtype, op: str):
    mn = op == "reduce_min"
    if dtype.is_floating_point:
        return float("inf") if mn else float("-inf")
    if dtype == torch.bool:
        return mn
    info = torch.iinfo(dtype)
    return info.max if mn else info.min


def segment_minmax(values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, op: str) -> torch.Tensor:
    """Segment min/max (``op`` is ``reduce_min``/``reduce_max``); empty
    segments read the dtype identity, as ``jax.ops.segment_min/max`` do."""
    work = torch.uint8 if values.dtype == torch.bool else values.dtype
    v = values.to(work)
    out = torch.full((num_segments,) + tuple(v.shape[1:]), _identity(values.dtype, op),
                     dtype=work, device=v.device)
    idx = seg_ids.long().reshape((-1,) + (1,) * (v.ndim - 1)).expand_as(v)
    out.scatter_reduce_(0, idx, v, reduce="amin" if op == "reduce_min" else "amax",
                        include_self=True)
    return out.to(values.dtype)
