"""Single-op segment reductions for the per-op ``aggregate`` route.

Replaces ``tensorframes_tpu/ops/segment.py``: its ``segment_sum_pallas``
(a one-hot ``[tile, segments]`` MXU contraction over a sequential grid of
256-row tiles) becomes :func:`segment_sum_kernel`, a single-op launch of
the segment-reduce CUDA kernel (``csrc/segment_reduce.cu``, entry point
``tft_segment_sum``): f32/bf16 values ``[n, d]`` → f32 ``[S, d]``,
deterministic per feed, bounded by bytes (ids and values read once, the
table written once). It keeps its own C entry point, wrapper and launch
count.

:func:`segment_sum` dispatches like the reference's: the kernel for
1-D/2-D float32/bfloat16 values and at most ``MAX_SEGMENTS`` segments
(cast back to the values' dtype), and otherwise — int64, float64, more
segments — PyTorch's ``index_add_`` in the values' dtype, the counterpart
of the reference's ``jax.ops.segment_sum`` route. The reference's host
``np.bincount`` route (an XLA:CPU workaround) is not part of the port.
"""

from __future__ import annotations

import torch

from .. import kernels as _k
from ..kernels.segment_reduce import MAX_ROWS, MAX_SEGMENTS, _num_chunks, scratch_for

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
    chunks = _num_chunks(n, device)
    scratch = scratch_for(n, num_segments, chunks, device)
    out = torch.empty((num_segments, d), dtype=torch.float32, device=device)
    rc = _k.library().tft_segment_sum(
        seg_ids.data_ptr(), n, num_segments, values.data_ptr(),
        _DTYPE_CODE[values.dtype], d, chunks, scratch.data_ptr(), out.data_ptr(),
        *_k.launch_target(device),
    )
    _k.check("segment_sum", rc)
    return out


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment sum with kernel dispatch; result dtype matches ``values``."""
    v2 = values[:, None] if values.ndim == 1 else values
    if _kernel_eligible(v2, num_segments):
        out = segment_sum_kernel(v2.contiguous(), seg_ids, num_segments)
        if values.ndim == 1:
            out = out[:, 0]
        return out.to(values.dtype)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg_ids.long(), values)


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
