"""Ragged row gather — device-side staging for ragged ``map_rows``.

Replaces ``tensorframes_tpu/kernels/ragged_gather.py::ragged_gather_rows``
(the Pallas TPU kernel: a sequential grid over the rows of one shape
group, each row's slice DMA'd out of the flat HBM buffer at a
scalar-prefetched int32 start offset). The ragged ``map_rows`` path moves
the column's cells to the device ONCE as a flat concatenation, and each
shape group's padded ``[g, length]`` batch is gathered there — no per-group
host stack and transfer.

The CUDA kernel is ``csrc/ragged_gather.cu``: one warp per output row,
16-byte vector copies where the offset and length allow, else 4-byte or
byte copies. What bounds it on the H100 is bytes (each gathered byte read
once and written once). Pure data movement, so it is bit-exact against
the plain version (:func:`gather_plain`). Offsets stay int32, as in the
reference: the flat buffer holds fewer than 2^31 elements (the verb checks
this and stages on the host otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, launch_target, library

_INT32_MAX = np.iinfo(np.int32).max


def gather_plain(flat: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """Plain PyTorch version: rows ``flat[s : s + length]`` for each start,
    by advanced indexing."""
    idx = starts.long()[:, None] + torch.arange(length, device=flat.device)
    return flat[idx]


def ragged_gather_rows(flat: torch.Tensor, starts, length: int) -> torch.Tensor:
    """Gather ``g`` rows of ``length`` elements from the 1-D ``flat`` into a
    dense ``[g, length]`` tensor on ``flat``'s device. ``starts`` holds
    int32 element offsets (numpy or a tensor); rows may overlap — padding
    rows reuse offset 0. Host offsets are bounds-checked here. CUDA
    tensors launch the kernel, CPU tensors compute :func:`gather_plain`."""
    if length < 1:
        raise ValueError(
            f"ragged_gather_rows needs length >= 1, got {length} "
            "(zero-length cells stay on the host stack path)"
        )
    if flat.ndim != 1:
        raise ValueError("ragged_gather_rows: flat must be 1-D")
    total = int(flat.shape[0])
    if total > _INT32_MAX:
        raise ValueError("ragged_gather_rows: flat buffer past 2^31 elements")
    if not torch.is_tensor(starts):
        st = np.asarray(starts)
        if st.size and (st.min() < 0 or int(st.max()) + length > total):
            raise ValueError(
                f"ragged_gather_rows: a start offset plus length {length} "
                f"falls outside the flat buffer of {total} elements"
            )
        starts = torch.from_numpy(st.astype(np.int32))
    starts = starts.to(device=flat.device, dtype=torch.int32).contiguous()
    if flat.device.type == "cpu":
        return gather_plain(flat, starts, length)
    if not flat.is_contiguous():
        raise ValueError("ragged_gather_rows: flat must be contiguous")
    device = flat.device
    g = int(starts.shape[0])
    out = torch.empty((g, length), dtype=flat.dtype, device=device)
    if g == 0:
        return out
    rc = library().tft_ragged_gather(
        flat.data_ptr(), total, starts.data_ptr(), g, int(length),
        flat.element_size(), out.data_ptr(), *launch_target(device),
    )
    check("ragged_gather", rc)
    return out
