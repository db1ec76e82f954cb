"""Ragged row gather — device-side staging for ragged ``map_rows``.

Replaces ``tensorframes_tpu/kernels/ragged_gather.py::ragged_gather_rows``
(the Pallas TPU kernel: a sequential grid over the rows of one shape
group, each row's slice DMA'd out of the flat HBM buffer at a
scalar-prefetched int32 start offset). The ragged ``map_rows`` path moves
the column's cells to the device ONCE as a flat concatenation, and the
shape groups' padded ``[g_i, length_i]`` batches are gathered there — no
per-group host stack and transfer.

The CUDA kernel is ``csrc/ragged_gather.cu``. It gathers every group of a
call in one launch: threads map onto the output's 16-byte chunks (every
lane busy whatever the row length), misaligned rows (and the row ends of
1- and 2-byte elements) are read by aligned 16-byte loads shifted into
place, and a small device table
(:func:`plan_launches`) tells a block which groups its chunks belong to.
The table and every group's starts go up in one host→device copy. One
launch covers consecutive groups whose padded outputs total at most
:data:`LAUNCH_BUDGET_BYTES`; past it, the next launch follows
(:func:`launch_groups`), so a caller that consumes a launch's groups
before the next one bounds its peak device memory. What bounds the kernel
on the H100 is bytes (each gathered byte read once and written once).
Pure data movement, so it is bit-exact against the plain version
(:func:`gather_plain`). Offsets stay int32, as in the reference: the flat
buffer holds fewer than 2^31 elements (the verb checks this and stages on
the host otherwise).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import check, launch_target, library

_INT32_MAX = np.iinfo(np.int32).max
_CHUNK = 16  # bytes of output a kernel thread moves at once; groups start on one
LAUNCH_BUDGET_BYTES = 256 << 20  # padded output bytes one launch may cover


def gather_plain(flat: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """Plain PyTorch version: rows ``flat[s : s + length]`` for each start,
    by advanced indexing."""
    idx = starts.long()[:, None] + torch.arange(length, device=flat.device)
    return flat[idx]


def _padded_bytes(rows: int, length: int, elem_size: int) -> int:
    return -(-rows * length * elem_size // _CHUNK) * _CHUNK


def launch_groups(sizes: Sequence[Tuple[int, int]], elem_size: int) -> List[List[int]]:
    """The indices of the groups each launch covers, in order, for groups of
    ``(rows, length)``: consecutive groups whose outputs, each padded to 16
    bytes, total at most :data:`LAUNCH_BUDGET_BYTES` (a group past the budget
    alone gets a launch of its own). Groups of no rows take no launch."""
    launches: List[List[int]] = []
    cur: List[int] = []
    used = 0
    for i, (rows, length) in enumerate(sizes):
        if rows == 0:
            continue
        nb = _padded_bytes(rows, length, elem_size)
        if cur and used + nb > LAUNCH_BUDGET_BYTES:
            launches.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += nb
    if cur:
        launches.append(cur)
    return launches


@dataclasses.dataclass
class GatherLaunch:
    """One launch's device table and starts (views of one upload) and, on
    the host, its groups ``(index in the call, rows, length)``."""

    table: torch.Tensor   # [len(groups), 4] int64: chunk0, starts offset, rows, row bytes
    starts: torch.Tensor  # int32 starts of this launch's groups, back to back
    groups: List[Tuple[int, int, int]]
    chunks: int           # 16-byte output chunks of the launch


def _host_starts(starts, length: int, total: int) -> np.ndarray:
    st = np.asarray(starts)
    if st.size and (st.min() < 0 or int(st.max()) + length > total):
        raise ValueError(
            f"ragged_gather: a start offset plus length {length} "
            f"falls outside the flat buffer of {total} elements"
        )
    return st.astype(np.int32, copy=False).reshape(-1)


def plan_launches(flat: torch.Tensor, groups: Sequence[Tuple[object, int]]) -> List[GatherLaunch]:
    """Checks ``groups`` (``(starts, length)`` pairs; starts a numpy array or
    an int32 tensor of element offsets into the 1-D ``flat``), splits them
    into launches (:func:`launch_groups`) and moves every launch's table
    and starts to ``flat``'s device. Host starts are bounds-checked and go
    up with the tables in ONE host→device copy (from pinned memory on a
    GPU); starts already on the device are joined there."""
    if flat.ndim != 1:
        raise ValueError("ragged_gather: flat must be 1-D")
    total = int(flat.shape[0])
    if total > _INT32_MAX:
        raise ValueError("ragged_gather: flat buffer past 2^31 elements")
    es = flat.element_size()
    host, sizes = [], []
    for starts, length in groups:
        length = int(length)
        if length < 1:
            raise ValueError(
                f"ragged_gather needs length >= 1, got {length} "
                "(zero-length cells stay on the host stack path)"
            )
        if torch.is_tensor(starts):
            host.append(None)
            sizes.append((int(starts.numel()), length))
        else:
            st = _host_starts(starts, length, total)
            host.append(st)
            sizes.append((int(st.shape[0]), length))
    plans = launch_groups(sizes, es)
    # one host buffer: every launch's table (int64), then every host start
    n_tables = sum(len(p) for p in plans)
    n_host = sum(sizes[i][0] for p in plans for i in p if host[i] is not None)
    buf = np.empty(8 * n_tables + n_host, np.int32)
    tables = buf[: 8 * n_tables].view(np.int64).reshape(n_tables, 4)
    host_flat = buf[8 * n_tables:]
    t_row = h_off = 0
    chunks = []  # per launch
    for p in plans:
        chunk0 = off = 0  # a group's first chunk and first start within its launch
        for i in p:
            rows, length = sizes[i]
            tables[t_row] = (chunk0, off, rows, length * es)
            if host[i] is not None:
                host_flat[h_off:h_off + rows] = host[i]
                h_off += rows
            chunk0 += _padded_bytes(rows, length, es) // _CHUNK
            off += rows
            t_row += 1
        chunks.append(chunk0)
    dev = flat.device
    up = torch.from_numpy(buf)
    if dev.type == "cuda":
        up = up.pin_memory().to(dev, non_blocking=True)
    dev_tables = up[: 8 * n_tables].view(torch.int64).reshape(n_tables, 4)
    dev_host = up[8 * n_tables:]
    out: List[GatherLaunch] = []
    t_row = h_off = 0
    for p, n_chunks in zip(plans, chunks):
        if all(host[i] is not None for i in p):  # back to back in the upload already
            n = sum(sizes[i][0] for i in p)
            starts = dev_host[h_off:h_off + n]
            h_off += n
        else:
            parts = []
            for i in p:
                if host[i] is not None:
                    parts.append(dev_host[h_off:h_off + sizes[i][0]])
                    h_off += sizes[i][0]
                else:
                    parts.append(groups[i][0].to(device=dev, dtype=torch.int32).reshape(-1))
            starts = torch.cat(parts)
        out.append(GatherLaunch(dev_tables[t_row:t_row + len(p)], starts,
                                [(i, *sizes[i]) for i in p], n_chunks))
        t_row += len(p)
    return out


def gather_launch(flat: torch.Tensor, launch: GatherLaunch) -> List[torch.Tensor]:
    """Run one launch of :func:`plan_launches`: one ``[rows, length]`` tensor
    per group, views of one output buffer. CUDA tensors launch the kernel
    (counted once); CPU tensors compute :func:`gather_plain` per group."""
    if flat.device.type == "cpu":
        outs, off = [], 0
        for _, rows, length in launch.groups:
            outs.append(gather_plain(flat, launch.starts[off:off + rows], length))
            off += rows
        return outs
    if not flat.is_contiguous():
        raise ValueError("ragged_gather: flat must be contiguous")
    es = flat.element_size()
    if es not in (1, 2, 4, 8, 16):
        raise ValueError(f"ragged_gather: elements of {es} bytes are not supported")
    buf = torch.empty(launch.chunks * _CHUNK, dtype=torch.uint8, device=flat.device)
    rc = library().tft_ragged_gather(
        flat.data_ptr(), int(flat.shape[0]) * es, launch.starts.data_ptr(),
        launch.table.data_ptr(), len(launch.groups), launch.chunks, es, buf.data_ptr(),
        *launch_target(flat.device),
    )
    check("ragged_gather", rc)
    outs, chunk0 = [], 0
    for _, rows, length in launch.groups:
        nb = rows * length * es
        outs.append(buf[chunk0 * _CHUNK:chunk0 * _CHUNK + nb].view(flat.dtype).view(rows, length))
        chunk0 += _padded_bytes(rows, length, es) // _CHUNK
    return outs


def ragged_gather_groups(flat: torch.Tensor, groups: Sequence[Tuple[object, int]]) -> List[torch.Tensor]:
    """Gather every group ``(starts, length)`` from the 1-D ``flat`` into a
    dense ``[len(starts), length]`` tensor on ``flat``'s device, one per
    group in order. Starts are int32 element offsets (numpy or a tensor);
    rows may overlap — padding rows reuse offset 0. The groups take one
    launch, or one per :data:`LAUNCH_BUDGET_BYTES` of padded output. CUDA
    tensors launch the kernel, CPU tensors compute :func:`gather_plain`."""
    outs: List[torch.Tensor] = [None] * len(groups)  # type: ignore[list-item]
    for launch in plan_launches(flat, groups):
        for (i, _, _), got in zip(launch.groups, gather_launch(flat, launch)):
            outs[i] = got
    for i, (starts, length) in enumerate(groups):
        if outs[i] is None:  # a group of no rows
            outs[i] = torch.empty((0, int(length)), dtype=flat.dtype, device=flat.device)
    return outs


def ragged_gather_rows(flat: torch.Tensor, starts, length: int) -> torch.Tensor:
    """Gather ``g`` rows of ``length`` elements from the 1-D ``flat`` into a
    dense ``[g, length]`` tensor: :func:`ragged_gather_groups` for one
    group."""
    return ragged_gather_groups(flat, [(starts, length)])[0]
