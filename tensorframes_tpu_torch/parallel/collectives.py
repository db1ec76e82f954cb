"""The collectives the data-parallel frame runs on, over ``torch.distributed``.

Counterparts of the reference's cross-device operations:

* :func:`all_reduce` (SUM, MIN, MAX) — ``lax.psum``/``pmin``/``pmax``;
* :func:`allgather_bytes` — ``multihost_utils.process_allgather`` of a
  pickled payload, in two phases (sizes, then padded ``uint8`` payloads);
* :func:`all_to_all_bytes` — the exchange's ``lax.all_to_all``, in padded
  ``uint8`` rounds of ``dist.all_to_all_single``;
* :func:`uniform_ok` — the eligibility vote every rank takes before a
  branch that enters further collectives.

Where a payload lives: the NCCL backend takes tensors on the rank's CUDA
device, so host payloads (the exchange's pickled bytes, as in the
reference) are copied there first. The gloo backend takes each tensor
where it is: host payloads stay on the host, and a CUDA table goes to
gloo as it is (PyTorch's gloo carries CUDA ``all_reduce``,
``all_gather``, ``all_to_all_single`` and ``broadcast``; a probe on the
H100's torch 2.11 ran all of them between two ranks on one card). Every call is bounded by the dispatch deadline
(``config.dispatch_deadline_s``, :func:`..resilience.fleet.run_with_deadline`).
With no process group initialized the world is one rank and each
function returns its input.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..resilience import fleet as _fleet
from . import distributed as _dist

__all__ = ["all_reduce", "allgather_bytes", "allgather_tensor", "all_to_all_bytes",
           "uniform_ok", "barrier"]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` where this backend's collectives take it: on the rank's CUDA
    device for NCCL, where it is for gloo."""
    if _dist.backend() == "nccl":
        t = t.to(_dist.rank_device())
    return t.contiguous()


def _ops(op: str):
    import torch.distributed as dist

    return {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
            "max": dist.ReduceOp.MAX}[op]


def _bounded(fn, describe: str):
    return _fleet.run_with_deadline(fn, describe=describe)


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over every rank by ``op`` ("sum", "min", "max"), on
    ``t``'s device. Bool tensors travel as uint8."""
    if not _dist.group_initialized():
        return t
    import torch.distributed as dist

    wire = _wire(t.to(torch.uint8) if t.dtype == torch.bool else t)
    if wire.data_ptr() == t.data_ptr():
        wire = wire.clone()  # never reduce the caller's tensor in place
    _bounded(lambda: dist.all_reduce(wire, op=_ops(op)), f"all_reduce[{op}]")
    return wire.to(t.device, t.dtype)


def allgather_tensor(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) stacked in rank order:
    ``[world, *t.shape]`` on ``t``'s device."""
    if not _dist.group_initialized():
        return t[None]
    import torch.distributed as dist

    wire = _wire(t)
    out = [torch.empty_like(wire) for _ in range(_dist.process_count())]
    _bounded(lambda: dist.all_gather(out, wire), "all_gather")
    return torch.stack(out).to(t.device)


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Every rank's ``payload`` in rank order: the sizes first (one int64
    a rank), then the payloads padded to the largest."""
    if not _dist.group_initialized():
        return [bytes(payload)]
    size = torch.tensor([len(payload)], dtype=torch.int64)
    sizes = allgather_tensor(size).reshape(-1).tolist()
    width = max(1, int(max(sizes)))
    buf = np.zeros(width, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    got = allgather_tensor(torch.from_numpy(buf)).cpu().numpy()
    return [got[r, : int(sizes[r])].tobytes() for r in range(len(sizes))]


def uniform_ok(ok: bool) -> bool:
    """Collective eligibility vote: True only when every rank voted True,
    so every rank takes the same branch before any further collective."""
    if not _dist.group_initialized():
        return bool(ok)
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
    return bool(int(all_reduce(flag, "min")[0]))


def barrier() -> None:
    """A collective barrier over the process group (an all-reduce of one
    int, which every backend carries)."""
    uniform_ok(True)


def all_to_all_bytes(
    parts: Sequence[bytes], round_bytes: int
) -> Tuple[List[bytes], dict]:
    """All-to-all of byte payloads: ``parts[dst]`` goes from this rank to
    ``dst``; returns ``(recv, stats)`` with ``recv[src]`` the payload
    ``src`` addressed here. One sizes allgather, then padded ``uint8``
    rounds of ``all_to_all_single``, each slot at most
    ``round_bytes // world`` wide (at least 64 KiB, at most the largest
    payload), so the buffers in flight stay bounded under a skewed key.
    ``stats``: bytes sent and received per peer, rounds, slot width, and
    the padded bytes each direction carried through ``all_to_all_single``."""
    import torch.distributed as dist

    procs = _dist.process_count()
    me = _dist.process_index()
    if len(parts) != procs:
        raise ValueError(f"all_to_all_bytes: {len(parts)} payloads for {procs} ranks")
    sizes = torch.tensor([len(b) for b in parts], dtype=torch.int64)
    all_sizes = allgather_tensor(sizes).reshape(procs, procs).numpy()
    max_size = int(all_sizes.max()) if all_sizes.size else 0
    chunk = max(1 << 16, round_bytes // max(procs, 1))
    chunk = min(chunk, max(1, max_size))
    rounds = max(1, -(-max_size // chunk))
    recv = [bytearray() for _ in range(procs)]
    for r in range(rounds):
        lo = r * chunk
        send = np.zeros((procs, chunk), np.uint8)
        for dst, b in enumerate(parts):
            seg = b[lo: lo + chunk]
            if seg:
                send[dst, : len(seg)] = np.frombuffer(seg, np.uint8)
        if _dist.group_initialized():
            src_t = _wire(torch.from_numpy(send.reshape(-1)))
            dst_t = torch.empty_like(src_t)
            _bounded(lambda: dist.all_to_all_single(dst_t, src_t),
                     "all_to_all_single")
            got = dst_t.cpu().numpy().reshape(procs, chunk)
        else:
            got = send
        for src in range(procs):
            take = min(chunk, int(all_sizes[src, me]) - lo)
            if take > 0:
                recv[src] += got[src, :take].tobytes()
    stats = {
        "sent": [int(s) for s in all_sizes[me]],
        "received": [int(all_sizes[src, me]) for src in range(procs)],
        "rounds": rounds,
        "chunk": chunk,
        "wire_bytes": rounds * procs * chunk,
    }
    return [bytes(b) for b in recv], stats
