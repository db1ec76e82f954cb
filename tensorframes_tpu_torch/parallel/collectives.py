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

The model-parallel code crosses ranks along a mesh axis's group
(:meth:`.mesh.Mesh.group`) through differentiable collectives, each an
``autograd.Function`` whose backward is the transpose XLA gives the
reference's collective:

* :func:`ring_permute` — ``lax.ppermute`` by ``i → (i + shift) mod n``;
  its backward is the inverse permute. Built from ``all_to_all_single``
  with a split for the neighbour alone (under gloo a CUDA tensor crosses
  on a host copy: gloo's uneven split aborts on a device pointer);
* :func:`all_to_all` — ``lax.all_to_all(split_axis, concat_axis,
  tiled=True)``; its backward is the reverse exchange;
* :func:`copy_to_group` / :func:`reduce_from_group` — Megatron's f
  (identity forward, all-reduce backward) and g (all-reduce forward,
  identity backward);
* :func:`gather_along` — an all-gather along a dimension whose backward
  keeps this rank's slice of the summed gradient (a reduce-scatter).

:func:`allreduce_grads` sums a train step's gradients over the ranks
whose data differ.

A ``group`` of None is this rank alone: each is then the identity.
``COLLECTIVE_BYTES`` counts the bytes each kind sends from this rank.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..resilience import fleet as _fleet
from . import distributed as _dist

__all__ = ["all_reduce", "allgather_bytes", "allgather_tensor", "all_to_all_bytes",
           "uniform_ok", "barrier", "ring_permute", "all_to_all", "copy_to_group",
           "reduce_from_group", "gather_along", "group_all_reduce", "allreduce_grads",
           "COLLECTIVE_BYTES", "collective_bytes"]

COLLECTIVE_KINDS = ("permute", "all_to_all", "all_reduce", "all_gather", "broadcast")
# bytes this rank sent through the model-parallel collectives, by kind (kept
# out of the metrics registry, whose names are the reference package's)
COLLECTIVE_BYTES = {kind: 0 for kind in COLLECTIVE_KINDS}  # lint: guarded (_BYTES_LOCK)
_BYTES_LOCK = threading.Lock()


def _sent(kind: str, n: int) -> None:
    with _BYTES_LOCK:
        COLLECTIVE_BYTES[kind] += int(n)


def collective_bytes() -> dict:
    """``{kind: bytes}`` sent from this rank so far."""
    with _BYTES_LOCK:
        return dict(COLLECTIVE_BYTES)


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


# ---------------------------------------------------------------------------
# differentiable collectives over a mesh axis's group
# ---------------------------------------------------------------------------

def _size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else int(dist.get_world_size(group))


def _me(group) -> int:
    import torch.distributed as dist

    return 0 if group is None else int(dist.get_rank(group))


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    import torch.distributed as dist

    n, me = _size(group), _me(group)
    flat = _wire(x).reshape(-1)
    if flat.is_cuda and _dist.backend() == "gloo":
        # gloo's all_to_all_single with uneven splits hands the device
        # pointer to its TCP transport ("Bad address"; nccl_probe.py), so
        # the permute crosses on host copies
        flat = flat.cpu()
    out = torch.empty_like(flat)
    dst, src = (me + shift) % n, (me - shift) % n
    sends = [flat.numel() if r == dst else 0 for r in range(n)]
    recvs = [flat.numel() if r == src else 0 for r in range(n)]
    _bounded(lambda: dist.all_to_all_single(out, flat, recvs, sends, group=group),
             "ring_permute")
    _sent("permute", _nbytes(flat))
    return out.reshape(x.shape).to(x.device)


def _a2a(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    import torch.distributed as dist

    n = _size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size {x.shape[split_axis]} "
                         f"not divisible by the group's {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_axis))  # [n, ...chunk], chunk r to rank r
    send = _wire(send)
    recv = torch.empty_like(send)
    _bounded(lambda: dist.all_to_all_single(recv, send, group=group), "all_to_all")
    _sent("all_to_all", _nbytes(send) * (n - 1) // n)
    return torch.cat(recv.to(x.device).unbind(0), dim=concat_axis)


def group_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor; the input is kept)."""
    import torch.distributed as dist

    if group is None:
        return x
    wire = _wire(x)
    if wire.data_ptr() == x.data_ptr():
        wire = wire.clone()
    _bounded(lambda: dist.all_reduce(wire, group=group), "all_reduce")
    _sent("all_reduce", _nbytes(wire))
    return wire.to(x.device)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(_size(group))]
    _bounded(lambda: dist.all_gather(parts, wire, group=group), "all_gather")
    _sent("all_gather", _nbytes(wire))
    return torch.cat(parts, dim=dim).to(x.device)


def _broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    import torch.distributed as dist

    wire = _wire(x)
    if wire.data_ptr() == x.data_ptr():
        wire = wire.clone()
    src_global = dist.get_global_rank(group, src)
    _bounded(lambda: dist.broadcast(wire, src_global, group=group), "broadcast")
    if _me(group) == src:
        _sent("broadcast", _nbytes(wire))
    return wire.to(x.device)


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g.contiguous(), ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _a2a(g.contiguous(), ctx.group, concat_axis, split_axis), None, None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return group_all_reduce(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group_all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, int(x.shape[dim])
        return _all_gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        total = group_all_reduce(g.contiguous(), ctx.group)
        me = _me(ctx.group)
        return total.narrow(ctx.dim, me * ctx.n, ctx.n).contiguous(), None, None


def ring_permute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The tensor of the rank ``shift`` places back in ``group``'s order:
    rank ``i`` sends ``x`` to ``(i + shift) mod n`` (``lax.ppermute`` with
    ``perm=[(i, (i + shift) % n)]``). Differentiable: the gradient takes
    the inverse permute."""
    if group is None:
        return x
    return _RingPermute.apply(x, group, int(shift))


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` cut into the group's size of chunks along ``split_axis``, chunk
    ``r`` sent to rank ``r``, the chunks received joined along
    ``concat_axis`` in rank order. Differentiable: the gradient takes the
    reverse exchange."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, int(split_axis), int(concat_axis))


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f at the entry of a tensor-parallel region: the identity
    forward, the gradient summed over ``group`` backward."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g at the exit of a tensor-parallel region: ``x`` summed
    over ``group`` forward, the gradient passed through unchanged
    backward. (``torch.distributed.nn.functional.all_reduce`` sums the
    gradient too, which is not g.)"""
    if group is None:
        return x
    return _ReduceFromGroup.apply(x, group)


def gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` joined along ``dim`` in rank order.
    Differentiable: the gradient is summed over the group and this rank's
    slice kept (a reduce-scatter)."""
    if group is None:
        return x
    return _GatherAlong.apply(x, group, int(dim))


def allreduce_grads(leaves, group) -> None:
    """Sum every leaf's gradient over ``group`` in place: one all-reduce
    of a flat buffer a dtype (nothing for a group of this rank alone)."""
    if group is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for leaf in leaves:
        if leaf.grad is not None:
            by_dtype.setdefault(leaf.grad.dtype, []).append(leaf.grad)
    for grads in by_dtype.values():
        flat = group_all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
