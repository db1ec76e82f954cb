"""Meshes over the ranks of a process group, and axis conventions.

The reference package lays a frame out over a ``jax.sharding.Mesh`` of
the chips one controller drives. Here a rank is one process with one
device (PyTorch's idiom), so a :class:`Mesh` names axes and sizes over the
ranks of the default process group (:mod:`.distributed`); with no process
group the world is one rank on the caller's device.

Axis names, as in the reference:

* ``dp``  — data parallelism (a sharded frame splits its rows here)
* ``tp``  — tensor parallelism (model weights)
* ``sp``  — sequence/context parallelism (long-context attention)
* ``pp`` / ``ep`` — pipeline / expert parallelism

A multi-axis mesh is accepted when its sizes multiply to the world size;
the frame uses ``dp`` alone. The model-parallel code runs collectives
along axes: :meth:`Mesh.group` gives this rank the process group of the
ranks that differ from it only along the named axes, and
:func:`shard_tensor` / :func:`gather_tensor` cut a whole array into this
rank's block of a :class:`PartitionSpec` and put it back together (the
counterparts of ``jax.device_put`` onto a sharding and of reading a
sharded array whole).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import get_config, resolve_device

BATCH_AXIS = "dp"

__all__ = [
    "BATCH_AXIS", "Mesh", "NamedSharding", "PartitionSpec", "batch_sharding",
    "default_device", "device_count", "make_mesh", "mesh_descriptor",
    "replicated", "sharding_descriptor", "spec_descriptor", "shard_tensor",
    "gather_tensor",
]


class Mesh:
    """Named axes over global ranks: ``devices`` is an integer array of
    ranks shaped by the axis sizes (the reference's ``mesh.devices`` holds
    devices; a rank here owns exactly one), ``shape`` maps each axis name
    to its size."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str],
                 ranks: Sequence[int]):
        self.axis_names: Tuple[str, ...] = tuple(str(n) for n in names)
        self.devices = np.asarray(list(ranks), dtype=np.int64).reshape(
            tuple(int(s) for s in sizes))
        self.shape: Dict[str, int] = dict(
            zip(self.axis_names, (int(s) for s in sizes)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape!r}, ranks={self.devices.reshape(-1).tolist()})"

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh {self.shape} has no axis {a!r}")
        return axes

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Position of global ``rank`` (default: this process's) along each
        axis."""
        from . import distributed

        rank = distributed.process_index() if rank is None else int(rank)
        hit = np.argwhere(self.devices == rank)
        if len(hit) != 1:
            raise ValueError(f"rank {rank} is not on {self!r}")
        return dict(zip(self.axis_names, (int(i) for i in hit[0])))

    def axis_size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple of
        names; 1 for none)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes, rank: Optional[int] = None) -> int:
        """This rank's index along ``axes``, row-major over a tuple (as a
        dimension split ``P(("ep", "dp"))`` orders its blocks)."""
        c = self.coords(rank)
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def _lines(self, axes: Tuple[str, ...]):
        """Every group along ``axes``: the global ranks of each, ordered by
        :meth:`axis_index`; the groups in a fixed order."""
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        grid = np.transpose(self.devices, rest + order)
        return [tuple(int(r) for r in row) for row in
                grid.reshape(-1, math.prod(self.shape[a] for a in axes) if axes else 1)]

    def group_ranks(self, axes, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The global ranks that differ from ``rank`` (default: this
        process's) only along ``axes``, ordered by :meth:`axis_index`."""
        from . import distributed

        rank = distributed.process_index() if rank is None else int(rank)
        for line in self._lines(self._axes(axes)):
            if rank in line:
                return line
        raise ValueError(f"rank {rank} is not on {self!r}")

    def group(self, axes):
        """The process group of this rank's ranks along ``axes``, or None
        when that group is this rank alone (every collective over it is
        the identity). The first request for an axis set makes the groups
        of all its lines, in one fixed order, on every rank: every rank
        must ask for the same axis sets in the same order (as SPMD code
        does), since ``torch.distributed.new_group`` is collective over
        the world."""
        from . import distributed

        axes = self._axes(axes)
        if self.axis_size(axes) == 1:
            return None
        lines = self._lines(axes)
        groups = distributed.axis_groups()
        for line in lines:
            if line not in groups:
                groups[line] = distributed.new_group(line)
        return groups[self.group_ranks(axes)]


class PartitionSpec(tuple):
    """Per-dimension placement: an axis name, a tuple of names, or None
    (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec: how one column lays out over ranks."""

    mesh: Mesh
    spec: PartitionSpec


def _scrubbed(text: str) -> str:
    return re.sub(r"0x[0-9a-fA-F]+", "0x", text)


def mesh_descriptor(mesh: Mesh) -> Dict[str, object]:
    """JSON-able identity of a mesh for compile-cache keys, with the
    reference's field names: axis names and sizes, and the global rank
    of each position (the same on every rank)."""
    return {
        "axes": [[str(n), int(s)] for n, s in
                 zip(mesh.axis_names, mesh.devices.shape)],
        "devices": [int(d) for d in mesh.devices.flat],
    }


def spec_descriptor(spec) -> list:
    """PartitionSpec → JSON-able form: one entry per dim, each None, an
    axis name, or a list of axis names."""
    out = []
    for part in tuple(spec):
        if part is None:
            out.append(None)
        elif isinstance(part, (tuple, list)):
            out.append([str(p) for p in part])
        else:
            out.append(str(part))
    return out


def sharding_descriptor(sharding) -> Optional[Dict[str, object]]:
    """Stable JSON-able identity of an input's layout for dispatch keys and
    fingerprints — None for the trivial placement (no sharding, or this
    rank's own device), so plain dispatches keep their unsharded identity.
    A :class:`NamedSharding` gives its mesh and spec; a device other than
    this rank's gives ``{"type": "single", "device": index}``."""
    if sharding is None:
        return None
    if isinstance(sharding, (torch.device, str)):
        dev = torch.device(sharding)
        if dev == default_device():
            return None
        return {"type": "single", "device": int(dev.index or 0),
                "platform": dev.type}
    if isinstance(sharding, NamedSharding):
        return {
            "type": "named",
            "mesh": mesh_descriptor(sharding.mesh),
            "spec": spec_descriptor(sharding.spec),
        }
    return {"type": type(sharding).__name__, "repr": _scrubbed(repr(sharding))}


def default_device() -> torch.device:
    """This rank's device: the one :func:`.distributed.init_distributed`
    bound, else ``config.device`` (``cuda`` unless the caller configured
    the CPU)."""
    from . import distributed

    return distributed.rank_device()


def device_count() -> int:
    """The world size: one device per rank."""
    from . import distributed

    return distributed.process_count()


def make_mesh(
    axes: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a mesh. Default: a 1-D data-parallel mesh over every rank.

    ``axes`` maps axis name → size; one entry may be -1 meaning "all
    remaining ranks". Example: ``make_mesh({"dp": -1})`` or
    ``make_mesh({"dp": 2, "tp": 4})``. ``devices`` (global ranks) defaults
    to every rank of the world.
    """
    devices = list(devices) if devices is not None else list(range(device_count()))
    n = len(devices)
    if not axes:
        axes = {BATCH_AXIS: n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("At most one mesh axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known != 0:
            raise ValueError(
                f"Cannot infer -1 axis: {n} devices not divisible by {known}"
            )
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"Mesh axes {dict(zip(names, sizes))} need "
            f"{math.prod(sizes)} devices but {n} are available"
        )
    return Mesh(sizes, names, devices)


def batch_sharding(mesh: Mesh, rank: int, axis: Optional[str] = None) -> NamedSharding:
    """The frame layout: the leading (row) dim split over the batch axis,
    the rest replicated (≙ Spark row partitioning)."""
    axis = axis or get_config().batch_axis
    return NamedSharding(mesh, PartitionSpec(axis, *([None] * (rank - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def _dim_axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def shard_tensor(x, spec, mesh: Mesh, device=None, what: str = "array") -> torch.Tensor:
    """This rank's block of the whole array ``x`` (a tensor or numpy
    array) under ``spec``: each dimension split evenly over the axes its
    entry names (row-major over a tuple), the rest whole, as
    ``jax.device_put(x, NamedSharding(mesh, spec))`` lays it out. The
    block is a contiguous copy on ``device`` (default: this rank's). A
    dimension that does not divide raises."""
    if isinstance(spec, NamedSharding):
        spec = spec.spec
    t = x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
    index = []
    for dim, part in enumerate(tuple(spec or ())):
        axes = _dim_axes(part)
        n = mesh.axis_size(axes)
        size = int(t.shape[dim])
        if size % n:
            raise ValueError(
                f"{what}: dim {dim} of size {size} not divisible by mesh axis "
                f"{axes[0] if len(axes) == 1 else axes!r} of size {n}")
        i = mesh.axis_index(axes)
        index.append(slice(i * size // n, (i + 1) * size // n))
    block = t[tuple(index)]
    dev = resolve_device(default_device() if device is None else device)
    # always a copy: a trained shard must not alias the caller's array
    return torch.empty(block.shape, dtype=block.dtype, device=dev).copy_(block)


def gather_tensor(local: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole array from every rank's block under ``spec`` (the inverse
    of :func:`shard_tensor`), on ``local``'s device: one all-gather over
    the world, each rank's block placed at its coordinates (a replicated
    axis takes the first rank's copy). Collective: every rank calls it."""
    from . import collectives

    if isinstance(spec, NamedSharding):
        spec = spec.spec
    parts = tuple(spec or ())
    if not any(_dim_axes(p) for p in parts):
        return local
    blocks = collectives.allgather_tensor(local.contiguous())
    parts = parts + (None,) * (local.dim() - len(parts))
    out = torch.empty([int(n) * mesh.axis_size(_dim_axes(p)) for n, p in zip(local.shape, parts)],
                      dtype=local.dtype, device=local.device)
    done = set()
    for r in (int(x) for x in mesh.devices.flat):
        idx = tuple(mesh.axis_index(_dim_axes(p), rank=r) for p in parts)
        if idx not in done:
            done.add(idx)
            out[tuple(slice(i * int(n), (i + 1) * int(n))
                      for i, n in zip(idx, local.shape))] = blocks[r]
    return out
