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
the frame uses ``dp`` alone.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import get_config

BATCH_AXIS = "dp"

__all__ = [
    "BATCH_AXIS", "Mesh", "NamedSharding", "PartitionSpec", "batch_sharding",
    "default_device", "device_count", "make_mesh", "mesh_descriptor",
    "replicated", "sharding_descriptor", "spec_descriptor",
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
