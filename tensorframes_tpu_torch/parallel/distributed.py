"""Multi-process initialization: one process per device, over
``torch.distributed``.

The reference ships work to executors over Spark's cluster runtime, and
the JAX package runs one controller process per host over every local
chip. Here a rank is one process with one device (PyTorch's idiom): the
process group is the fleet, the rank's device holds its rows of a sharded
frame, and the verbs cross ranks through :mod:`.collectives`. NCCL carries
CUDA ranks and gloo CPU ranks; a caller may name the backend. With no
process group initialized every entry point here is a no-op and the world
is one rank on the caller's device (``config.device``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch

from ..config import get_config, resolve_device
from ..observability import context as obs_context
from ..resilience import fleet as _fleet
from ..resilience.faults import fault_point, register_site
from ..resilience.retry import RetryPolicy, retry_call
from ..utils import get_logger

logger = get_logger(__name__)

__all__ = [
    "init_distributed", "fleet_barrier", "is_multiprocess", "process_index",
    "process_count", "process_topology", "frame_from_process_local",
    "rank_device", "backend", "group_initialized", "shutdown_distributed",
    "axis_groups", "new_group",
]

# this process's rank device and fleet topology once init_distributed ran
_STATE: dict = {}  # lint: guarded (written by init/shutdown on the driving thread only)

register_site("distributed.init", "parallel.distributed.init_distributed handshake")


def group_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The default process group's backend ("nccl", "gloo"), or None."""
    if not group_initialized():
        return None
    import torch.distributed as dist

    return str(dist.get_backend())


def process_count() -> int:
    if not group_initialized():
        return 1
    import torch.distributed as dist

    return int(dist.get_world_size())


def process_index() -> int:
    if not group_initialized():
        return 0
    import torch.distributed as dist

    return int(dist.get_rank())


def is_multiprocess() -> bool:
    return process_count() > 1


def rank_device() -> torch.device:
    """This rank's device: the one :func:`init_distributed` bound, else
    ``config.device``."""
    dev = _STATE.get("device")
    return dev if dev is not None else torch.device(get_config().device)


def _default_rank_device(process_id: int, local_device_ids, device) -> torch.device:
    if device is not None:
        dev = resolve_device(device)
    elif local_device_ids:
        dev = resolve_device(torch.device("cuda", int(local_device_ids[0])))
    else:
        dev = resolve_device(None)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % max(1, torch.cuda.device_count()))
    return dev


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list] = None,
    retry: Optional[RetryPolicy] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Initialize the default process group if configured (arguments or
    env), binding this process to one device.

    Arguments default to torchrun's env vars: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator ``host:port``), ``WORLD_SIZE`` and
    ``RANK``. With neither arguments nor env this is a single-process
    no-op. The rank's device is ``device``, else CUDA device
    ``local_device_ids[0]``, else ``config.device`` (CUDA ranks without an
    index take ``cuda:<rank % device_count>``); a CUDA device with no GPU
    raises. ``backend`` defaults to NCCL for CUDA ranks and gloo for CPU
    ranks; a backend that fails to initialize raises (nothing switches to
    another). The handshake ends with one all-reduce on the rank's
    device, so a refused communicator (NCCL's duplicate-GPU check) raises
    here, not at the first verb.

    ``retry`` (a :class:`~tensorframes_tpu_torch.resilience.RetryPolicy`)
    re-attempts the handshake (workers racing a restarted coordinator);
    ``configure(dispatch_deadline_s=)`` bounds each attempt through the
    hung-dispatch watchdog.
    """
    if group_initialized():
        return
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        )
    if coordinator_address is None:
        logger.debug("init_distributed: single-process mode (no coordinator)")
        return
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    dev = _default_rank_device(process_id, local_device_ids, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = get_config().dispatch_deadline_s or 600.0

    def connect() -> None:
        import torch.distributed as dist

        fault_point("distributed.init")
        if group_initialized():
            # an abandoned (deadline-expired) attempt finished the handshake
            return
        _fleet.run_with_deadline(
            lambda: dist.init_process_group(
                backend,
                init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes),
                rank=int(process_id),
                timeout=datetime.timedelta(seconds=float(timeout)),
            ),
            describe="distributed.init",
            signal=False,
        )

    retry_call(connect, policy=retry, describe="distributed.init")
    _STATE["device"] = dev
    _STATE["topology"] = None
    from . import collectives

    # the first collective on the rank's device: NCCL makes its
    # communicator here, so a refused one raises from init_distributed
    collectives.barrier()
    _STATE["topology"] = _gather_topology()
    obs_context.bind(process_index=process_index(), num_processes=int(num_processes))
    logger.info(
        "init_distributed: process %d/%d on %s via %s (%s)",
        process_id, num_processes, dev, coordinator_address, backend,
    )


def axis_groups() -> dict:
    """The process groups made for mesh axes in this process group's
    life, keyed by their global ranks (``mesh.Mesh.group``); emptied with
    the process group."""
    return _STATE.setdefault("groups", {})


def new_group(ranks):
    """A process group over global ``ranks`` on the default backend (the
    whole world's group when ``ranks`` is every rank). Collective over
    the world: every rank makes every group, in the same order."""
    import torch.distributed as dist

    ranks = [int(r) for r in ranks]
    if ranks == list(range(process_count())):
        return dist.group.WORLD
    return dist.new_group(ranks)


def shutdown_distributed() -> None:
    """Destroy the default process group (a no-op without one)."""
    if group_initialized():
        import torch.distributed as dist

        dist.destroy_process_group()
    _STATE.clear()


def fleet_barrier(name: str = "sync", timeout: Optional[float] = None) -> None:
    """Host-side fleet barrier with a deadline: every rank of the fleet
    (``TFTPU_FLEET_DIR``) marks its arrival and waits for all peers — a
    missing rank raises
    :class:`~tensorframes_tpu_torch.resilience.fleet.HungDispatchError`
    naming the missing ranks instead of waiting forever. A no-op outside a
    rendezvous dir or alone, so it is safe to call unconditionally.
    ``timeout`` overrides the dispatch-deadline default."""
    _fleet.barrier(name, deadline=timeout)


def _device_identity(dev: torch.device):
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return "cpu", "cpu"


def _gather_topology() -> dict:
    """Every rank's (platform, device kind), gathered once at init, when
    every rank is in lockstep."""
    import pickle

    from . import collectives

    mine = _device_identity(rank_device())
    kinds = [pickle.loads(b) for b in collectives.allgather_bytes(pickle.dumps(mine))]
    return {
        "n_processes": len(kinds),
        "devices": [[r, p, k, r] for r, (p, k) in enumerate(kinds)],
    }


def process_topology() -> dict:
    """Process-index-independent identity of the fleet's devices, for
    compile-cache keys: the process count and, per global rank, ``[rank,
    platform, device kind, owning process]`` (the reference's fields; a
    rank owns one device). Every rank computes the same value; a resized
    fleet keys differently. Gathered once by :func:`init_distributed`;
    alone, this process's device."""
    topo = _STATE.get("topology")
    if topo is not None:
        return topo
    dev = rank_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        return {"n_processes": 1, "devices": [[0, "gpu", "?", 0]]}
    p, k = _device_identity(dev)
    return {"n_processes": 1, "devices": [[0, p, k, 0]]}


def frame_from_process_local(data, mesh=None, axis: Optional[str] = None):
    """Build a sharded frame from each rank's local rows.

    ≙ a Spark DataFrame whose partitions live on different executors:
    every rank passes its own ``{column: local rows}`` (equal schemas; row
    counts may differ) and receives a frame whose device columns are this
    rank's tensors on its device. Verbs on the result run across ranks
    through the process group, so every rank must call every verb in
    lockstep. Host-only columns (strings, ragged cells) stay
    process-local: each rank sees only its own rows; they can key an
    aggregate (the dictionary plan merges the ranks' dictionaries with a
    collective), and ``column_values`` raises the spans-processes error
    for them. ``num_rows`` is global (one all-reduce, cached)."""
    from .. import dtypes as dt
    from ..frame import TensorFrame, _cells_to_storage, _infer_column_info
    from ..schema import ColumnInfo, Schema
    from ..shape import Shape, Unknown
    from .mesh import make_mesh

    mesh = mesh or make_mesh()
    axis = axis or get_config().batch_axis
    dev = rank_device()
    block, host_block = {}, {}
    infos, host_infos = [], []
    n_local = None
    for name, v in data.items():
        if n_local is None:
            n_local = len(v)
        elif len(v) != n_local:
            raise ValueError(f"Column {name!r} has {len(v)} rows, expected {n_local}")
        if torch.is_tensor(v):
            # a tensor moves to the rank's device as it is (no host trip)
            info = ColumnInfo(name, dt.from_numpy(dt.to_numpy(v[:0]).dtype),
                              Shape(tuple(v.shape)).with_leading_unknown())
            block[name] = v.to(dev).contiguous()
            infos.append(info)
            continue
        if isinstance(v, np.ndarray) and v.dtype != object:
            dtype = dt.from_numpy(v.dtype)
            info = ColumnInfo(name, dtype, Shape(v.shape).with_leading_unknown())
            stored = v
        else:
            cells = list(v)
            info = _infer_column_info(name, cells) if cells else ColumnInfo(
                name, dt.string, Shape((Unknown,)))
            stored = _cells_to_storage(cells, info) if cells else []
            if isinstance(stored, np.ndarray):
                info = info.with_block_shape(Shape(stored.shape).with_leading_unknown())
        if isinstance(stored, np.ndarray) and info.is_device:
            block[name] = dt.to_torch(np.ascontiguousarray(stored), dev)
            infos.append(info)
        else:
            # strings and ragged cells stay process-local host lists
            host_block[name] = list(stored)
            host_infos.append(info)
    if not block:
        raise ValueError(
            "frame_from_process_local needs at least one device column "
            "(host-only columns cannot define the global row count)"
        )
    block.update(host_block)
    frame = TensorFrame([block], Schema(infos + host_infos))
    frame._mesh = mesh
    frame._axis = axis
    frame._process_local_cols = frozenset(host_block)
    return frame
