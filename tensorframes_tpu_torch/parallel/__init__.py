"""Multi-process execution over ``torch.distributed``: meshes over ranks
and the process groups of their axes (:mod:`.mesh`), process-group
initialization and the sharded frame's constructor (:mod:`.distributed`),
the collectives the verbs and the model-parallel code cross ranks with
(:mod:`.collectives`), and pipeline parallelism over a ``pp`` axis
(:mod:`.pipeline`: ``pipeline_apply``, ``make_pp_train_step``). A rank is
one process with one device."""

from .distributed import (
    fleet_barrier,
    frame_from_process_local,
    init_distributed,
    is_multiprocess,
    process_index,
    process_topology,
)
from .mesh import (
    BATCH_AXIS,
    batch_sharding,
    device_count,
    make_mesh,
    mesh_descriptor,
    replicated,
    sharding_descriptor,
)
from .pipeline import make_pp_train_step, pipeline_apply

__all__ = [
    "make_pp_train_step",
    "pipeline_apply",
    "BATCH_AXIS",
    "batch_sharding",
    "device_count",
    "fleet_barrier",
    "init_distributed",
    "is_multiprocess",
    "frame_from_process_local",
    "make_mesh",
    "mesh_descriptor",
    "process_index",
    "process_topology",
    "replicated",
    "sharding_descriptor",
]
