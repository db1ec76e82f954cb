"""Multi-process execution over ``torch.distributed``: meshes over ranks
(:mod:`.mesh`), process-group initialization and the sharded frame's
constructor (:mod:`.distributed`), and the collectives the verbs cross
ranks with (:mod:`.collectives`). A rank is one process with one device.
The reference's pipeline helpers (``make_pp_train_step``,
``pipeline_apply``) come with the model-parallel slice."""

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

__all__ = [
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
