"""Data parallelism over ``torch.distributed`` (``mesh.py``); spatial sharding
(``spatial.py``, imported on use)."""

from .mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    Mesh2D,
    all_gather_objects,
    all_reduce_sum_,
    broadcast_object,
    broadcast_tensors_,
    data_parallel_size,
    init_distributed,
    is_main,
    make_mesh,
    make_mesh_2d,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "Mesh",
    "Mesh2D",
    "make_mesh",
    "make_mesh_2d",
    "shard_batch",
    "init_distributed",
    "data_parallel_size",
    "is_main",
    "all_reduce_sum_",
    "broadcast_tensors_",
    "broadcast_object",
    "all_gather_objects",
]
