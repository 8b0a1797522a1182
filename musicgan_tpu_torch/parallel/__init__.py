"""Parallelism layer: device meshes, the process group, row shardings and
multi-process bring-up (counterpart of ``musicgan_tpu/parallel``)."""

from .mesh import (
    Group,
    Mesh,
    data_sharding,
    initialize_distributed,
    make_mesh,
    replicated_sharding,
)

__all__ = [
    "Group",
    "Mesh",
    "data_sharding",
    "initialize_distributed",
    "make_mesh",
    "replicated_sharding",
]
