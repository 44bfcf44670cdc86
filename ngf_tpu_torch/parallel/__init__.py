"""The parallel modes over ``torch.distributed``: ranks, meshes and batch
sharding (`mesh.py`), collectives with their gradients (`collectives.py`)
and the sample-parallel renderer (`sample_parallel.py`)."""

from .mesh import (
    Mesh,
    local_rank,
    make_mesh,
    make_mesh_2d,
    maybe_initialize_distributed,
    shard_batch,
)

__all__ = [
    "Mesh",
    "local_rank",
    "make_mesh",
    "make_mesh_2d",
    "maybe_initialize_distributed",
    "shard_batch",
]
