from gastx_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_reduce_sum,
    batch_sharding,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    spawn,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "all_reduce_sum",
    "batch_sharding",
    "init_distributed",
    "make_mesh",
    "replicate",
    "shard_batch",
    "spawn",
]
