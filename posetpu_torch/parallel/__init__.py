from posetpu_torch.parallel.mesh import (
    DataMesh,
    data_mesh,
    initialize_distributed,
    replicate,
    shard_batch,
)

__all__ = ["DataMesh", "data_mesh", "initialize_distributed", "shard_batch", "replicate"]
