from posetpu_torch.parallel.mesh import (
    DataMesh,
    Layout,
    data_mesh,
    host_layout,
    initialize_distributed,
    join,
    replicate,
    shard_batch,
)

__all__ = ["DataMesh", "Layout", "data_mesh", "host_layout", "initialize_distributed", "join",
           "shard_batch", "replicate"]
