from witw_tpu_torch.parallel.collectives import process_count, process_index
from witw_tpu_torch.parallel.mesh import (DATA_AXIS, GALLERY_AXIS, GlobalBatch, Mesh, Shard,
                                          gallery_shards, global_batch_from_local,
                                          initialize_distributed, make_mesh, placement, replicate,
                                          shard_batch)

__all__ = [
    "make_mesh",
    "shard_batch",
    "global_batch_from_local",
    "initialize_distributed",
    "DATA_AXIS",
    "GALLERY_AXIS",
    "GlobalBatch",
    "Mesh",
    "Shard",
    "gallery_shards",
    "placement",
    "process_count",
    "process_index",
    "replicate",
]
