from witw_tpu_torch.parallel.mesh import (DATA_AXIS, GALLERY_AXIS, Mesh, Shard, gallery_shards,
                                          make_mesh, placement, replicate, shard_batch)

__all__ = [
    "DATA_AXIS",
    "GALLERY_AXIS",
    "Mesh",
    "Shard",
    "gallery_shards",
    "make_mesh",
    "placement",
    "replicate",
    "shard_batch",
]
