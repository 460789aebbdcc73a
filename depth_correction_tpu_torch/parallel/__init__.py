"""Training and evaluation over a ``torch.distributed`` process group
(counterpart of ``depth_correction_tpu/parallel/``)."""

from .sharding import (
    DataMesh,
    make_mesh,
    make_multihost_mesh,
    make_sharded_loss_fn,
    mesh_from_config,
    resident_bytes,
    shard_train_data,
)

__all__ = [
    "DataMesh",
    "make_mesh",
    "make_multihost_mesh",
    "make_sharded_loss_fn",
    "mesh_from_config",
    "resident_bytes",
    "shard_train_data",
]
