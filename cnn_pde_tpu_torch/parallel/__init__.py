"""The parallel layer of the port (``cnn_pde_tpu/parallel/``): device
meshes, process-group bring-up and data-parallel training, one process a
device over NCCL (the card) or gloo (the CPU).  Spatial and tensor
parallelism are ROADMAP.md A15."""

from .data_parallel import (make_dp_train_step, make_train_step_body,
                            replicate, shard_batch, sync_batch_norms)
from .mesh import Mesh, make_mesh
from .multihost import (global_batch_from_local, initialize, is_multihost,
                        local_batch_slice)

__all__ = ["Mesh", "make_mesh", "initialize", "is_multihost",
           "local_batch_slice", "global_batch_from_local",
           "make_dp_train_step", "make_train_step_body", "shard_batch",
           "replicate", "sync_batch_norms"]
