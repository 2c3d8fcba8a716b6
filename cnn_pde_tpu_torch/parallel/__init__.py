"""The parallel layer of the port (``cnn_pde_tpu/parallel/``): device
meshes, process-group bring-up, data parallelism, tensor parallelism of
the FC stacks and the Ruthotto K, spatial sharding of the PDE evolution
(halo exchange, the all_to_all axis swap, the partitioned tridiagonal
solve), the two spatial classifiers and branch parallelism (the
flagship's three PDE branches split over the 'model' axis), one process a
device over NCCL (the card) or gloo (the CPU)."""

from .branch_parallel import enable_branch_parallel
from .data_parallel import (make_dp_train_step, make_train_step_body,
                            replicate, shard_batch, sync_batch_norms)
from .dist_tridiag import (adi_strang_step_partitioned, sweep_sharded_axis,
                           tridiag_solve_partitioned)
from .mesh import Mesh, make_mesh
from .multihost import (global_batch_from_local, initialize, is_multihost,
                        local_batch_slice)
from .spatial import (adi_strang_step_spatial, ftcs_evolve_spatial,
                      laplacian_step_spatial)
from .spatial_model import SpatialFTCSClassifier, SpatialTinyImageNetClassifier
from .tensor_parallel import (full_state_dict, load_full_state_dict,
                              make_tp_train_step, replicated_like,
                              shard_pytree, tp_param_specs)

__all__ = ["Mesh", "make_mesh", "initialize", "is_multihost",
           "local_batch_slice", "global_batch_from_local",
           "make_dp_train_step", "make_train_step_body", "shard_batch",
           "replicate", "sync_batch_norms",
           "adi_strang_step_partitioned", "sweep_sharded_axis",
           "tridiag_solve_partitioned", "adi_strang_step_spatial",
           "ftcs_evolve_spatial", "laplacian_step_spatial",
           "SpatialFTCSClassifier", "SpatialTinyImageNetClassifier",
           "make_tp_train_step", "replicated_like", "shard_pytree",
           "tp_param_specs", "full_state_dict", "load_full_state_dict",
           "enable_branch_parallel"]
