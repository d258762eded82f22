"""Multi-device execution of the port (rpst ``dist``): process meshes,
differentiable collectives. See ``mesh`` and ``collectives``."""

from .collectives import (all_reduce, average_grads, batch_axes, halo_rows,
                          mean_over, over_batch)
from .mesh import (Axis, Mesh, check_mesh_shape, choose_backend,
                   is_main_process, make_mesh, rank_device, replicate,
                   setup_distributed, shard_batch, shard_rows,
                   spatial_folded_train_ok)

__all__ = ["Axis", "Mesh", "all_reduce", "average_grads", "batch_axes",
           "check_mesh_shape", "choose_backend", "halo_rows",
           "is_main_process", "make_mesh", "mean_over", "over_batch",
           "rank_device", "replicate", "setup_distributed", "shard_batch",
           "shard_rows", "spatial_folded_train_ok"]
