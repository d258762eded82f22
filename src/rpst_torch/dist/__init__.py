"""Multi-device execution of the port (rpst ``dist``): process meshes,
differentiable collectives, channel tensor parallelism. See ``mesh``,
``collectives`` and ``tp``."""

from .collectives import (Whole, all_reduce, average_grads, batch_axes,
                          enter_model, gather_channels, gather_folded,
                          halo_pad, halo_rows, max_over, mean_over,
                          over_batch, row_shares, whole_rows)
from .mesh import (Axis, Mesh, check_mesh_shape, choose_backend,
                   is_main_process, make_mesh, rank_device, replicate,
                   setup_distributed, shard_batch, shard_rows,
                   spatial_folded_train_ok)

__all__ = ["Axis", "Mesh", "Whole", "all_reduce", "average_grads",
           "batch_axes", "check_mesh_shape", "choose_backend", "enter_model",
           "gather_channels", "gather_folded", "halo_pad", "halo_rows",
           "max_over", "is_main_process", "make_mesh", "mean_over",
           "over_batch", "rank_device", "replicate", "row_shares",
           "setup_distributed", "shard_batch", "shard_rows",
           "spatial_folded_train_ok", "whole_rows"]
