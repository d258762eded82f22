"""Process meshes for the port's multi-device runs; port of
``rpst.dist.mesh`` onto ``torch.distributed``.

rpst lays a ``jax.sharding.Mesh`` over the devices of one SPMD program. The
port runs one process per device instead (a "rank"), and a :class:`Mesh`
names each rank's place on the axes:

  * ``data``: the batch (data parallelism); gradients are averaged over it
    after the backward;
  * ``spatial``: image rows (``models.fast_path_spatial``): halo rows cross
    neighbouring ranks and the statistics are all-reduced, in the forward
    and the backward;
  * ``model``: output channels (channel tensor parallelism, ``dist.tp``):
    each rank stores its share of every sharded conv and per-channel
    vector and computes its share of every sharded conv's output
    channels; the model axis does not split the batch.

Ranks are laid out row-major over the axes in the order ``mesh_shape``
gives them, as rpst reshapes its device list: under ``{data: 2, spatial:
2}`` rank 2 d + s holds batch share d, row share s. ``replicate``
broadcasts rank 0's parameters; on a ``model`` axis ``tp.shard_model``
then keeps each rank's share. ``model`` beside ``spatial`` trains the
standard layout on row shares with column-parallel layers (rpst takes
that mesh by GSPMD, ``train.step.train_route``'s "rows" route).

Transport (``choose_backend``): NCCL where every rank has a GPU of its
own; gloo where ranks share a GPU (two ranks on one card: NCCL refuses
that) or run on the CPU, and then the collectives stage their tensors
through host memory explicitly (gloo moves host buffers). The choice
follows the rank layout, is logged, and is never a retry after a failure.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..metrics import logger

AXES = ("data", "spatial", "model")
# the axes that split the batch: what a sum over the batch spans
BATCH_AXES = ("data", "spatial")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value else default


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``, else
    its global rank: one host)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return _env_int("LOCAL_RANK", rank)


def rank_device(device_type: str = "cuda") -> torch.device:
    """The device of this rank: ``cuda:(local_rank % device_count)``, or the
    CPU. A rank asked for CUDA that finds no GPU raises."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("rank asked for CUDA but torch.cuda.is_available() "
                           "is False")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def choose_backend(device_type: str, world_size: int,
                   local_world_size: Optional[int] = None) -> str:
    """NCCL when each rank of a host has a GPU of its own, else gloo (ranks
    on the CPU, or more ranks than GPUs on a host)."""
    if device_type != "cuda":
        return "gloo"
    per_host = local_world_size or world_size
    return "nccl" if per_host <= torch.cuda.device_count() else "gloo"


def setup_distributed(coordinator_address: str = "", num_processes: int = -1,
                      process_id: int = -1, device_type: str = "cuda",
                      timeout_s: float = 600.0) -> str:
    """Join a multi-process run (rpst ``setup_distributed`` :32): the
    config's ``coordinator_address`` (``host:port``, or a ``tcp://`` /
    ``file://`` URL), ``num_processes`` and ``process_id``, each falling
    back to torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) where unset. Idempotent; returns the backend
    (``choose_backend``), or "none" for a run of one process, which joins
    nothing."""
    if dist.is_initialized():
        return dist.get_backend()
    world = num_processes if num_processes and num_processes > 0 \
        else _env_int("WORLD_SIZE", 1)
    rank = process_id if process_id is not None and process_id >= 0 \
        else _env_int("RANK", 0)
    if world <= 1:  # one process: nothing to join
        return "none"
    if coordinator_address:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    else:
        init = "env://"
    backend = choose_backend(device_type, world,
                             _env_int("LOCAL_WORLD_SIZE", 0) or None)
    logger.info(f"rank {rank}/{world}: torch.distributed over {backend} "
                f"({device_type}, {torch.cuda.device_count()} GPU(s) "
                "visible)")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=timedelta(seconds=timeout_s))
    return backend


def is_main_process() -> bool:
    """True on the process that owns the host-side writes (checkpoints,
    metrics, test dumps): rank 0, or a single-process run."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it, the process group of the ranks along it (None where size 1) and
    their global ranks in index order; ``staged``: collectives copy CUDA
    tensors through host memory (gloo)."""
    name: str
    size: int = 1
    index: int = 0
    group: object = None
    ranks: Tuple[int, ...] = (0,)
    staged: bool = False


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a ``{data?, spatial?, model?}`` rank grid (rpst
    ``make_mesh`` :63), its device, and one process group per axis."""
    shape: Dict[str, int]
    rank: int
    device: torch.device
    axes: Dict[str, Axis]
    backend: str
    # False on a rank past the mesh's ranks (a mesh over the first ranks of
    # a larger run): it holds no share and calls no collective of the mesh
    active: bool = True

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()))) if self.shape else 1

    def axis(self, name: str) -> Axis:
        """The axis ``name``, or a size-1 axis where the mesh has none."""
        return self.axes.get(name) or Axis(name, ranks=(self.rank,))

    @property
    def spatial(self) -> int:
        return self.shape.get("spatial", 1)

    @property
    def data(self) -> int:
        return self.shape.get("data", 1)

    @property
    def model(self) -> int:
        return self.shape.get("model", 1)

    def reduce_axes(self) -> Tuple[Axis, ...]:
        """The batch axes of size > 1, data first: what a global sum over
        the batch spans (the ``model`` axis holds one batch share whole)."""
        return tuple(self.axes[a] for a in BATCH_AXES
                     if a in self.axes and self.axes[a].size > 1)


def check_mesh_shape(mesh_shape) -> Dict[str, int]:
    """``mesh_shape`` as an ordered {axis: size}, axes within {data,
    spatial, model}; unknown axes and sizes below 1 raise."""
    shape = {str(k): int(v) for k, v in dict(mesh_shape).items()}
    unknown = set(shape) - set(AXES)
    if unknown:
        raise ValueError(f"mesh axes must be within {AXES}, got {shape}")
    if any(v < 1 for v in shape.values()):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    return shape


def make_mesh(mesh_shape=None, device: Optional[torch.device] = None,
              subset: bool = False) -> Mesh:
    """The mesh of this rank: ``mesh_shape`` (``{'data': 4}``, ``{'data':
    2, 'spatial': 2}``; None puts every rank on ``data``) over the initialized
    process group, whose size must equal the product of the axes (or, with
    ``subset``, be at least it: the mesh then spans the first ranks, and
    the others get an inactive mesh). ``device`` None means this rank's
    card (``rank_device("cuda")``, which raises without one); a CPU mesh
    passes ``torch.device("cpu")``. Every rank calls it in the same order
    (it creates the axes' process groups)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = check_mesh_shape(mesh_shape or {"data": world})
    sizes = tuple(shape.values())
    need = int(np.prod(sizes))
    if need != world and not (subset and need < world):
        raise ValueError(f"mesh {shape} needs {need} ranks, the run has "
                         f"{world}")
    backend = dist.get_backend() if dist.is_initialized() else "none"
    device = device if device is not None else rank_device("cuda")
    staged = backend == "gloo"
    grid = np.arange(need).reshape(sizes)
    active = rank < need
    coords = np.unravel_index(rank if active else 0, sizes)
    axes = {}
    for ax, name in enumerate(shape):
        mine = None
        # every rank creates every group of the axis, in one order
        moved = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for line in moved:
            ranks = tuple(int(r) for r in line)
            group = (dist.new_group(list(ranks))
                     if dist.is_initialized() and len(ranks) > 1 else None)
            if rank in ranks:
                mine = (ranks, group)
        if active:
            axes[name] = Axis(name, sizes[ax], int(coords[ax]), mine[1],
                              mine[0], staged)
    return Mesh(shape, rank, device, axes, backend, active)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` made rank 0's (rpst
    ``replicate`` :98: a broadcast from rank 0), in place."""
    if mesh.size == 1:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        wire = t.detach().cpu() if mesh.backend == "gloo" else t.detach()
        dist.broadcast(wire, src=0)
        if wire is not t:
            t.copy_(wire)
    return module


def _share(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} does not divide into {parts} shares")
    step = n // parts
    return slice(index * step, (index + 1) * step)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's share of the rows (dim 1) of an (N, H, ...) batch on the
    ``spatial`` axis."""
    ax = mesh.axis("spatial")
    return x[:, _share(x.shape[1], ax.size, ax.index, "height")]


def shard_batch(x, mesh: Mesh, spatial: bool = False) -> torch.Tensor:
    """This rank's share of a GLOBAL (N, H, W, C) batch (rpst ``shard_batch``
    :102): N over ``data``, and H over ``spatial`` when ``spatial``; a numpy
    array becomes a tensor on the mesh's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    ax = mesh.axis("data")
    x = x[_share(x.shape[0], ax.size, ax.index, "batch")]
    if spatial:
        x = shard_rows(x, mesh)
    return x.contiguous().to(mesh.device)


def spatial_folded_train_ok(bundle, mesh_shape) -> bool:
    """Can the step run the row-sharded folded route (rpst
    ``spatial_folded_train_ok`` :170): multi_adain, ccam or sel_multi_adain
    on the folded path, ``folded_train_pallas`` on, no ``model`` axis, and
    an image height that gives every row share three VGG pools and two
    relu4_1 rows (img_size % (16 * spatial) == 0)."""
    shape = dict(mesh_shape or {})
    spatial = int(shape.get("spatial", 1))
    return (bundle.network in ("multi_adain", "ccam", "sel_multi_adain")
            and bundle.folded_infer()
            and bool(bundle.cfg.get("folded_train_pallas", True))
            and "model" not in shape
            and bundle.cfg.img_size % (16 * spatial) == 0)
