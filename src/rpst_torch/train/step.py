"""The training step: loss, gradients, Adam and the reference lr schedule;
port of ``rpst.train.step`` for one device.

The reference optimizes with ``torch.optim.Adam(params, lr)`` at default
betas and eps (optax's ``adam`` is the same rule) and sets the lr before
every update to ``lr / (1 + lr_decay * (count + 1))``, ``count`` the
number of updates applied so far (rpst ``step.py:34-38``). A skipped
non-finite step applies no update, so it leaves ``count`` and the schedule
where they were, and puts back the model's buffers (sel_multi_adain's
BatchNorm running statistics, which its train forward moves), as rpst's
skip rolls back ``batch_stats`` with the rest of the state
(``step.py:171-181``).

A parameter the loss does not reach (wct's and mst's encoders behind their
detached transforms, seg_adain's head on an unlabelled batch) gets a zero
gradient, as ``jax.grad`` gives it, so Adam keeps moments and a count for
every trained parameter, as optax does. ``freeze_prefixes`` (rpst's
``optax.multi_transform`` with ``set_to_zero``, which wct's resume sets for
the encoder) leaves the parameters under those top-level modules out of
the optimizer: no update, no Adam state.

A step may take precomputed loss targets (``train.target_cache``); rpst
refuses them with ``grad_accum`` and with labels (``check_target_cache``).
A step may take content labels (seg_adain's segmentation loss; rpst's
``make_train_step(with_labels=True)``).

``grad_accum: k`` (rpst's ``_accumulate_grads``, ``step.py:68-116``) splits
the batch into k equal microbatches (the labels with it) run one after the
other: the losses, loss parts and gradients are averaged (summed, then
scaled by 1 / k, as rpst's scan does), and one Adam step and one schedule
count follow. Each microbatch's train forward takes its own BatchNorm
batch statistics and moves the running ones, so a step moves them k times
and the averaged gradient is the full batch's only for a network without
BatchNorm. A batch that k does not divide raises, and so do precomputed
targets (``check_target_cache``).

``remat: true`` (rpst ``step.py:155-161``) checkpoints the whole loss
function, not block by block, as rpst's ``jax.checkpoint(loss_fn)``: the
forward keeps only its inputs and the backward recomputes it
(``torch.utils.checkpoint``, non-reentrant), so the folded step launches
B1 again in the recompute. The recompute leaves the BatchNorm running
statistics alone (``nn.attention.running_stats_frozen``): they move once,
as in a plain step.

On a mesh (``TrainState.mesh``, rpst's ``make_sharded_train_step``,
``dist/mesh.py:182-271``) every rank runs this step on its share of the
batch, by one of four routes (``train_route``):

  * **spatial** (row-sharded folded) where ``dist.spatial_folded_train_ok``
    holds (the folded multi_adain, ccam, sel_multi_adain): the loss of
    ``models.fast_path_spatial.loss_spatial`` on the rank's rows, the
    global loss on every rank, through the halo kernels (B3's listed
    mode); also on a mesh with no ``spatial`` axis, as rpst's shard_map;
  * **rows** (row-sharded standard layout) for every other ``spatial``
    axis, a ``model`` axis beside it included (rpst jits ``bundle.loss``
    unchanged under GSPMD, ``:243-248``, images on ``P("data",
    "spatial")``): the one-device standard loss
    (``fast_path_spatial.loss_std_spatial``) on the rank's rows inside
    ``dist.row_shares``, so every rank holds the GLOBAL loss and
    differentiates it through its own rows; its batch reductions
    (BatchNorm, the segmentation loss) over ``data`` x ``spatial``;
    sanet's attention is B6b-d on the share's query rows against the
    gathered style. The folded three take it where the folded route
    turns them away (labels, SE attention, a height the folded route
    cannot split, a ``model`` axis), as rpst's GSPMD step runs them
    without its Pallas kernels;
  * **model** (channel tensor parallel) on a ``model`` axis with no
    ``spatial`` one (rpst's ``state_sharding=tp_shardings(...)``, any
    network): the model holds this rank's shares (``dist.tp.shard_model``);
    the one-device loss runs with its column-parallel layers computing
    their output-channel shares (the folded convs through
    ``dist.tp.folded_column``: B1 / B2 / B3 at the share's width) and the
    other sharded leaves gathered at use (``dist.tp.gathered``); the ranks
    of one model group hold the same batch share. Beside a ``spatial``
    axis the rows route does the same on row shares;
  * **data** (data parallel) otherwise: the one-device loss on the rank's
    batch share, its batch reductions (BatchNorm's statistics, seg_adain's
    cross entropy) over the global batch (``dist.over_batch``), as rpst's
    GSPMD step computes them.

On every route the parameters' gradients are then averaged over the batch
axes, ``data`` and ``spatial`` (each rank seeded its own copy of the loss:
``dist.collectives``), and the loss parts too, so every rank takes the
same update and the same skip decision; the model axis's collectives
sum and gather, and nothing is averaged over it. ``grad_accum: k`` cuts
the GLOBAL batch into k contiguous microbatches, as rpst's
``_accumulate_grads`` cuts its global array (``step.py:78-83``), and each
rank takes its batch share of each: a rank's local batch is a contiguous
share of the global one, so on a ``data`` axis the step first re-deals
the images over the axis (``redeal_microbatches``; a row share keeps its
rows), and microbatch k of rank r is rank r's share of global images
[k n / accum, (k + 1) n / accum). ``remat`` recomputes with the same
batch reductions and row shares.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..dist import (Mesh, average_grads, check_mesh_shape, mean_over,
                    over_batch, row_shares, spatial_folded_train_ok)
from ..dist import tp
from ..dist.collectives import all_gather
from ..models import ModelBundle
from ..nn.attention import running_stats_frozen
from ..nn.vgg import VGG19Encoder
from ..nn.vgg_folded import ConvAct
from ..ops.folded_conv import folded_conv_act
from .fault import apply_update_if_finite


def reference_lr_schedule(lr: float, lr_decay: float) -> Callable[[int],
                                                                   float]:
    """count -> lr / (1 + lr_decay * (count + 1)) (reference train.py:57-61)."""
    def schedule(count: int) -> float:
        return lr / (1.0 + lr_decay * (count + 1.0))
    return schedule


def make_optimizer(cfg, params) -> torch.optim.Adam:
    """Adam at default betas (0.9, 0.999) and eps 1e-8, as the reference
    (which ignores its config's beta1/beta2) and optax's ``adam``."""
    return torch.optim.Adam(params, lr=cfg.lr)


def trainable_parameters(model: torch.nn.Module,
                         freeze_prefixes: Tuple[str, ...] = ()):
    """The parameters outside the top-level modules ``freeze_prefixes``;
    the frozen ones stop requiring gradients."""
    params = []
    for name, p in model.named_parameters():
        if name.split(".", 1)[0] in freeze_prefixes:
            p.requires_grad_(False)
        else:
            params.append(p)
    return params


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """The number of updates the optimizer has applied (its state's step)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the step count (advances on every step,
    skipped or not), the bundle with the model's parameters and buffers
    (BatchNorm running statistics), the optimizer
    with its Adam state, and the run's ``torch.Generator``."""
    step: int
    bundle: ModelBundle
    optimizer: torch.optim.Adam
    generator: torch.Generator
    schedule: Callable[[int], float]
    frozen: Tuple[str, ...] = ()
    # the rank's mesh on a multi-device run (None: one device)
    mesh: Optional[Mesh] = None

    @property
    def model(self):
        return self.bundle.model


def create_train_state(bundle: ModelBundle,
                       freeze_prefixes: Tuple[str, ...] = (),
                       mesh: Optional[Mesh] = None) -> TrainState:
    """Training state over the bundle's current weights; puts the model in
    train mode (sel_multi_adain's and spade's BatchNorms then take batch
    statistics). ``freeze_prefixes``: top-level modules left untrained
    (``trainable_parameters``). ``mesh``: this rank's place on a
    multi-device run (the weights must already be rank 0's:
    ``dist.replicate``); ``train_route`` says how its steps run."""
    cfg = bundle.cfg
    if mesh is not None:
        train_route(bundle, mesh)  # refuses what no route takes
    bundle.model.train()
    params = trainable_parameters(bundle.model, tuple(freeze_prefixes))
    return TrainState(step=0, bundle=bundle,
                      optimizer=make_optimizer(cfg, params),
                      generator=torch.Generator().manual_seed(cfg.seed),
                      schedule=reference_lr_schedule(cfg.lr, cfg.lr_decay),
                      frozen=tuple(freeze_prefixes), mesh=mesh)


def train_route(bundle: ModelBundle, mesh) -> str:
    """"single" (no mesh), "spatial" (the row-sharded folded route, where
    ``dist.spatial_folded_train_ok`` holds), "rows" (the row-sharded
    standard layout: any other ``spatial`` axis, a ``model`` axis beside
    it included), "model" (channel tensor parallel, a ``model`` axis with
    no ``spatial`` one) or "data" (data parallel) on ``mesh`` (a Mesh, or
    a mesh_shape dict). mst on a ``spatial`` axis raises ``ValueError``,
    as rpst's does (its k-means and chain labelling see whole images);
    so does a height the axis does not divide (``check_std_height``)."""
    from ..models.fast_path_spatial import check_std_height
    if mesh is None:
        return "single"
    shape = check_mesh_shape(mesh.shape if isinstance(mesh, Mesh)
                             else dict(mesh))
    spatial = int(shape.get("spatial", 1))
    if spatial > 1 and bundle.network == "mst":
        raise ValueError("mst trains on a data-only mesh: its k-means and "
                         "chain labelling see whole images (rpst "
                         "tests/test_train_matrix.py:154-168); got "
                         f"{shape}")
    if int(shape.get("model", 1)) > 1 and spatial == 1:
        return "model"
    if spatial_folded_train_ok(bundle, shape):  # never beside a model axis
        return "spatial"
    if spatial > 1:
        check_std_height(bundle.cfg.img_size, spatial)
        return "rows"
    return "data"


def check_target_cache(cfg, with_labels: bool = False) -> None:
    """rpst's two refusals of precomputed loss targets
    (``make_train_step``): the cache keys are per image, so microbatching
    them (``grad_accum``) is not done, and the cache is for the
    perceptual-loss families, not a labelled step."""
    if int(cfg.get("grad_accum", 1)) > 1:
        raise ValueError("target caching and grad_accum are mutually "
                         "exclusive")
    if with_labels:
        raise ValueError("target caching is for the perceptual-loss "
                         "families")


@contextlib.contextmanager
def _recompute(axes, rows=None):
    with running_stats_frozen(), over_batch(axes), (
            contextlib.nullcontext() if rows is None else row_shares(rows)):
        yield


def _remat_contexts(axes=(), rows=None):
    """``torch.utils.checkpoint``'s ``context_fn``: (forward, recompute)
    contexts; the recompute leaves the running statistics alone and takes
    the batch reductions over the same ranks, and the row shares of the
    same axis, as the forward."""
    return lambda: (contextlib.nullcontext(), _recompute(axes, rows))


def step_loss(bundle: ModelBundle, vgg: VGG19Encoder, content, style,
              conv_act: ConvAct = folded_conv_act, targets=None,
              content_label=None, remat: bool = False,
              mesh: Optional[Mesh] = None):
    """``bundle.loss`` -> (total, parts) on one device, or this rank's loss
    on ``mesh`` (``train_route``: ``fast_path_spatial.loss_spatial`` or
    ``loss_std_spatial`` on the rows, or the batch share's loss with
    global batch reductions); with ``remat`` under one non-reentrant
    checkpoint of the whole function."""
    route = train_route(bundle, mesh)
    axes = () if mesh is None else mesh.reduce_axes()
    rows = mesh.axis("spatial") if route == "rows" else None
    if mesh is not None and mesh.model > 1:  # the folded convs of a
        conv_act = tp.folded_column(conv_act)  # share: B1-B3 at its width

    def loss_fn(c, s, lab):
        if route == "spatial":
            from ..models.fast_path_spatial import loss_spatial
            return loss_spatial(bundle, vgg, c, s, mesh)
        kw = {} if lab is None else {"content_label": lab}
        shared = (tp.gathered(bundle.model) if mesh is not None
                  and mesh.model > 1 else contextlib.nullcontext())
        if route == "rows":
            from ..models.fast_path_spatial import loss_std_spatial
            with shared:
                return loss_std_spatial(bundle, vgg, c, s, mesh, **kw)
        with over_batch(axes), shared:
            return bundle.loss(vgg, c, s, targets=targets,
                               conv_act=conv_act, **kw)
    if not remat:
        return loss_fn(content, style, content_label)
    return checkpoint(loss_fn, content, style, content_label,
                      use_reentrant=False,
                      context_fn=_remat_contexts(axes, rows))


def redeal_microbatches(x: torch.Tensor, mesh: Mesh,
                        accum: int) -> torch.Tensor:
    """This rank's batch share ``x`` (rank r of D on ``data`` holds global
    images [r n / D, (r + 1) n / D)) re-dealt so that its k-th contiguous
    block of n / (D accum) images is its share of the global microbatch k
    (global images [k n / accum, (k + 1) n / accum)), rpst's grouping
    (``_accumulate_grads``). Every rank of the data axis calls it
    together."""
    ax = mesh.axis("data")
    if ax.size == 1 or accum == 1:
        return x
    glob = torch.cat(all_gather(x, ax), dim=0)
    n = glob.shape[0]
    if n % (accum * ax.size):
        raise ValueError(f"global batch {n} does not split into grad_accum "
                         f"{accum} microbatches of {ax.size} data shares")
    big, small = n // accum, n // (accum * ax.size)
    idx = [k * big + ax.index * small + j for k in range(accum)
           for j in range(small)]
    return glob[torch.tensor(idx, device=glob.device)].contiguous()


def train_step(state: TrainState, vgg: VGG19Encoder, content: torch.Tensor,
               style: torch.Tensor, conv_act: ConvAct = folded_conv_act,
               targets=None, content_label: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """One step on a (content, style) batch, NHWC in [0, 1] on the model's
    device: loss, backward (over ``grad_accum`` microbatches, the whole
    loss checkpointed with ``remat``), then Adam unless the loss or a
    gradient is not finite; a skipped step also puts the model's buffers
    back. ``targets`` are precomputed loss targets
    (``DeviceTargetCache.targets_for_batch``); ``content_label`` (N, H, W)
    integer labels of the content batch (seg_adain). Returns the loss
    parts (detached device scalars, averaged over the microbatches) with
    ``skipped`` 1.0 or 0.0; ``state.step`` advances either way. On a mesh
    (``state.mesh``) ``content`` / ``style`` are this rank's share (its
    batch share, and its rows on the row-sharded route), and the gradients
    and parts are averaged over the mesh before the update."""
    cfg = state.bundle.cfg
    accum = int(cfg.get("grad_accum", 1))
    remat = bool(cfg.get("remat", False))
    if targets is not None:
        check_target_cache(cfg, content_label is not None)
        if state.mesh is not None:
            raise ValueError("precomputed loss targets (the target cache) "
                             "are for one device")
    n = content.shape[0]
    if n % accum:
        raise ValueError(f"batch {n} not divisible by grad_accum {accum}")
    if accum > 1 and state.mesh is not None:  # rpst's global microbatches
        content, style = (redeal_microbatches(t, state.mesh, accum)
                          for t in (content, style))
        if content_label is not None:
            content_label = redeal_microbatches(content_label, state.mesh,
                                                accum)
    mb = n // accum
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    buffers = [b.clone() for b in state.model.buffers()]
    total_sum, parts_sum = None, {}
    for i in range(accum):
        rows = slice(i * mb, (i + 1) * mb)
        total, parts = step_loss(
            state.bundle, vgg, content[rows], style[rows], conv_act,
            targets,
            None if content_label is None else content_label[rows], remat,
            state.mesh)
        total.backward()
        total = total.detach()
        total_sum = total if total_sum is None else total_sum + total
        for k, v in parts.items():
            v = v.detach()
            parts_sum[k] = parts_sum[k] + v if k in parts_sum else v
    if accum > 1:  # rpst's mean: the sums times 1 / accum
        inv = 1.0 / accum
        total_sum = total_sum * inv
        parts_sum = {k: v * inv for k, v in parts_sum.items()}
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.mul_(inv)
    for group in opt.param_groups:  # jax.grad's zeros where nothing flows
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    if state.mesh is not None:
        axes = state.mesh.reduce_axes()
        average_grads([p for g in opt.param_groups for p in g["params"]],
                      axes)
        parts_sum = mean_over({**parts_sum, "total_loss": total_sum}, axes)
        total_sum = parts_sum["total_loss"]
    lr = state.schedule(adam_count(opt))
    for group in opt.param_groups:
        group["lr"] = lr
    skipped = apply_update_if_finite(opt, total_sum)
    if skipped:
        with torch.no_grad():
            for b, old in zip(state.model.buffers(), buffers):
                b.copy_(old)
    state.step += 1
    if not skipped:
        state.bundle.weights_changed()
    out = dict(parts_sum)
    out["skipped"] = torch.tensor(float(skipped))
    return out
