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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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

    @property
    def model(self):
        return self.bundle.model


def create_train_state(bundle: ModelBundle,
                       freeze_prefixes: Tuple[str, ...] = ()) -> TrainState:
    """Training state over the bundle's current weights; puts the model in
    train mode (sel_multi_adain's and spade's BatchNorms then take batch
    statistics). ``freeze_prefixes``: top-level modules left untrained
    (``trainable_parameters``)."""
    cfg = bundle.cfg
    bundle.model.train()
    params = trainable_parameters(bundle.model, tuple(freeze_prefixes))
    return TrainState(step=0, bundle=bundle,
                      optimizer=make_optimizer(cfg, params),
                      generator=torch.Generator().manual_seed(cfg.seed),
                      schedule=reference_lr_schedule(cfg.lr, cfg.lr_decay),
                      frozen=tuple(freeze_prefixes))


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


def _remat_contexts():
    """``torch.utils.checkpoint``'s (forward, recompute) contexts: the
    recompute leaves the running statistics alone."""
    return contextlib.nullcontext(), running_stats_frozen()


def step_loss(bundle: ModelBundle, vgg: VGG19Encoder, content, style,
              conv_act: ConvAct = folded_conv_act, targets=None,
              content_label=None, remat: bool = False):
    """``bundle.loss`` -> (total, parts); with ``remat`` under one
    non-reentrant checkpoint of the whole function."""
    def loss_fn(c, s, lab):
        kw = {} if lab is None else {"content_label": lab}
        return bundle.loss(vgg, c, s, targets=targets, conv_act=conv_act,
                           **kw)
    if not remat:
        return loss_fn(content, style, content_label)
    return checkpoint(loss_fn, content, style, content_label,
                      use_reentrant=False, context_fn=_remat_contexts)


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
    ``skipped`` 1.0 or 0.0; ``state.step`` advances either way."""
    cfg = state.bundle.cfg
    accum = int(cfg.get("grad_accum", 1))
    remat = bool(cfg.get("remat", False))
    if targets is not None:
        check_target_cache(cfg, content_label is not None)
    n = content.shape[0]
    if n % accum:
        raise ValueError(f"batch {n} not divisible by grad_accum {accum}")
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
            None if content_label is None else content_label[rows], remat)
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
