"""The training step: loss, gradients, Adam and the reference lr schedule;
port of ``rpst.train.step`` for one device.

The reference optimizes with ``torch.optim.Adam(params, lr)`` at default
betas and eps (optax's ``adam`` is the same rule) and sets the lr before
every update to ``lr / (1 + lr_decay * (count + 1))``, ``count`` the
number of updates applied so far (rpst ``step.py:34-38``). A skipped
non-finite step applies no update, so it leaves ``count`` and the schedule
where they were.

Not ported: ``freeze_prefixes`` (wct resume only), gradient accumulation
and rematerialization (``train_torch.py`` refuses ``grad_accum > 1`` and
``remat``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..models import ModelBundle
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
    skipped or not), the bundle with the model's parameters, the optimizer
    with its Adam state, and the run's ``torch.Generator``."""
    step: int
    bundle: ModelBundle
    optimizer: torch.optim.Adam
    generator: torch.Generator
    schedule: Callable[[int], float]

    @property
    def model(self):
        return self.bundle.model


def create_train_state(bundle: ModelBundle) -> TrainState:
    """Training state over the bundle's current weights; puts the model in
    train mode (the flagship has no BatchNorm, so it computes the same)."""
    cfg = bundle.cfg
    bundle.model.train()
    return TrainState(step=0, bundle=bundle,
                      optimizer=make_optimizer(cfg, bundle.model.parameters()),
                      generator=torch.Generator().manual_seed(cfg.seed),
                      schedule=reference_lr_schedule(cfg.lr, cfg.lr_decay))


def train_step(state: TrainState, vgg: VGG19Encoder, content: torch.Tensor,
               style: torch.Tensor,
               conv_act: ConvAct = folded_conv_act) -> Dict[str, torch.Tensor]:
    """One step on a (content, style) batch, NHWC in [0, 1] on the model's
    device: loss, backward, then Adam unless the loss or a gradient is not
    finite. Returns the loss parts (detached device scalars) with
    ``skipped`` 1.0 or 0.0; ``state.step`` advances either way."""
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    total, parts = state.bundle.loss(vgg, content, style, conv_act=conv_act)
    total.backward()
    lr = state.schedule(adam_count(opt))
    for group in opt.param_groups:
        group["lr"] = lr
    skipped = apply_update_if_finite(opt, total)
    state.step += 1
    if not skipped:
        state.bundle.weights_changed()
    out = {k: v.detach() for k, v in parts.items()}
    out["skipped"] = torch.tensor(float(skipped))
    return out
