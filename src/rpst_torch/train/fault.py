"""Failure handling; port of ``rpst.train.fault``.

  * ``apply_update_if_finite``: the optimizer steps only when the loss and
    every gradient are finite. Otherwise the parameters and the whole Adam
    state (moments and count, so also the lr schedule) stay as they were,
    and the caller reports ``skipped``. rpst selects between the old and
    new state inside its jitted step; here one host read of a single flag
    decides, so a skipped step costs no update at all. The model's buffers
    (BatchNorm running statistics, which a train forward moves) are put
    back by ``step.train_step``.
  * ``CheckpointOnSignal``: SIGTERM/SIGINT ask for a last checkpoint
    instead of killing the run.
"""

from __future__ import annotations

import signal
from typing import Iterable, Optional

import torch


def all_finite(loss: torch.Tensor,
               grads: Iterable[Optional[torch.Tensor]]) -> bool:
    """True when ``loss`` and every gradient are finite (one device sync)."""
    flags = [torch.isfinite(loss).all()]
    flags += [torch.isfinite(g).all() for g in grads if g is not None]
    return bool(torch.stack(flags).all())


def apply_update_if_finite(optimizer: torch.optim.Optimizer,
                           loss: torch.Tensor) -> bool:
    """Step ``optimizer`` on its parameters' gradients when ``loss`` and
    the gradients are finite; returns ``skipped`` (True when it did not
    step). The gradients are cleared either way."""
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"]]
    skipped = not all_finite(loss, grads)
    if not skipped:
        optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return skipped


class CheckpointOnSignal:
    """``with CheckpointOnSignal() as stop: ... if stop.requested: save``"""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self.requested = False
        self._old = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, old in self._old.items():
            signal.signal(s, old)
        return False
