"""Channel tensor parallelism over the ``model`` mesh axis; port of rpst's
``dist/mesh.py`` ``_tp_leaf_spec`` (:119), ``tp_shardings`` (:138),
``shard_params_tp`` (:157) and ``gather_replicated`` (:146).

Which leaves shard is rpst's rule, read on rpst's (flax) layout: a 4-D
conv kernel on its output-channel dim (HWIO's last; an ``nn.Conv2d``'s
OIHW dim 0 here) and a 1-D per-channel vector, wherever that size divides
by the axis size and is at least ``min_channels`` (32, as ``train.py``
passes it). The Adam moments follow their parameters (they are made from
the stored shares), and so do the BatchNorm running statistics. Each rank
stores only its share (``shard_model``).

rpst lets GSPMD partition the compute. Here the layers do it themselves:

  * **column-parallel layers**: an ``nn.Conv2d`` whose kernel shards
    becomes a :class:`ColumnConv2d`, which computes this rank's output
    channels from the whole input and gathers the channel axis after
    (``dist.enter_model`` before, ``dist.gather_channels`` after: Megatron's
    f / g pair, so dx is summed over the axis in the backward and each
    rank's kernel gradient is its share's). The other readers of a conv's
    kernel go through ``column`` (the zero-pad ``PadConv``, SANet's
    ``conv1x1_nhwc``, LD v5's ``NonOverlapConvTranspose``), and the folded
    path tags the share's folded kernel (``tag_folded``) so that
    ``folded_column`` runs B1 (forward) and B2 / B3 (backward) at the
    share's width and gathers the folded channel order
    (``dist.gather_folded``);
  * **gathered at use**: every other sharded leaf (BatchNorm scales and
    biases, a ``Linear``'s bias) is gathered whole for the duration of a
    forward (``gathered``), differentiably: its gradient is this rank's
    slice. BatchNorm's running statistics are gathered the same way and
    each rank writes its slice back after the forward.

Checkpoints hold the one-device layout: ``full_state_dict`` /
``full_optimizer_state`` gather every share (every rank calls them
together), ``load_full_state_dict`` / ``load_full_optimizer_state`` keep
this rank's slice of a full-shape state.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from .collectives import (all_gather, enter_model, gather_channels,
                          gather_folded)
from .mesh import Axis

MIN_CHANNELS = 32


@dataclasses.dataclass(frozen=True)
class Spec:
    """Where a stored tensor is sharded: the axis, the dim (the port's
    layout) and the full size of that dim."""
    axis: Axis
    dim: int
    full: int

    def part(self) -> slice:
        step = self.full // self.axis.size
        return slice(self.axis.index * step, (self.axis.index + 1) * step)


def spec_of(t) -> Optional[Spec]:
    return getattr(t, "tp_spec", None)


def leaf_dim(shape, out_dim: int, tp: int,
             min_channels: int = MIN_CHANNELS) -> Optional[int]:
    """rpst's ``_tp_leaf_spec`` in the port's layout: ``out_dim`` for a 4-D
    kernel whose output channels (at ``out_dim``) divide by ``tp`` and
    reach ``min_channels``; 0 for such a 1-D vector; None (replicated)
    otherwise."""
    if len(shape) == 4:
        n = shape[out_dim]
    elif len(shape) == 1:
        n, out_dim = shape[0], 0
    else:
        return None
    return out_dim if n % tp == 0 and n >= min_channels else None


def flax_leaf_spec(shape, tp: int, min_channels: int = MIN_CHANNELS
                   ) -> Optional[int]:
    """rpst's rule on a flax-layout leaf: the dim it shards, or None."""
    return leaf_dim(tuple(shape), len(shape) - 1, tp, min_channels)


def _kernel_out_dim(module: nn.Module, name: str) -> int:
    """The output-channel dim of a 4-D parameter in the port's layout."""
    if isinstance(module, nn.ConvTranspose2d):
        return 1
    if isinstance(module, nn.Conv2d):
        return 0
    return 3  # a kernel kept in flax's HWIO (NonOverlapConvTranspose)


def _column_weight(module: nn.Module) -> Optional[str]:
    """The kernel of a layer that computes its output channels' share
    (column parallel): an ``nn.Conv2d`` (not grouped), or a module naming
    its kernel in ``tp_column_kernel``."""
    if type(module) is nn.Conv2d and module.groups == 1:
        return "weight"
    return getattr(module, "tp_column_kernel", None)


class ColumnConv2d(nn.Conv2d):
    """An ``nn.Conv2d`` holding this rank's output-channel share: each
    call convolves the whole input with the share and gathers the channel
    axis (``column``)."""

    def _conv_forward(self, x, weight, bias):
        conv = super()._conv_forward
        return column(lambda v: conv(v, weight, bias), x, self.weight, 1)


def column_axis(weight) -> Optional[Axis]:
    """The model axis of a column-parallel layer's kernel share, or None."""
    return getattr(weight, "tp_column", None)


def column(fn: Callable, x: torch.Tensor, weight, dim: int) -> torch.Tensor:
    """``fn(x)`` of a layer whose kernel is ``weight``: as is for a whole
    kernel; for a column share, ``fn`` on the input entered into the model
    axis and its output's channel dim ``dim`` gathered over it."""
    ax = column_axis(weight)
    if ax is None:
        return fn(x)
    return gather_channels(fn(enter_model(x, ax)), ax, dim)


def tag_folded(folded_kernel: torch.Tensor, weight) -> torch.Tensor:
    """Mark a folded kernel made from ``weight`` as a column share (the
    folded convs read the mark: ``folded_column``)."""
    ax = column_axis(weight)
    if ax is not None:
        folded_kernel.tp_column = ax
    return folded_kernel


def folded_column(conv: Callable) -> Callable:
    """``conv(x_f, k, b, ...)`` (a folded conv + activation: B1, with B2 /
    B3 backward) taking the share of a tagged kernel: the share's folded
    output channels, gathered into the folded channel order."""
    def run(x_f, k, b, *args, **kw):
        ax = column_axis(k)
        if ax is None:
            return conv(x_f, k, b, *args, **kw)
        return gather_folded(conv(enter_model(x_f, ax), k, b, *args, **kw),
                             ax)
    return run


@torch.no_grad()
def shard_model(model: nn.Module, ax: Axis,
                min_channels: int = MIN_CHANNELS) -> int:
    """Keep this rank's share of every leaf rpst's rule shards, in place
    (before the optimizer exists, so that Adam's moments are made of the
    shares), and make the column-parallel layers compute on their share.
    Returns the number of sharded leaves."""
    if ax.size == 1:
        return 0
    count = 0
    for m in model.modules():
        col = _column_weight(m)
        col_ok = col is not None and leaf_dim(
            tuple(getattr(m, col).shape), _kernel_out_dim(m, col), ax.size,
            min_channels) is not None
        for store in (m._parameters, m._buffers):
            for name, t in list(store.items()):
                if t is None:
                    continue
                dim = leaf_dim(tuple(t.shape), _kernel_out_dim(m, name),
                               ax.size, min_channels)
                if dim is None:
                    continue
                spec = Spec(ax, dim, t.shape[dim])
                part = t.detach().narrow(dim, spec.part().start,
                                         spec.full // ax.size).clone()
                if isinstance(t, nn.Parameter):
                    t.data = part
                    share = t
                else:
                    share = store[name] = part
                share.tp_spec = spec
                if col_ok and (name == col or name == "bias"):
                    share.tp_column = ax
                count += 1
        if col_ok and type(m) is nn.Conv2d:
            m.__class__ = ColumnConv2d
    return count


def is_sharded(model: nn.Module) -> bool:
    return any(spec_of(t) is not None for t in
               list(model.parameters()) + list(model.buffers()))


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Inside the block every sharded leaf of ``model`` that no
    column-parallel layer consumes reads whole (parameters
    differentiably); the BatchNorm running statistics a train forward moves
    in there go back to each rank's share on exit. Every rank of the
    model axis enters it together."""
    swaps = []
    try:
        for m in model.modules():
            for kind in ("_parameters", "_buffers"):
                store = getattr(m, kind)
                for name, t in list(store.items()):
                    spec = spec_of(t)
                    if spec is None or column_axis(t) is not None:
                        continue
                    if kind == "_buffers":
                        with torch.no_grad():
                            full = gather_channels(t, spec.axis, spec.dim)
                    else:
                        full = gather_channels(t, spec.axis, spec.dim)
                    store[name] = full
                    swaps.append((store, name, t, spec, kind))
        yield
    finally:
        for store, name, t, spec, kind in reversed(swaps):
            if kind == "_buffers":
                with torch.no_grad():
                    t.copy_(store[name].narrow(spec.dim, spec.part().start,
                                               t.shape[spec.dim]))
            store[name] = t


# ------------------------------------------------------------ checkpoints

def _gather(t: torch.Tensor, spec: Spec) -> torch.Tensor:
    return torch.cat(all_gather(t.detach().contiguous(), spec.axis),
                     dim=spec.dim)


def _specs(model: nn.Module) -> Dict[str, Spec]:
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {n: spec_of(t) for n, t in named if spec_of(t) is not None}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` in the one-device layout: every share
    gathered over its axis (rpst ``gather_replicated``; every rank of the
    run calls it together)."""
    specs = _specs(model)
    return {k: (_gather(v, specs[k]) if k in specs else v)
            for k, v in model.state_dict().items()}


def _slice(t: torch.Tensor, spec: Spec) -> torch.Tensor:
    return t.narrow(spec.dim, spec.part().start,
                    spec.full // spec.axis.size).clone()


def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]
                         ) -> None:
    """Load a one-device ``state_dict`` into a sharded ``model``: each
    rank keeps its slice of every sharded leaf."""
    specs = _specs(model)
    model.load_state_dict({k: (_slice(v, specs[k]) if k in specs else v)
                           for k, v in state.items()})


def _param_specs(optimizer: torch.optim.Optimizer) -> List[Optional[Spec]]:
    return [spec_of(p) for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with the moments of every sharded
    parameter gathered (every rank calls it together)."""
    sd = optimizer.state_dict()
    specs = _param_specs(optimizer)
    state = {}
    for i, st in sd["state"].items():
        spec = specs[i]
        state[i] = {k: (_gather(v, spec) if spec is not None
                        and torch.is_tensor(v) and v.dim() > 0 else v)
                    for k, v in st.items()}
    return {**sd, "state": state}


def load_full_optimizer_state(optimizer: torch.optim.Optimizer,
                              sd: dict) -> None:
    """Load a one-device optimizer ``state_dict``: each rank keeps its
    slice of every sharded parameter's moments."""
    specs = _param_specs(optimizer)
    state = {}
    for i, st in sd["state"].items():
        spec = specs[int(i)]
        state[i] = {k: (_slice(v, spec) if spec is not None
                        and torch.is_tensor(v) and v.dim() > 0 else v)
                    for k, v in st.items()}
    optimizer.load_state_dict({**sd, "state": state})


def stored_numel(model: nn.Module, optimizer=None) -> int:
    """Elements this rank stores of the parameters, buffers and (with
    ``optimizer``) Adam moments."""
    n = sum(t.numel() for t in list(model.parameters())
            + list(model.buffers()))
    if optimizer is not None:
        n += sum(v.numel() for st in optimizer.state.values()
                 for v in st.values() if torch.is_tensor(v) and v.dim() > 0)
    return n


__all__ = ["MIN_CHANNELS", "Spec", "ColumnConv2d", "column",
           "column_axis", "flax_leaf_spec", "folded_column",
           "full_optimizer_state", "full_state_dict", "gathered",
           "is_sharded", "leaf_dim", "load_full_optimizer_state",
           "load_full_state_dict", "shard_model", "spec_of",
           "stored_numel", "tag_folded"]
