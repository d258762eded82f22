"""Differentiable collectives for the port's multi-device paths.

rpst differentiates through ``ppermute`` and ``psum`` inside one
``shard_map``. Here each is a ``torch.autograd.Function`` that runs on
every rank of a :class:`~rpst_torch.dist.mesh.Axis`:

  * ``all_reduce``: the sum over the ranks of an axis; its backward is the
    same sum of the cotangents (``psum``'s transpose is ``psum``);
  * ``halo_rows``: the rows a row shard reads above and below it
    (``fast_path_spatial._halo_rows`` :44-61): its neighbours' edge rows,
    the reflect ring at the image's top and bottom; the backward sends
    each row's cotangent back to the rank that owns the row;
  * ``enter_model`` / ``gather_channels`` / ``gather_folded``: Megatron's
    f / g pair of a column-parallel layer on the ``model`` axis
    (``dist.tp``). f is the identity forward and sums the input's
    cotangents over the axis backward (each rank's output channels
    contribute their part of dx); g gathers the ranks' channel shares
    forward (in the folded layout, each of the 4 sub-position blocks
    share by share) and backward keeps this rank's slice of the cotangent,
    which every rank holds whole and equal. Neither averages.

The gradient rule that goes with them (rpst ``_spatial_loss_and_grads``
:723-731): every rank seeds cotangent 1 on its own copy of the loss, the
loss being the mean over ranks of their copies (the global loss on a row
mesh, the batch share's loss on a data mesh), so the parameter gradients
are averaged over the ranks (``average_grads``).

Under gloo the tensors go through host memory: ``Axis.staged``.

``over_batch(axes)`` is the context the data-parallel step runs the loss
in: the reductions over the batch inside it (BatchNorm's batch statistics,
``nn.attention.bn_batch_stats``; seg_adain's cross entropy) sum over those
ranks too, so they are the global batch's, as rpst's GSPMD step computes
them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis

_BATCH = threading.local()


def _staged(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    return t.detach().cpu() if ax.staged and t.is_cuda else t.detach()


def _reduce(t: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    out = t.detach().clone()
    for ax in axes:
        if ax.size == 1:
            continue
        wire = _staged(out, ax)
        dist.all_reduce(wire, group=ax.group)
        out = wire.to(t.device)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axes), None


def all_reduce(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (an Axis or a sequence of
    them), differentiable: its backward sums the cotangents the same way."""
    axes = tuple(a for a in ((axes,) if isinstance(axes, Axis) else axes)
                 if a.size > 1)
    if not axes:
        return x
    return _AllReduce.apply(x, axes)


def all_gather(t: torch.Tensor, ax: Axis):
    """[t of rank 0, t of rank 1, ...] along ``ax`` (every rank's ``t`` of
    one shape), on t's device; not differentiable."""
    if ax.size == 1:
        return [t]
    wire = _staged(t, ax).contiguous()
    out = [torch.empty_like(wire) for _ in range(ax.size)]
    dist.all_gather(out, wire, group=ax.group)
    return [o.to(t.device) for o in out]


class _Exchange(torch.autograd.Function):
    """(top row, bottom row) of this rank -> (the previous rank's bottom
    row, the next rank's top row); zeros past the ends."""

    @staticmethod
    def forward(ctx, top, bottom, ax):
        ctx.ax = ax
        rows = all_gather(torch.stack([top, bottom]), ax)
        i = ax.index
        prev = rows[i - 1][1] if i > 0 else torch.zeros_like(bottom)
        nxt = rows[i + 1][0] if i < ax.size - 1 else torch.zeros_like(top)
        return prev, nxt

    @staticmethod
    def backward(ctx, g_prev, g_next):
        ax = ctx.ax
        grads = all_gather(torch.stack([g_prev, g_next]), ax)
        i = ax.index
        # my top row was the previous rank's `next`, my bottom row the next
        # rank's `prev`
        d_top = grads[i - 1][1] if i > 0 else torch.zeros_like(g_next)
        d_bottom = grads[i + 1][0] if i < ax.size - 1 \
            else torch.zeros_like(g_prev)
        return d_top, d_bottom, None


def halo_rows(x_l: torch.Tensor, ax: Axis, reflect=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row above, row below) of the row shard ``x_l`` (N, H, W, C), each
    (N, 1, W, C): the neighbours' edge rows inside the image, and at its top
    and bottom ``reflect(x_l, top)`` (the folded reflect ring,
    ``ops.folded._row_ring``, by default; zeros for a zero-padded conv).
    Differentiable in ``x_l`` through the exchange and ``reflect``."""
    if reflect is None:
        from ..ops.folded import _row_ring as reflect
    if ax.size == 1:
        return reflect(x_l, True), reflect(x_l, False)
    prev, nxt = _Exchange.apply(x_l[:, :1], x_l[:, -1:], ax)
    above = reflect(x_l, True) if ax.index == 0 else prev
    below = reflect(x_l, False) if ax.index == ax.size - 1 else nxt
    return above, below


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, (ctx.ax,)), None


def enter_model(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Megatron's f: ``x`` as is; backward, the sum over ``ax`` of the
    cotangents (each rank's channel share contributes its part of dx)."""
    if ax.size == 1 or not x.requires_grad:
        return x
    return _EnterModel.apply(x, ax)


def _gather_cat(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    return torch.cat(all_gather(t.contiguous(), ax), dim=dim)


class _GatherDim(torch.autograd.Function):
    """Shares along ``dim`` of every rank of ``ax`` concatenated in rank
    order (``blocks`` > 1: each of ``blocks`` equal blocks of ``dim`` holds
    one share of every rank, the folded layout's sub-positions);
    backward: this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, ax, dim, blocks):
        dim = dim % x.dim()
        ctx.ax, ctx.dim, ctx.blocks = ax, dim, blocks
        if blocks == 1:
            return _gather_cat(x, ax, dim)
        parts = all_gather(x.contiguous(), ax)
        shape = list(x.shape)
        c = shape[dim] // blocks
        split = shape[:dim] + [blocks, 1, c] + shape[dim + 1:]
        y = torch.cat([p.reshape(split) for p in parts], dim=dim + 1)
        return y.reshape(shape[:dim] + [blocks * ax.size * c]
                         + shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        ax, dim, blocks = ctx.ax, ctx.dim, ctx.blocks
        shape = list(g.shape)
        c = shape[dim] // (blocks * ax.size)
        v = g.reshape(shape[:dim] + [blocks, ax.size, c] + shape[dim + 1:])
        mine = v.narrow(dim + 1, ax.index, 1)
        return (mine.reshape(shape[:dim] + [blocks * c] + shape[dim + 1:])
                .contiguous(), None, None, None)


def gather_channels(x: torch.Tensor, ax: Axis, dim: int = 1) -> torch.Tensor:
    """Megatron's g: every rank's channel share of ``x`` along ``dim``
    (NCHW's 1 by default) concatenated in rank order; backward, this rank's
    slice of the cotangent."""
    if ax.size == 1:
        return x
    return _GatherDim.apply(x, ax, dim, 1)


def gather_folded(x_f: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``gather_channels`` of a folded (N, Hf, Wf, 4 Co/tp) share into the
    full (N, Hf, Wf, 4 Co): channel s Co + o (sub-position s, channel o),
    so each sub-position's block takes every rank's share in turn, not one
    rank's four blocks after another's."""
    if ax.size == 1:
        return x_f
    return _GatherDim.apply(x_f, ax, -1, 4)


def max_over(flag: bool, device=None) -> bool:
    """The maximum over every rank of the run of a host flag (every rank
    calls it together); the flag itself on one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    if dist.get_backend() == "nccl":
        t = t.to(device if device is not None else "cuda")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


@torch.no_grad()
def average_grads(params, axes: Sequence[Axis]) -> None:
    """Each parameter's ``.grad`` replaced by its mean over the ranks of
    ``axes``, one flat buffer per type (a missing gradient counts as
    zeros, and is set to them)."""
    axes = tuple(a for a in axes if a.size > 1)
    if not axes:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    n = 1
    for a in axes:
        n *= a.size
    by_type = {}
    for p in params:
        by_type.setdefault(p.grad.dtype, []).append(p)
    for ps in by_type.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        flat = _reduce(flat, axes) / n
        offset = 0
        for p in ps:
            k = p.grad.numel()
            p.grad.copy_(flat[offset:offset + k].view_as(p.grad))
            offset += k


def mean_over(values: dict, axes: Sequence[Axis]) -> dict:
    """The mean over the ranks of ``axes`` of each detached scalar of
    ``values`` (loss parts, for the log and the non-finite skip)."""
    axes = tuple(a for a in axes if a.size > 1)
    if not axes:
        return values
    keys = sorted(values)
    dt = torch.promote_types(values[keys[0]].dtype, torch.float32)
    stacked = torch.stack([values[k].detach().to(dt) for k in keys])
    n = 1
    for a in axes:
        n *= a.size
    out = _reduce(stacked, axes) / n
    return {k: out[i] for i, k in enumerate(keys)}


@contextlib.contextmanager
def over_batch(axes: Sequence[Axis]):
    """Inside the block, the batch reductions that read ``batch_axes()``
    (BatchNorm's statistics, seg_adain's cross entropy) sum over the ranks
    of ``axes``: the global batch's values."""
    old = getattr(_BATCH, "axes", ())
    _BATCH.axes = tuple(a for a in axes if a.size > 1)
    try:
        yield
    finally:
        _BATCH.axes = old


def batch_axes() -> Tuple[Axis, ...]:
    """The axes a batch reduction spans here (``over_batch``); () alone."""
    return getattr(_BATCH, "axes", ())
