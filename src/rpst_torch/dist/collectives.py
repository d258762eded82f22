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

``row_shares(axis)`` is the context the row-sharded standard layout runs
in (rpst's GSPMD partitioning of the standard program, made explicit):
inside it every 4-D activation a row-share primitive of the port is given
(``nn.rows`` / ``nn.blocks`` pads, padded convs, norms and pools,
``ops.stats``, ``ops.wct``, the SE / SK pools, the CCAM energies, LD's
resize) is this rank's even share of its image's rows,
global height = local height x axis size, and the primitive computes what
one device computes on the whole image:

  * ``halo_pad``: the k rows a pad adds above and below, the neighbours'
    edge rows inside the image, the reflect / replicate / zero rows at its
    top and bottom;
  * ``sum_rows`` / ``row_moments``: sums over the shares, in float64
    across them, and the two-pass mean and variance of one device;
  * ``gather_rows`` / ``on_whole``: where a tensor stops splitting evenly
    (a ceil pool at an odd share, a pad that grows a share on more than
    two, fewer rows than a halo needs) it is gathered once and its stream
    runs whole on every rank as a :class:`Whole` tensor, which the
    primitives compute as one device does; a primitive that gathered hands
    back this rank's rows where the output splits evenly again.

Outside the context, or on one rank, every primitive computes exactly what
it computes without it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis

_BATCH = threading.local()
_ROWS = threading.local()


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


def _halo(x: torch.Tensor, k: int, ax: Axis, dim: int,
          edge: Callable[[torch.Tensor, bool], torch.Tensor]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k rows above, k rows below) the row share ``x`` along ``dim``: the
    neighbours' edge rows through one exchange, ``edge(x, top)`` at the
    image's top and bottom."""
    if ax.size == 1:
        return edge(x, True), edge(x, False)
    h = x.shape[dim]
    prev, nxt = _Exchange.apply(x.narrow(dim, 0, k), x.narrow(dim, h - k, k),
                                ax)
    above = edge(x, True) if ax.index == 0 else prev
    below = edge(x, False) if ax.index == ax.size - 1 else nxt
    return above, below


def halo_rows(x_l: torch.Tensor, ax: Axis, reflect=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row above, row below) of the row shard ``x_l`` (N, H, W, C), each
    (N, 1, W, C): the neighbours' edge rows inside the image, and at its top
    and bottom ``reflect(x_l, top)`` (the folded reflect ring,
    ``ops.folded._row_ring``, by default; zeros for a zero-padded conv).
    Differentiable in ``x_l`` through the exchange and ``reflect``."""
    if reflect is None:
        from ..ops.folded import _row_ring as reflect
    return _halo(x_l, 1, ax, 1, reflect)


def edge_rows(x: torch.Tensor, k: int, top: bool, mode: str,
              dim: int) -> torch.Tensor:
    """The k rows a one-device ``mode`` pad (reflect | replicate | zero)
    puts above (``top``) or below ``x`` along ``dim``: rows k .. 1 (or
    H-2 .. H-1-k) reflected, the edge row repeated, or zeros."""
    h = x.shape[dim]
    if mode == "reflect":
        return x.narrow(dim, 1 if top else h - 1 - k, k).flip(dim)
    if mode == "replicate":
        row = x.narrow(dim, 0 if top else h - 1, 1)
        return torch.cat([row] * k, dim=dim) if k > 1 else row
    if mode == "zero":
        shape = list(x.shape)
        shape[dim] = k
        return x.new_zeros(shape)
    raise ValueError(f"pad mode {mode!r}: reflect, replicate or zero")


def halo_pad(x: torch.Tensor, k: int, mode: str, ax: Axis,
             dim: int = 1) -> torch.Tensor:
    """The row share ``x`` with the k rows a one-device ``mode`` pad of the
    whole image puts around it along ``dim``: the neighbours' edge rows
    inside the image, ``edge_rows`` at its top and bottom (a share needs k
    rows, k + 1 for reflect). Differentiable: the backward sends each
    row's cotangent to the rank that owns the row."""
    above, below = _halo(x, k, ax, dim,
                         lambda v, top: edge_rows(v, k, top, mode, dim))
    return torch.cat([above, x, below], dim=dim)


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


# ------------------------------------------------------------ row shares

class Whole(torch.Tensor):
    """A tensor of a row-share run that every rank holds whole (a stream
    ``gather_rows`` started): the row-share primitives compute it as one
    device does, and torch functions of it return ``Whole`` tensors, so
    the stream stays whole until a primitive hands back a share."""


@contextlib.contextmanager
def row_shares(ax: Axis):
    """Inside the block the row-share primitives read each activation as
    this rank's even share of the rows of ``ax`` (a size-1 axis: one
    device). Every rank of ``ax`` enters it together."""
    old = getattr(_ROWS, "axis", None)
    _ROWS.axis = ax if ax.size > 1 else None
    try:
        yield
    finally:
        _ROWS.axis = old


def row_axis(x: Optional[torch.Tensor] = None) -> Optional[Axis]:
    """The axis whose row share ``x`` is inside ``row_shares`` (without
    ``x``: the context's axis); None outside it, on one rank, or for a
    ``Whole`` tensor: compute as one device does."""
    ax = getattr(_ROWS, "axis", None)
    return None if isinstance(x, Whole) else ax


class _GatherRows(torch.autograd.Function):
    """Every rank's rows along ``dim`` concatenated in rank order; backward:
    the cotangents summed over the ranks (each rank's copy of the whole
    stream feeds its own outputs), this rank's rows of the sum."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.h = ax, dim, x.shape[dim]
        return _gather_cat(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        g = _reduce(g, (ctx.ax,))
        return g.narrow(ctx.dim, ctx.ax.index * ctx.h, ctx.h), None, None


def gather_rows(x: torch.Tensor, dim: int, ax: Axis) -> Whole:
    """The whole tensor from every rank's row share (``x`` itself where it
    is already ``Whole``), on every rank, differentiable."""
    if isinstance(x, Whole):
        return x
    return _GatherRows.apply(x.as_subclass(torch.Tensor), ax,
                             dim).as_subclass(Whole)


def on_whole(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             dim: int, ax: Axis) -> torch.Tensor:
    """``fn`` on the whole of the row share ``x`` on every rank (exact; the
    redundant work is a layer's). Its output comes back as this rank's
    even share of its rows (a slice, no communication), or as ``Whole``
    where its height does not divide by the axis."""
    y = fn(gather_rows(x, dim, ax))
    h = y.shape[dim]
    if h % ax.size:
        return y.as_subclass(Whole)
    step = h // ax.size
    return y.as_subclass(torch.Tensor).narrow(dim, ax.index * step, step)


def whole_rows(y: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The whole tensor, a plain one, from a row share or a ``Whole``
    tensor (a run's output: the image on every rank)."""
    return gather_rows(y, dim, ax).as_subclass(torch.Tensor)


def sum_rows(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over the row shares of ``ax`` of a partial sum ``t``, in
    float64 across them (as ``fast_path_spatial._folded_stats`` sums),
    differentiable; float64."""
    return all_reduce(t.double(), ax)


def row_moments(v: torch.Tensor, dims, ax: Axis, unbiased: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, variance) over ``dims`` (the row dim among them) of the whole
    image from the row share ``v``, keepdim, in v's type, in one device's
    two-pass form: the shares' sums all-reduced for the mean, then the
    sums of squared deviations about it (a one-pass E[x^2] - mean^2 reads
    float32 noise above 1e-4 against one device); variance over n - 1
    (at least 1) when ``unbiased``, else over n."""
    dims = tuple(dims)
    n = ax.size
    for d in dims:
        n *= v.shape[d]
    mean = (sum_rows(v.sum(dim=dims, keepdim=True), ax) / n).to(v.dtype)
    dev = sum_rows(((v - mean) ** 2).sum(dim=dims, keepdim=True), ax)
    var = dev / (max(n - 1, 1) if unbiased else n)
    return mean, var.to(v.dtype)
