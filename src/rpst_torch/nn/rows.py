"""The row-share forms of the port's padding, padded convs and pools
(``dist.row_shares``: the row-sharded standard layout), shared by
``nn.blocks``, ``nn.attention``, ``nn.spade``, ``nn.vgg`` and the LD
models. Outside the context (or on one rank, or for a ``dist.Whole``
tensor) each computes exactly the one-device op; on a row share it
computes what one device computes on the whole image: a pad's rows come
from the neighbours (``dist.halo_pad``), a pool that no longer splits
evenly gathers its input (``dist.on_whole``). Column padding stays
local. NCHW throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.collectives import (edge_rows, halo_pad, on_whole, row_axis,
                                sum_rows)
from ..dist.tp import column

_TORCH_PAD = {"reflect": "reflect", "replicate": "replicate",
              "zero": "constant"}


def _rows_for(pad: int, mode: str) -> int:
    """The rows a share needs for a ``pad``-row halo: its neighbours' pad
    rows, and one more for the reflection at the image's edge."""
    return pad + 1 if mode == "reflect" else pad


def pad2d(x: torch.Tensor, pad: int, mode: str = "reflect") -> torch.Tensor:
    """Spatial padding of an NCHW tensor: reflect | replicate | zero. On a
    row share the pad grows the image: its top rows go to the first share
    and its bottom rows to the last, an even split on two shares; on more,
    the tensor is padded whole (``dist.on_whole``)."""
    if pad == 0:
        return x
    ax = row_axis(x)
    if ax is None:
        return F.pad(x, (pad, pad, pad, pad), mode=_TORCH_PAD[mode])
    if ax.size != 2 or x.shape[2] < _rows_for(pad, mode):
        return on_whole(lambda v: pad2d(v, pad, mode), x, 2, ax)
    top = ax.index == 0
    edge = edge_rows(x, pad, top, mode, 2)
    x = torch.cat([edge, x] if top else [x, edge], dim=2)
    return F.pad(x, (pad, pad, 0, 0), mode=_TORCH_PAD[mode])


def _conv_rows(x: torch.Tensor, pad: int, mode: str, fn) -> torch.Tensor:
    """A padded conv on the row share ``x``: ``fn(v, whole)`` on ``x`` with
    the ``pad`` halo rows of ``mode`` (``dist.halo_pad``; ``whole``
    False: ``fn`` pads the columns only), or on the whole tensor where a
    share has too few rows for the halo (``on_whole``, which hands the
    share back; ``whole`` True: ``fn`` pads as one device)."""
    ax = row_axis(x)
    if x.shape[2] < _rows_for(pad, mode):
        return on_whole(lambda v: fn(v, True), x, 2, ax)
    return fn(halo_pad(x, pad, mode, ax, dim=2), False)


def conv2d_rows(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` of an ``nn.Conv2d`` that zero-pads itself (SPADE's, the
    SE / SK bottlenecks'); on a row share its pad rows are the neighbours'
    rows, zeros at the image's edges."""
    p = conv.padding[0] if isinstance(conv.padding, tuple) else 0
    if row_axis(x) is None or p == 0:
        return conv(x)

    def run(v, whole):
        if whole:
            return conv(v)
        return column(lambda u: F.conv2d(
            u, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
            conv.dilation, conv.groups), v, conv.weight, 1)
    return _conv_rows(x, p, "zero", run)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """(N, C): the mean over H, W of an NCHW tensor in its type (the SE and
    SK pools); on a row share, over the whole image."""
    ax = row_axis(x)
    if ax is None:
        return x.mean(dim=(2, 3))
    v = x.to(torch.promote_types(x.dtype, torch.float32))
    n = x.shape[2] * x.shape[3] * ax.size
    return (sum_rows(v.sum(dim=(2, 3)), ax) / n).to(x.dtype)


def maxpool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool of an NCHW tensor with ceil_mode semantics. A row
    share of even height pools alone (it starts on an even row); an odd
    one is pooled whole (``dist.on_whole``)."""
    ax = row_axis(x)
    if ax is not None and x.shape[2] % 2:
        return on_whole(maxpool_ceil, x, 2, ax)
    return F.max_pool2d(x, 2, 2, ceil_mode=True)
