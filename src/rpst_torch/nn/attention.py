"""SE and SK channel attention; port of ``rpst.nn.attention`` (reference
``network/attention.py``):

  * ``SELayer``: squeeze-excitation (attention.py:5-22);
  * ``SEBottleneck``: 1x1 -> 3x3 -> 1x1 convs with BatchNorm, SE and a
    residual (attention.py:25-66), sel_multi_adain's attention block.

NCHW, as the port's other modules. ``BatchNorm`` is flax's (rpst's):
train mode normalizes by the batch statistics in the ``E[x^2] - E[x]^2``
form in float32 and moves the running statistics with momentum 0.9 by the
same biased variance (torch's BatchNorm2d would move them by the unbiased
one); eval mode uses the running statistics. Its names are torch's
(``weight``, ``bias``, ``running_mean``, ``running_var``), so a
reference ``.pth`` maps onto them; ``bridge`` maps flax's ``scale`` and
``batch_stats`` ``mean`` / ``var``.

  * ``SKLayer``: selective kernel, M dilated 3x3 grouped convs with zero
    padding and a softmax over the branches (attention.py:69-105);
  * ``SKBottleneck``: 1x1 conv-bn-relu -> SK -> 1x1 conv-bn -> + residual
    -> relu (attention.py:108-130), the Conv2dBlock's ``attention: sk``.

On a row share (``dist.row_shares``) the pools are the whole image's and
the padded convs read their pad rows from the neighbours; an eval
BatchNorm is row-local.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dist.collectives import all_reduce, batch_axes
from .rows import conv2d_rows, spatial_mean

BN_MOMENTUM = 0.9
BN_EPS = 1e-5

# set while a checkpointed forward is recomputed in the backward
# (``train.step``'s remat): the running statistics moved once, in the
# forward, as rpst's pure ``jax.checkpoint`` takes them from its one
# forward
_FROZEN = threading.local()


@contextlib.contextmanager
def running_stats_frozen():
    """Inside the block ``BatchNorm.update_running`` leaves the running
    statistics where they are (``torch.utils.checkpoint``'s recompute
    context: a recomputed train forward would move them twice)."""
    old = getattr(_FROZEN, "on", False)
    _FROZEN.on = True
    try:
        yield
    finally:
        _FROZEN.on = old


def bn_batch_stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Batch mean and biased variance over ``dims`` in float32 at least
    (float64 features stay float64, as flax promotes them), in flax's fast
    form: E[x^2] - E[x]^2, clamped at 0. Inside ``dist.over_batch`` (a
    multi-device step) the sums span every rank's share too: the global
    batch's statistics, as rpst's GSPMD step takes them."""
    v = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = batch_axes()
    if axes:
        dims = (dims,) if isinstance(dims, int) else tuple(dims)
        count = float(np.prod([v.shape[d] for d in dims]))
        for ax in axes:
            count *= ax.size
        sums = all_reduce(torch.stack([v.sum(dim=dims),
                                       (v * v).sum(dim=dims)]), axes)
        mean = sums[0] / count
        return mean, torch.clamp(sums[1] / count - mean * mean, min=0.0)
    mean = v.mean(dim=dims)
    var = torch.clamp((v * v).mean(dim=dims) - mean * mean, min=0.0)
    return mean, var


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW tensors:
    batch statistics in train mode (and the running ones moved in place),
    the running statistics in eval mode. ``affine=False`` is flax's
    ``use_scale=False, use_bias=False`` (SPADE's param-free norm): no
    parameters, the normalization in float32, cast to x's type."""

    def __init__(self, features: int, device=None, dtype=None,
                 affine: bool = True):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(features, **kw))
            self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """running = 0.9 running + 0.1 batch, in place (a skipped step puts
        the old values back: ``train.step``); nothing inside
        ``running_stats_frozen``."""
        if getattr(_FROZEN, "on", False):
            return
        with torch.no_grad():
            for buf, v in ((self.running_mean, mean),
                           (self.running_var, var)):
                buf.copy_(BN_MOMENTUM * buf + (1 - BN_MOMENTUM) * v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = bn_batch_stats(x, (0, 2, 3))
            self.update_running(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        if not self.affine:  # flax's use_scale / use_bias False: float32
            return ((x.float() - mean.view(shape))
                    * torch.rsqrt(var + BN_EPS).view(shape)).to(x.dtype)
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mean.view(shape).to(x.dtype)) * inv.view(shape).to(x.dtype)
                + self.bias.view(shape).to(x.dtype))


class SELayer(nn.Module):
    """Squeeze-excitation: (scaled features, attention (N, C, 1, 1))."""

    def __init__(self, channel: int, reduction: int = 16, device=None,
                 dtype=None):
        super().__init__()
        hidden = max(channel // reduction, 1)
        kw = dict(bias=False, device=device, dtype=dtype)
        self.Dense_0 = nn.Linear(channel, hidden, **kw)
        self.Dense_1 = nn.Linear(hidden, channel, **kw)

    def forward(self, x):
        y = spatial_mean(x)
        y = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(y))))
        att = y[:, :, None, None]
        return x * att, att


class SEBottleneck(nn.Module):
    """conv1x1-bn-relu -> conv3x3 (zero pad)-bn-relu -> conv1x1-bn-SE ->
    + residual -> relu, no conv bias (``inplanes == planes`` at every use,
    so no downsample branch)."""

    def __init__(self, planes: int, reduction: int = 16, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.conv1 = nn.Conv2d(planes, planes, 1, **kw)
        self.bn1 = BatchNorm(planes, device, dtype)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, **kw)
        self.bn2 = BatchNorm(planes, device, dtype)
        self.conv3 = nn.Conv2d(planes, planes, 1, **kw)
        self.bn3 = BatchNorm(planes, device, dtype)
        self.SELayer_0 = SELayer(planes, reduction, device, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(conv2d_rows(self.conv2, out)))
        out, att = self.SELayer_0(self.bn3(self.conv3(out)))
        return F.relu(out + x), att


class SKLayer(nn.Module):
    """Selective kernel: ``M`` 3x3 convs ``branch_{i}`` of dilation and zero
    padding 1 + i, grouped by 32 where the input width divides by 32 (else
    1), each through a ReLU; their sum's global mean through ``fc1`` (to
    max(in_ch // r, L) channels) -> ReLU -> ``fc2`` (to out_channels * M)
    gives per-channel weights, softmaxed over the M branches, which mix
    the branches. No conv has a bias."""

    def __init__(self, in_channels: int, out_channels: int, M: int = 2,
                 r: int = 16, L: int = 32, device=None, dtype=None):
        super().__init__()
        self.M, self.out_channels = M, out_channels
        d = max(in_channels // r, L)
        groups = 32 if in_channels % 32 == 0 else 1
        kw = dict(bias=False, device=device, dtype=dtype)
        for i in range(M):
            self.add_module(f"branch_{i}", nn.Conv2d(
                in_channels, out_channels, 3, padding=1 + i,
                dilation=1 + i, groups=groups, **kw))
        self.fc1 = nn.Conv2d(out_channels, d, 1, **kw)
        self.fc2 = nn.Conv2d(d, out_channels * M, 1, **kw)

    def forward(self, x):
        branches = [F.relu(conv2d_rows(getattr(self, f"branch_{i}"), x))
                    for i in range(self.M)]
        u = branches[0]
        for b in branches[1:]:
            u = u + b
        z = F.relu(self.fc1(spatial_mean(u)[:, :, None, None]))
        ab = self.fc2(z).reshape(x.shape[0], self.M, self.out_channels)
        ab = torch.softmax(ab, dim=1).to(branches[0].dtype)
        out = branches[0] * ab[:, 0, :, None, None]
        for i in range(1, self.M):
            out = out + branches[i] * ab[:, i, :, None, None]
        return out


class SKBottleneck(nn.Module):
    """conv1x1-bn-relu -> SK -> conv1x1-bn -> + residual -> relu, no conv
    bias (``inplanes == planes``)."""

    def __init__(self, planes: int, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.conv1 = nn.Conv2d(planes, planes, 1, **kw)
        self.bn1 = BatchNorm(planes, device, dtype)
        self.SKLayer_0 = SKLayer(planes, planes, device=device, dtype=dtype)
        self.conv3 = nn.Conv2d(planes, planes, 1, **kw)
        self.bn3 = BatchNorm(planes, device, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn3(self.conv3(self.SKLayer_0(out)))
        return F.relu(out + x)
