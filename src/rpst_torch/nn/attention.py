"""SE channel attention; port of ``rpst.nn.attention`` (reference
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
``batch_stats`` ``mean`` / ``var``. ``SKLayer`` / ``SKBottleneck`` stay with
the Conv2dBlock options (ROADMAP.md section A slice 4's remainder).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def bn_batch_stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Batch mean and biased variance over ``dims`` in float32, in flax's
    fast form: E[x^2] - E[x]^2, clamped at 0."""
    v = x.float()
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
        the old values back: ``train.step``)."""
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
        y = x.mean(dim=(2, 3))
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
        out = F.relu(self.bn2(self.conv2(out)))
        out, att = self.SELayer_0(self.bn3(self.conv3(out)))
        return F.relu(out + x), att
