"""The SPADE decoder; port of ``rpst.nn.spade`` (reference
``network/spade_rp.py:21-146``):

  * ``SPADE``: a param-free norm (instance norm, or flax's BatchNorm without
    scale and bias, momentum 0.9, for 'batch' / 'syncbatch') modulated per
    pixel by gamma and beta from a 3x3 conv MLP on the condition map;
  * ``SpadeResnetBlock``: two SPADE + LeakyReLU(0.2) + conv units, with a
    learned bias-free 1x1 shortcut when the widths differ;
  * ``SpadeDecoder``: a head and two middle blocks at 16 * ndf, four halving
    blocks down to ndf, a 3x3 conv to RGB.

NCHW, as the port's other modules; every conv is zero-padded and stride 1,
so the condition always has the features' size (rpst's nearest resize is
the identity there; here the sizes are asserted equal).

On a row share (``dist.row_shares``) the 3x3 convs read their zero pad's
rows from the neighbours (``blocks.conv2d_rows``) and the instance norm is
the whole image's; the eval BatchNorm reads running statistics, row-local.

Types, as rpst's: its SPADE convs take no dtype, so flax promotes their
bfloat16 inputs to the float32 parameters and the decoder computes float32
whatever the working type. Only the param-free norms see the working type:
the instance norm runs in its input's type (bfloat16 for the head's, which
normalizes the encoders' features), the BatchNorm's output is cast to the
working type (``dtype``, rpst's ``BatchNorm(dtype=...)``). The decoder
therefore runs with autocast off and the working type passed in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention import BatchNorm
from .blocks import instance_norm
from .rows import conv2d_rows

PARAM_FREE_NORMS = ("instance", "batch", "syncbatch")


def _conv(cin: int, cout: int, ks: int, bias: bool = True, device=None):
    return nn.Conv2d(cin, cout, ks, padding=ks // 2, bias=bias,
                     device=device)


def _f32_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The conv on x promoted to the float32 parameters (flax's
    ``promote_dtype``)."""
    return conv2d_rows(conv, x.to(conv.weight.dtype))


class SPADE(nn.Module):
    """Param-free norm of ``norm_nc`` channels modulated by the condition:
    ``mlp_shared`` (cond -> 128, relu), ``mlp_gamma``, ``mlp_beta`` (128 ->
    norm_nc), ``pf_bn`` for the batch norms."""

    def __init__(self, norm_nc: int, param_free_norm_type: str = "instance",
                 condition_nc: int = 512, nhidden: int = 128, device=None):
        super().__init__()
        if param_free_norm_type not in PARAM_FREE_NORMS:
            raise ValueError(f"{param_free_norm_type} is not a recognized "
                             "param-free norm type in SPADE")
        self.norm_type = param_free_norm_type
        if param_free_norm_type != "instance":
            self.pf_bn = BatchNorm(norm_nc, affine=False, device=device)
        self.mlp_shared = _conv(condition_nc, nhidden, 3, device=device)
        self.mlp_gamma = _conv(nhidden, norm_nc, 3, device=device)
        self.mlp_beta = _conv(nhidden, norm_nc, 3, device=device)

    def forward(self, x: torch.Tensor, condition: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if condition.shape[2:] != x.shape[2:]:
            raise ValueError(f"SPADE condition {tuple(condition.shape)} and "
                             f"features {tuple(x.shape)} differ in size (the "
                             "RP decoder is stride 1 throughout)")
        if self.norm_type == "instance":
            normalized = instance_norm(x)
        else:
            normalized = self.pf_bn(x).to(dtype or x.dtype)
        actv = F.relu(_f32_conv(self.mlp_shared, condition))
        gamma = conv2d_rows(self.mlp_gamma, actv)
        beta = conv2d_rows(self.mlp_beta, actv)
        return normalized * (1.0 + gamma) + beta


class SpadeResnetBlock(nn.Module):
    """``norm_0 -> lrelu -> conv_0 -> norm_1 -> lrelu -> conv_1`` plus the
    shortcut ``conv_s(norm_s(x))`` when fin != fout."""

    def __init__(self, fin: int, fout: int, spade_norm: str = "instance",
                 condition_nc: int = 512, device=None):
        super().__init__()
        self.learned_shortcut = fin != fout
        fmiddle = min(fin, fout)
        kw = dict(condition_nc=condition_nc, device=device)
        if self.learned_shortcut:
            self.conv_s = _conv(fin, fout, 1, bias=False, device=device)
            self.norm_s = SPADE(fin, spade_norm, **kw)
        self.conv_0 = _conv(fin, fmiddle, 3, device=device)
        self.norm_0 = SPADE(fin, spade_norm, **kw)
        self.conv_1 = _conv(fmiddle, fout, 3, device=device)
        self.norm_1 = SPADE(fmiddle, spade_norm, **kw)

    def forward(self, x, condition, dtype=None):
        def actvn(v):
            return F.leaky_relu(v, 0.2)
        x_s = (self.conv_s(self.norm_s(x, condition, dtype))
               if self.learned_shortcut else x)
        dx = conv2d_rows(self.conv_0, actvn(self.norm_0(x, condition, dtype)))
        dx = conv2d_rows(self.conv_1,
                         actvn(self.norm_1(dx, condition, dtype)))
        return x_s + dx


class SpadeDecoder(nn.Module):
    """``head`` (condition_nc -> 16 ndf), ``rp_middle_0`` / ``_1``, ``d1`` ..
    ``d4`` (16 ndf -> ndf), ``conv_img`` (ndf -> 3)."""

    def __init__(self, ndf: int, spade_norm: str = "instance",
                 condition_nc: int = 512, device=None):
        super().__init__()
        widths = [(condition_nc, 16 * ndf), (16 * ndf, 16 * ndf),
                  (16 * ndf, 16 * ndf), (16 * ndf, 8 * ndf),
                  (8 * ndf, 4 * ndf), (4 * ndf, 2 * ndf), (2 * ndf, ndf)]
        self.names = ("head", "rp_middle_0", "rp_middle_1", "d1", "d2", "d3",
                      "d4")
        for name, (fin, fout) in zip(self.names, widths):
            self.add_module(name, SpadeResnetBlock(
                fin, fout, spade_norm, condition_nc, device=device))
        self.conv_img = _conv(ndf, 3, 3, device=device)

    def forward(self, feat: torch.Tensor, condition: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``feat`` (N, condition_nc, H, W) decoded under ``condition``
        (N, condition_nc, H, W), both in the working type ``dtype`` (None:
        float32) -> (N, 3, H, W) float32."""
        with torch.autocast(feat.device.type, enabled=False):
            x = feat
            for name in self.names:
                x = getattr(self, name)(x, condition, dtype)
            return _f32_conv(self.conv_img, x)
