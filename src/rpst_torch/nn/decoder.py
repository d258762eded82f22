"""The VGG-mirror decoder (512 -> 3) of the SANet models and SourceNet; port
of ``rpst.nn.decoder`` (reference ``network/base.py:25-55``, duplicated at
``sanet.py:162-192``): reflection-padded 3x3 convs with ReLU, nearest x2
upsampling at the three stage boundaries, no activation on the final RGB
conv.

Module names follow the flax tree (``conv{i}.Conv_0.weight``), so
``rpst_torch.bridge`` maps rpst's ``decoder`` params one to one. Takes and
returns NCHW tensors (the models that own it are NCHW inside).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import PadConv

# (in, out) of conv0..conv8 and the convs an upsample precedes
MIRROR_DIMS = ((512, 256), (256, 256), (256, 256), (256, 256), (256, 128),
               (128, 128), (128, 64), (64, 64), (64, 3))
MIRROR_UP_BEFORE = (1, 5, 7)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 of an NCHW tensor (each pixel replicated 2 x 2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def upsample_nearest_2x_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 of an NHWC tensor by replication, in any type (exact on
    int8: it commutes with the symmetric quantizer)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class VGGMirrorDecoder(nn.Module):
    """``forward(x)`` (N, 512, H, W) -> (N, 3, 8H, 8W)."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        for i, (cin, cout) in enumerate(MIRROR_DIMS):
            self.add_module(f"conv{i}", PadConv(cin, cout, 3, 1, "reflect",
                                                device=device, dtype=dtype))

    def convs(self):
        return [getattr(self, f"conv{i}").Conv_0
                for i in range(len(MIRROR_DIMS))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(MIRROR_DIMS) - 1
        for i in range(len(MIRROR_DIMS)):
            if i in MIRROR_UP_BEFORE:
                x = upsample_nearest_2x(x)
            x = getattr(self, f"conv{i}")(x)
            if i != last:
                x = F.relu(x)
        return x
