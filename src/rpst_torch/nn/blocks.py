"""Convolution blocks and RP (resolution-preserving) stacks; port of
``rpst.nn.blocks`` for the options the flagship uses.

The modules take NCHW tensors, PyTorch's layout for ``F.conv2d``; module
and parameter names follow the flax tree (``block_{i}.PadConv_0.Conv_0``),
so ``rpst_torch.bridge`` maps flax params one to one. Every conv is
stride-1 with reflection padding: full spatial resolution at every layer.

Not ported in this slice (they raise ``NotImplementedError``): inception
1x1 stacks, SE/SK attention, batch/instance norm and prelu, which belong to
ROADMAP.md section A slices 4 (sel_multi_adain) and 5 (the wide families).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def pad2d(x: torch.Tensor, pad: int, mode: str = "reflect") -> torch.Tensor:
    """Spatial padding of an NCHW tensor: reflect | replicate | zero."""
    if pad == 0:
        return x
    tmode = {"reflect": "reflect", "replicate": "replicate",
             "zero": "constant"}[mode]
    return F.pad(x, (pad, pad, pad, pad), mode=tmode)


class PadConv(nn.Module):
    """Explicit-padding conv: pad (reflect/replicate/zero), then VALID conv
    (the reference's ``nn.ReflectionPad2d + nn.Conv2d`` pairs)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 padding: int = 1, pad_type: str = "reflect",
                 use_bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.padding, self.pad_type = padding, pad_type
        self.Conv_0 = nn.Conv2d(in_features, features, kernel_size,
                                bias=use_bias, device=device, dtype=dtype)

    def forward(self, x):
        return self.Conv_0(pad2d(x, self.padding, self.pad_type))


_SLICE_OF_OPTION = {
    "inception_num": "slice 4 (sel_multi_adain) and the inception configs",
    "attention": "slice 4 (sel_multi_adain's SE bottleneck)",
    "norm": "slice 5 (the wide standard-layout families)",
    "activation": "slice 5 (the wide standard-layout families)",
}


class Conv2dBlock(nn.Module):
    """pad -> conv -> activation (reference ``network/base.py:114-198``),
    with norm ``none`` and activation ``lrelu`` (slope 0.2) or ``relu``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 padding: int = 1, norm: str = "none",
                 activation: str = "lrelu", pad_type: str = "reflect",
                 inception_num: int = 0, attention: str = "none",
                 device=None, dtype=None):
        super().__init__()
        for opt, value, ok in (
                ("inception_num", inception_num, not inception_num),
                ("attention", attention, attention == "none"),
                ("norm", norm, norm in ("none", "sn")),
                ("activation", activation, activation in ("lrelu", "relu"))):
            if not ok:
                raise NotImplementedError(
                    f"Conv2dBlock option {opt}={value!r} is not ported yet: "
                    f"ROADMAP.md section A {_SLICE_OF_OPTION[opt]}")
        self.slope = 0.2 if activation == "lrelu" else 0.0
        self.PadConv_0 = PadConv(in_features, features, kernel_size, padding,
                                 pad_type, device=device, dtype=dtype)

    def forward(self, x):
        return F.leaky_relu(self.PadConv_0(x), self.slope)


# ---------------------------------------------------------------------------
# RP stack dim plans: [(in_dim, out_dim), ...] of length block_num, the
# channel progressions of the reference factories (base.py:201-396).
# ---------------------------------------------------------------------------

def rp_increase_dims(block_num: int, in_dim: int, hidden_dim: int,
                     out_dim: int) -> List[Tuple[int, int]]:
    """build_increase_depth_rp_blocks (base.py:363-379): doubling width."""
    dims = [(in_dim, hidden_dim)]
    h = hidden_dim
    for _ in range(block_num - 2):
        dims.append((h, h * 2))
        h *= 2
    dims.append((h, out_dim))
    return dims


def rp_decrease_dims(block_num: int, in_dim: int, hidden_dim: int,
                     out_dim: int) -> List[Tuple[int, int]]:
    """build_decrease_depth_rp_blocks (base.py:382-396): halving width."""
    dims = [(in_dim, hidden_dim)]
    h = hidden_dim
    for _ in range(block_num - 2):
        dims.append((h, h // 2))
        h //= 2
    dims.append((h, out_dim))
    return dims


def rp_deeper_dims(block_num: int, in_dim: int, hidden_dim: int,
                   out_dim: int) -> List[Tuple[int, int]]:
    """rp_deeper_conv_blocks (base.py:231-257): same progression as increase."""
    return rp_increase_dims(block_num, in_dim, hidden_dim, out_dim)


def rp_constant_dims(block_num: int, in_dim: int, hidden_dim: int,
                     out_dim: int) -> List[Tuple[int, int]]:
    """rp_constant_conv_blocks (base.py:260-285): constant width."""
    dims = [(in_dim, hidden_dim)]
    for _ in range(block_num - 2):
        dims.append((hidden_dim, hidden_dim))
    dims.append((hidden_dim, out_dim))
    return dims


def rp_shallower_dims(block_num: int, in_dim: int, hidden_dim: int,
                      out_dim: int) -> List[Tuple[int, int]]:
    """rp_shallower_conv_blocks (base.py:288-314): halving width."""
    return rp_decrease_dims(block_num, in_dim, hidden_dim, out_dim)


class RPStack(nn.Module):
    """Conv2dBlocks ``block_0 .. block_{n-1}`` that can expose every
    intermediate feature (the multiscale models fuse at each layer)."""

    def __init__(self, dims: Sequence[Tuple[int, int]], kernel_size: int = 3,
                 padding: int = 1, activation: str = "lrelu",
                 inception_num: int = 0, attention: str = "none",
                 device=None, dtype=None):
        super().__init__()
        self.num_blocks = len(dims)
        for i, (in_d, out_d) in enumerate(dims):
            self.add_module(f"block_{i}", Conv2dBlock(
                in_d, out_d, kernel_size, padding, activation=activation,
                inception_num=inception_num, attention=attention,
                device=device, dtype=dtype))

    @property
    def blocks(self) -> List[Conv2dBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.num_blocks)]

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x

    def intermediates(self, x) -> List[torch.Tensor]:
        feats = []
        for blk in self.blocks:
            x = blk(x)
            feats.append(x)
        return feats

    def apply_block(self, x, idx: int):
        return self.blocks[idx](x)


def init_torch_default(model: nn.Module, seed: int) -> None:
    """Seeded PyTorch Conv2d default init, U(+-1/sqrt(fan_in)) for kernel and
    bias (what rpst's ``torch_conv_kernel_init`` mirrors). Values are drawn
    on the CPU from one ``torch.Generator`` in module order, so a seed gives
    the same weights on every device."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                bound = fan_in ** -0.5
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape).uniform_(
                            -bound, bound, generator=g))
