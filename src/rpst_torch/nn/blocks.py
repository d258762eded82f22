"""Convolution blocks and RP (resolution-preserving) stacks; port of
``rpst.nn.blocks``.

The modules take NCHW tensors, PyTorch's layout for ``F.conv2d``; module
and parameter names follow the flax tree (``block_{i}.PadConv_0.Conv_0``),
so ``rpst_torch.bridge`` maps flax params one to one. Every conv is
stride-1: full spatial resolution at every layer. ``Conv2dBlock`` stacks
pad by reflection; ``RPSequence`` (adain, wct) pads with zeros.

A ``Conv2dBlock`` is rpst's: pad -> conv -> ``inception_num`` 1x1 convs
(``inception_{i}``) -> norm (``bn``: flax-semantics ``BatchNorm_0``;
``in``: instance norm) -> activation (``lrelu`` slope 0.2, ``relu``,
``prelu`` with one scalar ``prelu_alpha``)
-> attention (``se``: rpst's SE bottleneck ``SEBottleneck_0``; ``sk``: the
selective-kernel bottleneck ``SKBottleneck_0``).
``RPStack.intermediates_with_attention`` also returns each block's SE
channel weights, which the multiscale models' ``sort`` reads. The norms
``ln`` and ``adain`` raise ``NotImplementedError``, as rpst's Conv2dBlock
refuses them (the reference never defines their classes).

Row shares (``dist.row_shares``, the row-sharded standard layout):
``PadConv``, ``pad2d`` (``nn.rows``) and ``instance_norm`` compute on a
share what one device computes on the whole image: the pad's rows come
from the neighbours (``dist.halo_pad``), the statistics are summed over the
shares. Column padding stays local.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.collectives import row_axis, row_moments
from ..dist.tp import column
from .attention import BatchNorm, SEBottleneck, SKBottleneck
from .rows import _TORCH_PAD, _conv_rows, pad2d


class PadConv(nn.Module):
    """Explicit-padding conv: pad (reflect/replicate/zero), then VALID conv
    (the reference's ``nn.ReflectionPad2d + nn.Conv2d`` pairs). On a row
    share the pad's rows are a halo (``dist.halo_pad``)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 padding: int = 1, pad_type: str = "reflect",
                 use_bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.padding, self.pad_type = padding, pad_type
        self.Conv_0 = nn.Conv2d(in_features, features, kernel_size,
                                bias=use_bias, device=device, dtype=dtype)

    def _padded(self, x, rows: bool = True):
        """The conv of ``x`` padded in both dims (``rows``) or, after a
        halo, in its columns only."""
        p, c = self.padding, self.Conv_0
        if self.pad_type == "zero":  # the conv pads with zeros itself
            return column(lambda v: F.conv2d(v, c.weight, c.bias,
                                             padding=(p if rows else 0, p)),
                          x, c.weight, 1)
        if rows:
            return c(pad2d(x, p, self.pad_type))
        return c(F.pad(x, (p, p, 0, 0), mode=_TORCH_PAD[self.pad_type]))

    def forward(self, x):
        if self.padding and row_axis(x) is not None:
            return _conv_rows(x, self.padding, self.pad_type, self._padded)
        return self._padded(x)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch's InstanceNorm2d without affine on an NCHW tensor: the mean and
    the biased variance over H, W (rpst ``nn/blocks.py:106-110``), reduced
    in float32 at least and rounded to x's type, the normalization in x's
    type (as ``jnp.mean`` / ``jnp.var`` reduce a bfloat16 tensor). On a row
    share, over the whole image (``dist.row_moments``)."""
    v = x.to(torch.promote_types(x.dtype, torch.float32))
    ax = row_axis(x)
    if ax is None:
        mean = v.mean(dim=(2, 3), keepdim=True)
        var = ((v - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    else:
        mean, var = row_moments(v, (2, 3), ax, unbiased=False)
    return (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)


class Conv2dBlock(nn.Module):
    """pad -> conv -> inception 1x1 convs -> norm -> activation [-> SE or
    SK bottleneck] (reference ``network/base.py:114-198``; rpst
    ``nn/blocks.py:118-169``)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 padding: int = 1, norm: str = "none",
                 activation: str = "lrelu", pad_type: str = "reflect",
                 inception_num: int = 0, attention: str = "none",
                 device=None, dtype=None):
        super().__init__()
        if norm not in ("none", "sn", "bn", "in"):
            # rpst raises for ln / adain: the reference never defines them
            raise NotImplementedError(
                f"Conv2dBlock norm {norm!r}: rpst refuses it too (the "
                "reference's 'ln' / 'adain' norm classes are undefined)")
        if activation not in ("lrelu", "relu", "prelu"):
            raise ValueError(f"activation {activation!r}: the port builds "
                             "lrelu, relu and prelu (no model of rpst uses "
                             "another)")
        if attention not in ("none", "se", "sk"):
            raise ValueError(f"unknown attention {attention!r}")
        self.norm, self.activation = norm, activation
        self.inception_num = inception_num or 0
        self.PadConv_0 = PadConv(in_features, features, kernel_size, padding,
                                 pad_type, device=device, dtype=dtype)
        for i in range(self.inception_num):
            self.add_module(f"inception_{i}", nn.Conv2d(
                features, features, 1, device=device, dtype=dtype))
        if norm == "bn":
            self.BatchNorm_0 = BatchNorm(features, device, dtype)
        if activation == "prelu":
            self.prelu_alpha = nn.Parameter(torch.full(
                (), 0.25, device=device, dtype=dtype or torch.float32))
        if attention == "se":
            self.SEBottleneck_0 = SEBottleneck(features, device=device,
                                               dtype=dtype)
        elif attention == "sk":
            self.SKBottleneck_0 = SKBottleneck(features, device=device,
                                               dtype=dtype)

    def _act(self, x):
        if self.activation == "prelu":
            # jnp promotes x with the float32 scalar, as rpst's where does
            dt = torch.promote_types(x.dtype, self.prelu_alpha.dtype)
            x = x.to(dt)
            return torch.where(x >= 0, x, self.prelu_alpha.to(dt) * x)
        return F.leaky_relu(x, 0.2 if self.activation == "lrelu" else 0.0)

    def forward_with_attention(self, x) -> Tuple[torch.Tensor,
                                                 Optional[torch.Tensor]]:
        """(output, SE channel weights (N, C, 1, 1) or None)."""
        x = self.PadConv_0(x)
        for i in range(self.inception_num):
            x = getattr(self, f"inception_{i}")(x)
        if self.norm == "bn":
            x = self.BatchNorm_0(x)
        elif self.norm == "in":
            x = instance_norm(x)
        x = self._act(x)
        if hasattr(self, "SEBottleneck_0"):
            return self.SEBottleneck_0(x)
        if hasattr(self, "SKBottleneck_0"):
            return self.SKBottleneck_0(x), None
        return x, None

    def forward(self, x):
        return self.forward_with_attention(x)[0]


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
        return self.intermediates_with_attention(x)[0]

    def intermediates_with_attention(self, x):
        """Each block's output, and its SE channel weights (None for a
        block without attention)."""
        feats, atts = [], []
        for blk in self.blocks:
            x, att = blk.forward_with_attention(x)
            feats.append(x)
            atts.append(att)
        return feats, atts

    def apply_block(self, x, idx: int):
        return self.blocks[idx](x)


class RPSequence(nn.Module):
    """Plain conv + ReLU sequence ``conv_0 .. conv_{n-1}`` (no Conv2dBlock
    extras), the reference's build_increase/decrease_depth_rp_blocks
    (``base.py:363-396``): zero-padded convs, unlike Conv2dBlock's reflect
    default. NCHW in and out."""

    def __init__(self, dims: Sequence[Tuple[int, int]], kernel_size: int = 3,
                 device=None, dtype=None):
        super().__init__()
        self.num_convs = len(dims)
        for i, (in_d, out_d) in enumerate(dims):
            self.add_module(f"conv_{i}", PadConv(
                in_d, out_d, kernel_size, kernel_size // 2, "zero",
                device=device, dtype=dtype))

    @property
    def convs(self) -> List[PadConv]:
        return [getattr(self, f"conv_{i}") for i in range(self.num_convs)]

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        return x


def init_torch_default(model: nn.Module, seed: int) -> None:
    """Seeded PyTorch Conv2d default init, U(+-1/sqrt(fan_in)) for kernel and
    bias (what rpst's ``torch_conv_kernel_init`` mirrors), and rpst's
    ``nn.Dense`` init for a Linear (dynamic_sanet's threshold MLP, rpst
    ``sanet.py:37-43``; the SE layer's bias-free ``Dense``):
    U(+-1/sqrt(fan_in)) weights, zero biases. BatchNorms keep their
    ones / zeros and running (0, 1), CCAM scales their 0; a module with a
    ``seed_init(generator)`` (the LD v5 upsamplers) draws its own. Values
    are drawn on the CPU from one ``torch.Generator`` in module order, so a
    seed gives the same weights on every device."""
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
            elif isinstance(m, nn.Linear):
                bound = m.in_features ** -0.5 if m.in_features else 0.0
                m.weight.copy_(torch.empty(m.weight.shape).uniform_(
                    -bound, bound, generator=g))
                if m.bias is not None:
                    m.bias.zero_()
            elif hasattr(m, "seed_init"):  # a module with its own init
                m.seed_init(g)
