"""The LD ("large-receptive-field dual-branch") AdaIN RP family; port of
``rpst.models.ld_adain`` (reference ``network/adain_rp.py:484-858``).

Five variants pair a small-receptive-field branch (a 3x3 Conv2dBlock) with
a big one at every RP layer and fuse them by a channel concat:

  * v1 (``ld_adain``): the big branch is a 7x7 Conv2dBlock (3x3 at layer
    0); widths double per layer; one fused stream;
  * v2 (``ld_adain2``): the big branch is ``VGGishBigBranch`` (1x1 conv,
    two reflect 3x3 relu convs, a ceil-mode 2x2 max pool, a trailing
    reflect pad), resized back by ``resize_nearest``; one fused stream;
  * v3 (``ld_adain3``): two separate streams of constant width (fine and
    coarse), concatenated per layer for the decoder;
  * v4 (``ld_adain4``): v3's streams with the decoder's concat decode, its
    fusion taken from the content side;
  * v5 (``ld_adain5``): v4 with learned ``NonOverlapConvTranspose``
    upsamplers in place of the nearest resize.

Two fusion rules, both as rpst has them: v1-v3 re-fuse with the running
``adain(stylized, style_feat)`` (reference ``adain_rp.py:550``), v4 / v5
concat the decoder's stream with ``adain(content_feat, style_feat)``
(``:791``). With ``stylized_layers < layer_num`` v1-v3 skip the fusion at
the shallower layers (the reference adds ``stylized + []`` there, a
TypeError; rpst skips it cleanly).

Modules take NHWC images at ``forward`` and run NCHW inside; module and
parameter names follow the flax tree (``rp_enc{i}_small_revf``,
``rp_enc{i}_big_revf`` with ``conv1x1`` / ``conv_a`` / ``conv_b`` for the
pooled branch, ``up_{i}`` with its (s, s, C, Co) ``kernel`` in flax's
layout, ``rp_dec{i}``), so ``rpst_torch.bridge`` maps the flax params one
to one. With ``use_mask`` and label maps in test mode
(``forward(..., test_mode=True, c_labels=, s_labels=)``) every fusion is
the segment-masked AdaIN of ``ops.segment``, of the content feature (v1-v3
too: rpst's masked branch fuses ``cf``, not the running stylized,
``ld_adain.py:327-330``); without labels ``use_mask`` serves plain AdaIN,
as in rpst.

On a row share (``dist.row_shares``) the pooled branch's ceil pool and
trailing pad gather a tensor once it stops splitting evenly, and the
coarse stream then runs whole (``dist.on_whole``); ``resize_nearest``
takes each destination row's source by its global index, from the share
where every rank's sources are local, else from the gathered source, and
hands back the share's rows.

rpst's measurement-only int8 switches of the pooled branch and the v5
upsampler (``VGGISH_INT8``, ``NONOVERLAP_INT8``) are TPU hardware hooks
and are not ported.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.collectives import Whole, gather_rows, row_axis
from ..dist.tp import column
from ..nn.blocks import Conv2dBlock, PadConv, pad2d
from ..nn.rows import maxpool_ceil
from .adain_rp import _adain_nchw, _fuse


def resize_nearest(x: torch.Tensor, h: int, w: int,
                   channels_last: bool = True) -> torch.Tensor:
    """Nearest resize of an NHWC (or, ``channels_last=False``, NCHW) tensor
    to (h, w) by torch's rule ``src = floor(dst * in / out)``, in integer
    arithmetic as rpst writes it (``F.interpolate`` computes the scale in
    floating point, which can pick another source at the non-integer ratios
    the pooled branch reaches, (H/2 + 2) -> H)."""
    hd, wd = (1, 2) if channels_last else (2, 3)
    wi = torch.arange(w, device=x.device) * x.shape[wd] // w
    ax = row_axis()
    if ax is None:
        hi = torch.arange(h, device=x.device) * x.shape[hd] // h
        return x.index_select(hd, hi).index_select(wd, wi)
    # row shares: (h, w) is the size of this rank's share of the output
    whole = isinstance(x, Whole)
    h_in = x.shape[hd] * (1 if whole else ax.size)
    src = torch.arange(h * ax.size) * h_in // (h * ax.size)
    if not whole:
        hx = x.shape[hd]
        if all(int(src[r * h]) >= r * hx and int(src[(r + 1) * h - 1])
               < (r + 1) * hx for r in range(ax.size)):
            mine = src[ax.index * h:(ax.index + 1) * h] - ax.index * hx
            return x.index_select(hd, mine.to(x.device)).index_select(wd, wi)
        x = gather_rows(x, hd, ax)
    mine = src[ax.index * h:(ax.index + 1) * h].to(x.device)
    return (x.as_subclass(torch.Tensor).index_select(hd, mine)
            .index_select(wd, wi))


class VGGishBigBranch(nn.Module):
    """The pooled big branch of v2-v5 (reference ``adain_rp.py:586-594``):
    ``conv1x1`` (linear) -> (reflect pad, 3x3 conv, relu) x 2 (``conv_a``,
    ``conv_b``) -> 2x2/2 max pool, ceil mode (flax's SAME padding) ->
    [a trailing reflect pad of one pixel, v2 / v3]. NCHW in and out."""

    def __init__(self, in_features: int, features: int,
                 trailing_pad: bool = True, device=None, dtype=None):
        super().__init__()
        self.trailing_pad = trailing_pad
        self.conv1x1 = nn.Conv2d(in_features, features, 1, device=device,
                                 dtype=dtype)
        self.conv_a = PadConv(features, features, 3, 1, "reflect",
                              device=device, dtype=dtype)
        self.conv_b = PadConv(features, features, 3, 1, "reflect",
                              device=device, dtype=dtype)

    def forward(self, x):
        x = self.conv1x1(x)
        x = F.relu(self.conv_b(F.relu(self.conv_a(x))))
        x = maxpool_ceil(x)
        return pad2d(x, 1) if self.trailing_pad else x


class NonOverlapConvTranspose(nn.Module):
    """A transposed conv whose kernel size equals its stride s (the v5
    upsamplers): each output pixel takes exactly one tap, so it is a 1x1
    projection C -> s * s * Co on the coarse grid and a depth-to-space, one
    matrix product (rpst's exact rewrite of flax's ``nn.ConvTranspose``,
    whose taps it applies spatially flipped). ``kernel`` (s, s, C, Co) in
    flax's layout and ``bias`` (Co,). NCHW in and out. On a ``model`` mesh
    axis it is column parallel (``dist.tp``): a share of Co a rank."""

    tp_column_kernel = "kernel"

    def __init__(self, in_features: int, features: int, stride: int,
                 device=None, dtype=None):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(torch.zeros(
            stride, stride, in_features, features, device=device,
            dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, device=device,
                                             dtype=dtype))

    def seed_init(self, generator: torch.Generator) -> None:
        """flax's defaults: a kernel of variance 1 / fan_in (lecun normal,
        fan_in = s * s * C), a zero bias."""
        s, _, c, _ = self.kernel.shape
        with torch.no_grad():
            self.kernel.copy_(torch.randn(self.kernel.shape,
                                          generator=generator)
                              * (s * s * c) ** -0.5)
            self.bias.zero_()

    def forward(self, x):
        return column(self._project, x, self.kernel, 1)

    def _project(self, x):
        n, c, h, w = x.shape
        s, co = self.stride, self.kernel.shape[3]
        km = self.kernel.flip(0, 1).permute(2, 0, 1, 3).reshape(c, s * s * co)
        y = x.permute(0, 2, 3, 1).reshape(-1, c) @ km.to(x.dtype)
        y = y.reshape(n, h, w, s, s, co).permute(0, 5, 1, 3, 2, 4)
        y = y.reshape(n, co, h * s, w * s)
        return y + self.bias.to(y.dtype)[None, :, None, None]


def ld_widths(variant: int, layer_num: int, hidden_dim: int) -> List[int]:
    """Each layer's branch width: doubling for v1 / v2, constant else."""
    if variant in (1, 2):
        return [hidden_dim * 2 ** i for i in range(layer_num)]
    return [hidden_dim] * layer_num


def ld_decoder_dims(variant: int, layer_num: int, hidden_dim: int,
                    stylized_layers: int):
    """[(in, out)] of the decoder convs ``rp_dec{i}``
    (``_build_decoders``, reference ``adain_rp.py:517-536, 670-688,
    751-778``; flax infers the in-widths, torch needs them)."""
    enc_out = ld_widths(variant, layer_num, hidden_dim)[-1]
    feat = 2 * enc_out  # a concat feature's width at the deepest layer
    outs, hidden = [], enc_out
    for i in range(layer_num - 1):
        if variant in (1, 2):
            outs.append(hidden if i < stylized_layers - 1 else hidden // 2)
            hidden //= 2
        else:
            outs.append(hidden * 2 if i < stylized_layers - 1 else hidden)
    outs.append(3)
    dims, cin = [], feat
    for i, out in enumerate(outs):
        dims.append((cin, out))
        # v4 / v5 concat the decoder's stream with a content-side fusion of
        # the next shallower layer's feature (2 * hidden wide)
        cin = out + (2 * hidden_dim if variant in (4, 5) else 0)
    return dims


class LDAdaINRP(nn.Module):
    """The LD family (``variant`` 1-5) with rpst's module names."""

    def __init__(self, variant: int = 1, layer_num: int = 5,
                 hidden_dim: int = 16, stylized_layers: int = 5,
                 inception_num: int = 0, use_mask: bool = False,
                 max_seg_labels: int = 64, device=None, dtype=None):
        super().__init__()
        if variant not in (1, 2, 3, 4, 5):
            raise ValueError(f"LD variant must be 1..5, got {variant}")
        self.variant, self.layer_num = variant, layer_num
        self.stylized_layers = stylized_layers
        self.use_mask, self.max_seg_labels = use_mask, max_seg_labels
        kw = dict(inception_num=inception_num, device=device, dtype=dtype)
        widths = ld_widths(variant, layer_num, hidden_dim)
        cin_small = cin_big = 3
        for i, w in enumerate(widths):
            self.add_module(f"rp_enc{i}_small_revf",
                            Conv2dBlock(cin_small, w, 3, 1, **kw))
            if variant == 1:
                # the layer-0 big branch is 3x3 in the reference; layers >= 1
                # widen to 7x7 (adain_rp.py:503-514)
                ks = 3 if i == 0 else 7
                big = Conv2dBlock(cin_big, w, ks, ks // 2, **kw)
            else:
                big = VGGishBigBranch(cin_big, w, variant in (2, 3),
                                      device=device, dtype=dtype)
            self.add_module(f"rp_enc{i}_big_revf", big)
            if variant in (1, 2):  # one stream: the concat feeds both
                cin_small = cin_big = 2 * w
            else:
                cin_small = cin_big = w
        for i, (cin, cout) in enumerate(ld_decoder_dims(
                variant, layer_num, hidden_dim, stylized_layers)):
            self.add_module(f"rp_dec{i}", Conv2dBlock(cin, cout, 3, 1, **kw))
        if variant == 5:
            for i in range(layer_num):
                self.add_module(f"up_{i}", NonOverlapConvTranspose(
                    hidden_dim, hidden_dim, 2 ** (i + 1), device=device,
                    dtype=dtype))

    def smalls(self) -> List[Conv2dBlock]:
        return [getattr(self, f"rp_enc{i}_small_revf")
                for i in range(self.layer_num)]

    def bigs(self) -> List[nn.Module]:
        return [getattr(self, f"rp_enc{i}_big_revf")
                for i in range(self.layer_num)]

    def decs(self) -> List[Conv2dBlock]:
        return [getattr(self, f"rp_dec{i}") for i in range(self.layer_num)]

    def encode_intermediate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NCHW images -> each layer's NCHW concat feature."""
        smalls, bigs = self.smalls(), self.bigs()
        feats = []
        if self.variant in (1, 2):
            cur = x
            for small, big in zip(smalls, bigs):
                s, b = small(cur), big(cur)
                if self.variant == 2:
                    b = resize_nearest(b, s.shape[2], s.shape[3],
                                       channels_last=False)
                cur = torch.cat([s, b], dim=1)
                feats.append(cur)
            return feats
        fine = coarse = x
        for i, (small, big) in enumerate(zip(smalls, bigs)):
            fine, coarse = small(fine), big(coarse)
            b = getattr(self, f"up_{i}")(coarse) if self.variant == 5 \
                else coarse
            # a whole (gathered) coarse stream returns to the fine share's
            # rows through the resize too
            if b.shape[2:] != fine.shape[2:] or isinstance(b, Whole):
                b = resize_nearest(b, fine.shape[2], fine.shape[3],
                                   channels_last=False)
            feats.append(torch.cat([fine, b], dim=1))
        return feats

    def decode(self, content_feats, style_feats, c_labels=None,
               s_labels=None, use_mask: bool = False) -> torch.Tensor:
        """The decoder on NCHW feature lists -> NCHW image; ``use_mask``
        with labels fuses by the masked AdaIN of the content feature."""
        masked = use_mask and c_labels is not None
        fuse_content = lambda cf, sf: _fuse(  # noqa: E731
            cf, sf, c_labels, s_labels, use_mask, self.max_seg_labels)
        decs = self.decs()
        stylized = decs[0](fuse_content(content_feats[-1], style_feats[-1]))
        pairs = list(zip(content_feats[:-1], style_feats[:-1]))[::-1]
        for i, (cf, sf) in enumerate(pairs):
            if self.variant in (4, 5):  # content-side fusion (:791)
                stylized = decs[i + 1](torch.cat(
                    [stylized, fuse_content(cf, sf)], dim=1))
            elif i < self.stylized_layers - 1:  # running fusion (:550)
                fusion = (fuse_content(cf, sf) if masked
                          else _adain_nchw(stylized, sf))
                stylized = decs[i + 1](stylized + fusion)
            else:
                stylized = decs[i + 1](stylized)
        return stylized

    def forward(self, content: torch.Tensor, style: torch.Tensor,
                c_labels=None, s_labels=None, test_mode: bool = False):
        """content, style (N, H, W, 3) NHWC -> stylized (N, H, W, 3). v1
        encodes both images in one 2N pass, v2 from batch
        ``policy.LD2_2N_ENCODE_MIN_BATCH``, v3-v5 in two passes (exact either
        way: no op of the stacks couples the batch; a speed choice)."""
        from ..policy import LD2_2N_ENCODE_MIN_BATCH
        n = content.shape[0]
        c = content.permute(0, 3, 1, 2)
        s = style.permute(0, 3, 1, 2)
        if self.variant == 1 or (self.variant == 2
                                 and n >= LD2_2N_ENCODE_MIN_BATCH):
            feats = self.encode_intermediate(torch.cat([c, s], dim=0))
            cf, sf = [f[:n] for f in feats], [f[n:] for f in feats]
        else:
            cf = self.encode_intermediate(c.contiguous())
            sf = self.encode_intermediate(s.contiguous())
        return self.decode(cf, sf, c_labels, s_labels,
                           self.use_mask and test_mode).permute(0, 2, 3, 1)
