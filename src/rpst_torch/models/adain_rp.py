"""The AdaIN RP models; port of ``rpst.models.adain_rp``:

  * ``AdaINRP`` (reference ``network/adain_rp.py:15-138``): one AdaIN fusion
    at the deepest feature between an increasing and a decreasing plain
    conv + ReLU stack (``RPSequence``);
  * ``MultiScaleAdaINRP`` (``adain_rp.py:141-345``), the flagship, with a
    constant RP stack and the test-time channel shuffle;
  * ``CCAMRP`` (``adain_rp.py:348-422``): AdaIN plus a cross-channel
    attention residual (``CCAMDec``) before each decoder block;
  * ``SELastRP`` (``adain_rp.py:451-481``): the running AdaIN re-fusion
    with an SE bottleneck on the last fusion;
  * ``MSTRP`` (``adain_rp.py:425-448``): k-means channel matching
    (``ops.mst``) at the fused scales; the transform detaches its inputs,
    so only the decoder trains.

MultiScaleAdaINRP.decode(): AdaIN at the deepest scale, then, walking the decoder blocks,
each shallower scale is re-fused and added residually:
``stylized = dec[i+1](stylized + AdaIN(content_feat_i, style_feat_i))``.
The three variants keep the flagship under ``ms`` and rpst's parameter
names (``attention_block``, ``ccam_{i}.scale``).

Masks: with ``use_mask`` and label maps (N, H, W) given in test mode
(``forward(..., test_mode=True, c_labels=, s_labels=)``, what
``ModelBundle.stylize`` passes), each fusion is the segment-masked AdaIN
of ``ops.segment`` over ``max_seg_labels`` labels, as rpst's ``_fuse``;
``use_mask`` without labels stays plain AdaIN. ``AdaINRP`` masks whenever
it is given labels and ``use_mask`` (rpst reads no test mode there).

The multiscale encoder takes ``attention="se"`` (an SE bottleneck in every
block); ``sort`` orders the channels of both the content and the style
features by the *style* pass's SE weights, as rpst keeps the reference's
behaviour (its shared encoder caches the maps of its last call).

The multiscale encoder takes ``inception_num`` 1x1 convs in every block
and ``attention`` ``se`` or ``sk``; its decoder takes neither, as rpst
builds it. ``enc_stack_way: deeper`` doubles the encoder's width every
block (3 -> hidden -> ... -> hidden * 2^(rp_blocks - 1)) and halves the
decoder's back down, the fusions pairing the widths in reverse order; the
deeper encoder takes no attention (rpst's deeper builder has no attention
argument), whatever the config says.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..dist.collectives import row_axis, sum_rows
from ..nn.attention import SEBottleneck
from ..nn.blocks import (RPSequence, RPStack, rp_constant_dims,
                         rp_decrease_dims, rp_deeper_dims, rp_increase_dims,
                         rp_shallower_dims)
from ..ops.mst import mst_transfer_batch
from ..ops.segment import masked_adain_nchw
from ..ops.stats import adaptive_instance_normalization
from .base import channel_shuffle, sort_channels_by_attention


def _adain_nchw(content_feat, style_feat):
    """AdaIN on NCHW tensors through the NHWC ``ops.stats`` (views only)."""
    out = adaptive_instance_normalization(content_feat.permute(0, 2, 3, 1),
                                          style_feat.permute(0, 2, 3, 1))
    return out.permute(0, 3, 1, 2)


def _fuse(content_feat, style_feat, c_labels, s_labels, use_mask: bool,
          num_labels: int):
    """NCHW AdaIN, or the segment-masked AdaIN when ``use_mask`` and labels
    are given (rpst's ``_fuse``, ``adain_rp.py:41-47``)."""
    if use_mask and c_labels is not None:
        return masked_adain_nchw(content_feat, style_feat, c_labels,
                                 s_labels, num_labels)
    return _adain_nchw(content_feat, style_feat)


def rp_sequence_pair(rp_blocks: int, hidden_dim: int, device=None,
                     dtype=None):
    """The (encoder, decoder) ``RPSequence`` pair adain and wct share: 3 ->
    hidden -> ... -> hidden * 2^(rp_blocks - 1) and back down to 3."""
    enc_out = hidden_dim * 2 ** (rp_blocks - 1)
    encoder = RPSequence(rp_increase_dims(rp_blocks, 3, hidden_dim, enc_out),
                         device=device, dtype=dtype)
    decoder = RPSequence(rp_decrease_dims(rp_blocks, enc_out, enc_out // 2, 3),
                         device=device, dtype=dtype)
    return encoder, decoder


def encode_pair(encoder: nn.Module, content, style):
    """NHWC content and style -> their NCHW deepest features. A batch above
    1 goes through the shared encoder as one 2N pass (exact: plain conv +
    ReLU), a single pair as two passes, as rpst does."""
    n = content.shape[0]
    c = content.permute(0, 3, 1, 2)
    s = style.permute(0, 3, 1, 2)
    if n > 1:
        feats = encoder(torch.cat([c, s], dim=0))
        return feats[:n], feats[n:]
    return encoder(c.contiguous()), encoder(s.contiguous())


class AdaINRP(nn.Module):
    """Single-scale RP AdaIN (reference AdaINRPNet) with the flax module
    names ``encoder`` and ``decoder``. rpst's registry builds it without
    ``use_mask`` (``models/__init__.py`` passes only the widths), so the
    adain network's labels fuse by plain AdaIN; the option is the module's,
    as rpst's."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 16,
                 use_mask: bool = False, max_seg_labels: int = 64,
                 device=None, dtype=None):
        super().__init__()
        self.use_mask, self.max_seg_labels = use_mask, max_seg_labels
        self.encoder, self.decoder = rp_sequence_pair(rp_blocks, hidden_dim,
                                                      device, dtype)

    def forward(self, content: torch.Tensor, style: torch.Tensor,
                c_labels=None, s_labels=None):
        """content, style (N, H, W, 3) NHWC -> stylized (N, H, W, 3)."""
        cf, sf = encode_pair(self.encoder, content, style)
        fused = _fuse(cf, sf, c_labels, s_labels, self.use_mask,
                      self.max_seg_labels)
        return self.decoder(fused).permute(0, 2, 3, 1)


class MultiScaleAdaINRP(nn.Module):
    """Multiscale RP AdaIN with the shared encoder ``rp_shared_encoder`` and
    the decoder ``rp_decoder`` (the flax module names), constant or deeper
    stacks (``enc_stack_way``). ``shuffle`` shuffles
    the channels of the features 0 .. ``shuffle_layers`` at test time only
    (``forward(..., test_mode=True)``, what serving runs); ``sort`` orders
    the channels by the style pass's SE weights in both modes; masks fuse
    at test time only."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 32,
                 enc_stack_way: str = "constant", inception_num: int = 0,
                 attention: str = "none", shuffle: bool = False,
                 shuffle_layers: int = 1, sort: bool = False,
                 use_mask: bool = False, max_seg_labels: int = 64,
                 device=None, dtype=None):
        super().__init__()
        self.shuffle, self.shuffle_layers = shuffle, shuffle_layers
        self.sort, self.use_mask = sort, use_mask
        self.max_seg_labels = max_seg_labels
        if enc_stack_way == "deeper":  # rpst adain_rp.py:108-113
            enc_out = hidden_dim * 2 ** (rp_blocks - 1)
            enc_dims = rp_deeper_dims(rp_blocks, 3, hidden_dim, enc_out)
            dec_dims = rp_shallower_dims(rp_blocks, enc_out, enc_out // 2, 3)
            attention = "none"  # the deeper builder takes no attention
        else:
            enc_dims = rp_constant_dims(rp_blocks, 3, hidden_dim, hidden_dim)
            dec_dims = rp_constant_dims(rp_blocks, hidden_dim, hidden_dim, 3)
        self.rp_shared_encoder = RPStack(enc_dims, inception_num=inception_num,
                                         attention=attention, device=device,
                                         dtype=dtype)
        self.rp_decoder = RPStack(dec_dims, device=device, dtype=dtype)

    def encode(self, content, style):
        """NHWC content and style -> their NCHW intermediate feature lists
        and the style pass's SE weights per layer (two passes of the shared
        encoder, content first, as rpst runs them)."""
        c = content.permute(0, 3, 1, 2).contiguous()
        s = style.permute(0, 3, 1, 2).contiguous()
        cf, _ = self.rp_shared_encoder.intermediates_with_attention(c)
        sf, s_atts = self.rp_shared_encoder.intermediates_with_attention(s)
        return cf, sf, s_atts

    def prep_feats(self, feats, atts, test_mode: bool, sort: bool = True):
        """The test-time channel shuffle of features 0 .. shuffle_layers,
        then (``sort``) each layer's channels ordered by ``atts``."""
        if test_mode and self.shuffle:
            feats = [channel_shuffle(f) if i <= self.shuffle_layers else f
                     for i, f in enumerate(feats)]
        if sort and self.sort:
            feats = [f if a is None else sort_channels_by_attention(f, a)
                     for f, a in zip(feats, atts)]
        return feats

    def decode(self, content_feats, style_feats, c_labels=None,
               s_labels=None, use_mask: bool = False):
        fuse = lambda cf, sf: _fuse(cf, sf, c_labels, s_labels, use_mask,
                                    self.max_seg_labels)
        stylized = fuse(content_feats[-1], style_feats[-1])
        stylized = self.rp_decoder.apply_block(stylized, 0)
        pairs = list(zip(content_feats[:-1], style_feats[:-1]))[::-1]
        for i, (cf, sf) in enumerate(pairs):
            stylized = self.rp_decoder.apply_block(stylized + fuse(cf, sf),
                                                   i + 1)
        return stylized

    def forward(self, content: torch.Tensor, style: torch.Tensor,
                test_mode: bool = False, c_labels=None, s_labels=None):
        """content, style (N, H, W, 3) NHWC -> stylized (N, H, W, 3) NHWC;
        NCHW-contiguous inside. Labels (N, H, W) are read in test mode with
        ``use_mask``."""
        cf, sf, s_atts = self.encode(content, style)
        # both sides sort by the style pass's maps (rpst adain_rp.py:154-162)
        cf, sf = (self.prep_feats(f, s_atts, test_mode) for f in (cf, sf))
        return self.decode(cf, sf, c_labels, s_labels,
                           self.use_mask and test_mode).permute(0, 2, 3, 1)


class CCAMDec(nn.Module):
    """Cross-channel attention decode (reference ``adain_rp.py:348-385``) on
    NCHW features: x + scale * (softmax(max - x.y^T) y), both inputs
    detached. ``scale`` starts at 0 and is a trainable parameter (the
    reference's registration slip, which froze it, is not kept; the math
    is)."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(1, device=device, dtype=dtype))

    def forward(self, x, y):
        x, y = x.detach(), y.detach()
        n, c, h, w = x.shape
        xr = x.reshape(n, c, h * w)
        yr = y.reshape(n, y.shape[1], h * w)
        energy = torch.einsum("ncp,nkp->nck", xr, yr)
        ax = row_axis(x)
        if ax is not None:  # a row share's positions: the whole image's sum
            energy = sum_rows(energy, ax).to(energy.dtype)
        energy_new = energy.amax(dim=-1, keepdim=True) - energy
        attention = torch.softmax(energy_new, dim=-1)
        out = torch.einsum("nck,nkp->ncp", attention, yr).reshape(n, c, h, w)
        return x + self.scale * out


class CCAMRP(nn.Module):
    """Multiscale AdaIN + a CCAM residual before each decoder block
    (CrossChannelAttentionRPNet): the shallower fusions are
    ``AdaIN(stylized, style_feat)`` and ``stylized_layers`` limits how many
    scales fuse. The attention modules are ``ccam_0 .. ccam_{rp_blocks-1}``
    (rpst's names), ``channel_attentions`` lists them."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 32,
                 enc_stack_way: str = "constant", inception_num: int = 0,
                 attention: str = "none", shuffle: bool = False,
                 shuffle_layers: int = 1, sort: bool = False,
                 stylized_layers: int = 5, use_mask: bool = False,
                 max_seg_labels: int = 64, device=None, dtype=None):
        super().__init__()
        self.ms = MultiScaleAdaINRP(
            rp_blocks, hidden_dim, enc_stack_way, inception_num, attention,
            shuffle, shuffle_layers, sort, use_mask, max_seg_labels, device,
            dtype)
        self.stylized_layers = stylized_layers
        for i in range(rp_blocks):
            self.add_module(f"ccam_{i}", CCAMDec(device, dtype))

    @property
    def channel_attentions(self) -> List[CCAMDec]:
        return [getattr(self, f"ccam_{i}")
                for i in range(self.ms.rp_decoder.num_blocks)]

    def forward(self, content, style, test_mode: bool = False,
                c_labels=None, s_labels=None):
        # the reference's CCAM decode drops the sort branch; the shuffle
        # and the masks apply at test time
        cf, sf, _ = self.ms.encode(content, style)
        cf, sf = (self.ms.prep_feats(f, None, test_mode, sort=False)
                  for f in (cf, sf))
        dec, att = self.ms.rp_decoder, self.channel_attentions
        use_mask = self.ms.use_mask and test_mode
        fuse = lambda x, y: _fuse(x, y, c_labels, s_labels, use_mask,
                                  self.ms.max_seg_labels)
        stylized = fuse(cf[-1], sf[-1])
        stylized = dec.apply_block(stylized + att[0](cf[-1], sf[-1]), 0)
        for i, sfi in enumerate(sf[:-1][::-1]):
            if i + 1 < self.stylized_layers:
                stylized = fuse(stylized, sfi)
                stylized = dec.apply_block(
                    stylized + att[i + 1](stylized, sfi), i + 1)
            else:
                stylized = dec.apply_block(stylized, i + 1)
        return stylized.permute(0, 2, 3, 1)


class SELastRP(nn.Module):
    """Multiscale AdaIN with one SE bottleneck on the final fusion
    (SELastMultiScaleAdaINRPNet): the shallower fusions are
    ``AdaIN(stylized, style_feat)``, no residual add. With masks (test
    mode, ``use_mask``, labels) each shallower fusion is rpst's
    ``masked_adain(content_feat, style_feat)`` instead, and the bottleneck
    is skipped (``adain_rp.py:275-286``); the deepest stays plain AdaIN."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 32,
                 enc_stack_way: str = "constant", inception_num: int = 0,
                 attention: str = "none", use_mask: bool = False,
                 max_seg_labels: int = 64, device=None, dtype=None):
        super().__init__()
        self.ms = MultiScaleAdaINRP(
            rp_blocks, hidden_dim, enc_stack_way, inception_num, attention,
            use_mask=use_mask, max_seg_labels=max_seg_labels, device=device,
            dtype=dtype)
        self.attention_block = SEBottleneck(hidden_dim, device=device,
                                            dtype=dtype)

    def forward(self, content, style, test_mode: bool = False,
                c_labels=None, s_labels=None):
        cf, sf, _ = self.ms.encode(content, style)
        dec = self.ms.rp_decoder
        masked = self.ms.use_mask and test_mode and c_labels is not None
        stylized = dec.apply_block(_adain_nchw(cf[-1], sf[-1]), 0)
        pairs = list(zip(cf[:-1], sf[:-1]))[::-1]
        for i, (cfi, sfi) in enumerate(pairs):
            if masked:
                stylized = masked_adain_nchw(cfi, sfi, c_labels, s_labels,
                                             self.ms.max_seg_labels)
            else:
                stylized = _adain_nchw(stylized, sfi)
                if i == len(pairs) - 1:
                    stylized, _ = self.attention_block(stylized)
            stylized = dec.apply_block(stylized, i + 1)
        return stylized.permute(0, 2, 3, 1)


def mst_nchw(content_feat, style_feat, n_clusters: int, lam: float):
    """``ops.mst.mst_transfer_batch`` on NCHW features."""
    out = mst_transfer_batch(content_feat.permute(0, 2, 3, 1),
                             style_feat.permute(0, 2, 3, 1), n_clusters, lam)
    return out.permute(0, 3, 1, 2)


class MSTRP(nn.Module):
    """Multiscale RP with MST fusion (GlobalMSTRPNet): the transform
    detaches both inputs, so gradients reach only the decoder. rpst builds
    its ``ms`` without shuffle, so the yaml's ``shuffle`` is not read."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 32,
                 enc_stack_way: str = "constant", inception_num: int = 0,
                 attention: str = "none", stylized_layers: int = 1,
                 n_clusters: int = 3, mst_lambda: float = 0.0, device=None,
                 dtype=None):
        super().__init__()
        self.ms = MultiScaleAdaINRP(
            rp_blocks, hidden_dim, enc_stack_way, inception_num, attention,
            device=device, dtype=dtype)
        self.stylized_layers = stylized_layers
        self.n_clusters, self.mst_lambda = n_clusters, mst_lambda

    def forward(self, content, style, test_mode: bool = False,
                c_labels=None, s_labels=None):
        """rpst's MSTRP takes and ignores the test mode and the labels."""
        cf, sf, _ = self.ms.encode(content, style)
        dec = self.ms.rp_decoder
        stylized = dec.apply_block(mst_nchw(
            cf[-1].detach(), sf[-1].detach(), self.n_clusters,
            self.mst_lambda), 0)
        for i, sfi in enumerate(sf[:-1][::-1]):
            if i + 1 < self.stylized_layers:
                # rpst detaches the style feature only here
                stylized = mst_nchw(stylized, sfi.detach(), self.n_clusters,
                                    self.mst_lambda)
            stylized = dec.apply_block(stylized, i + 1)
        return stylized.permute(0, 2, 3, 1)
