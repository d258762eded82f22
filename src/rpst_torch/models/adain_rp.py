"""The AdaIN RP models; port of ``rpst.models.adain_rp``:

  * ``AdaINRP`` (reference ``network/adain_rp.py:15-138``): one AdaIN fusion
    at the deepest feature between an increasing and a decreasing plain
    conv + ReLU stack (``RPSequence``);
  * ``MultiScaleAdaINRP`` (``adain_rp.py:141-345``), the flagship, with a
    constant RP stack.

MultiScaleAdaINRP.decode(): AdaIN at the deepest scale, then, walking the decoder blocks, each
shallower scale is re-fused and added residually:
``stylized = dec[i+1](stylized + AdaIN(content_feat_i, style_feat_i))``.

Of MultiScaleAdaINRP only the constant stack without inception,
attention, shuffle, sort or masks is ported; the other options, and
AdaINRP's ``use_mask``, raise ``NotImplementedError`` naming their
ROADMAP.md slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.blocks import (RPSequence, RPStack, rp_constant_dims,
                         rp_decrease_dims, rp_increase_dims)
from ..ops.stats import adaptive_instance_normalization


def _adain_nchw(content_feat, style_feat):
    """AdaIN on NCHW tensors through the NHWC ``ops.stats`` (views only)."""
    out = adaptive_instance_normalization(content_feat.permute(0, 2, 3, 1),
                                          style_feat.permute(0, 2, 3, 1))
    return out.permute(0, 3, 1, 2)


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
    names ``encoder`` and ``decoder``."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 16,
                 use_mask: bool = False, device=None, dtype=None):
        super().__init__()
        if use_mask:
            raise NotImplementedError(
                "AdaINRP use_mask is not ported yet: ROADMAP.md section A "
                "slice 7 (masks)")
        self.encoder, self.decoder = rp_sequence_pair(rp_blocks, hidden_dim,
                                                      device, dtype)

    def forward(self, content: torch.Tensor, style: torch.Tensor):
        """content, style (N, H, W, 3) NHWC -> stylized (N, H, W, 3)."""
        cf, sf = encode_pair(self.encoder, content, style)
        return self.decoder(_adain_nchw(cf, sf)).permute(0, 2, 3, 1)


class MultiScaleAdaINRP(nn.Module):
    """Multiscale RP AdaIN with the shared encoder ``rp_shared_encoder`` and
    the decoder ``rp_decoder`` (the flax module names)."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 32,
                 enc_stack_way: str = "constant", inception_num: int = 0,
                 attention: str = "none", shuffle: bool = False,
                 sort: bool = False, use_mask: bool = False,
                 device=None, dtype=None):
        super().__init__()
        unported = (
            ("enc_stack_way='deeper'", enc_stack_way == "deeper",
             "slice 4 (the other multi_adain stacks)"),
            ("shuffle", shuffle, "slice 4 (the other multi_adain options)"),
            ("sort", sort, "slice 4 (needs SE attention)"),
            ("use_mask", use_mask, "slice 7 (masks)"))
        for what, on, where in unported:
            if on:
                raise NotImplementedError(
                    f"MultiScaleAdaINRP {what} is not ported yet: ROADMAP.md "
                    f"section A {where}")
        enc_dims = rp_constant_dims(rp_blocks, 3, hidden_dim, hidden_dim)
        dec_dims = rp_constant_dims(rp_blocks, hidden_dim, hidden_dim, 3)
        self.rp_shared_encoder = RPStack(enc_dims, inception_num=inception_num,
                                         attention=attention, device=device,
                                         dtype=dtype)
        self.rp_decoder = RPStack(dec_dims, device=device, dtype=dtype)

    def decode(self, content_feats, style_feats):
        stylized = _adain_nchw(content_feats[-1], style_feats[-1])
        stylized = self.rp_decoder.apply_block(stylized, 0)
        pairs = list(zip(content_feats[:-1], style_feats[:-1]))[::-1]
        for i, (cf, sf) in enumerate(pairs):
            fusion = _adain_nchw(cf, sf)
            stylized = self.rp_decoder.apply_block(stylized + fusion, i + 1)
        return stylized

    def forward(self, content: torch.Tensor, style: torch.Tensor):
        """content, style (N, H, W, 3) NHWC -> stylized (N, H, W, 3) NHWC;
        NCHW-contiguous inside."""
        c = content.permute(0, 3, 1, 2).contiguous()
        s = style.permute(0, 3, 1, 2).contiguous()
        cf = self.rp_shared_encoder.intermediates(c)
        sf = self.rp_shared_encoder.intermediates(s)
        return self.decode(cf, sf).permute(0, 2, 3, 1)
