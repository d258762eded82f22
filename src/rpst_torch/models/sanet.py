"""The static style-attentional network; port of ``rpst.models.sanet``
(reference ``network/sanet.py``):

  * ``SANetAttention`` (sanet.py:73-99): 1x1 f / g / h convs on
    mean-variance-normalized features, softmax attention over all HWc x HWs
    position pairs, a 1x1 output conv and a residual;
  * ``Transform`` (sanet.py:140-149): the relu4_1 module's output plus the
    upsampled relu5_1 module's, through a 3x3 reflect conv;
  * ``SAModel`` (sanet.py:196-275): transform + VGG-mirror decoder over a
    frozen 5-stage VGG; content (normalized, relu4_1 + relu5_1), style
    statistics (relu1_1 .. relu5_1) and two identity losses.

The attention is B6 (``ops.flash_attention``): on the card the HWc x HWs
matrix (67 MB per image at 512px relu4_1) never exists, in serving or in
training. Features are NHWC, as the VGG returns them: a 1x1 conv is a
linear map of the channel axis, so F, G and H reach B6 as contiguous (N,
HW, C) tensors without a transpose copy. The modules keep ``nn.Conv2d``
parameters under the reference state_dict's names (``sanet4_1.f``, ``.g``,
``.h``, ``.out_conv``, ``merge_conv``), so exported ``.pth`` files load.

The adaptive variant (``dynamic_sanet``: the AEA threshold modules and the
adaptive blockwise attention) is ROADMAP.md section A slice 6b.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch import nn

from ..nn.blocks import PadConv
from ..nn.decoder import VGGMirrorDecoder, upsample_nearest_2x_nhwc
from ..ops.flash_attention import sanet_attention
from ..ops.stats import mean_variance_norm
from .base import mse, normalized_content_loss, style_stat_loss

Attention = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def conv1x1_nhwc(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv (OI11 weight) of an NHWC tensor as a linear map of its
    channel axis: (N, H, W, C) -> (N, H, W, O), contiguous. One batched
    product, which reads the VGG's features (NHWC views of NCHW tensors)
    through their strides: no transpose copy on either side."""
    n, h, w, c = x.shape
    wt = weight.flatten(1).t().to(x.dtype)
    y = torch.baddbmm(bias.to(x.dtype), x.reshape(n, h * w, c),
                      wt.expand(n, -1, -1))
    return y.reshape(n, h, w, -1)


def sanet_attention_block(content, style, f, g, h, out_conv,
                          attention: Attention = sanet_attention):
    """One style-attention module on NHWC features; ``f`` .. ``out_conv``
    are (weight, bias) pairs of 1x1 convs. Shared by the module and the int8
    serving path, which holds detached weights in its working type."""
    n, hc, wc, c = content.shape
    fm = conv1x1_nhwc(mean_variance_norm(content), *f).reshape(n, hc * wc, -1)
    gm = conv1x1_nhwc(mean_variance_norm(style), *g).reshape(
        n, style.shape[1] * style.shape[2], -1)
    hm = conv1x1_nhwc(style, *h).reshape(gm.shape)
    o = attention(fm, gm, hm).reshape(n, hc, wc, -1)
    return conv1x1_nhwc(o, *out_conv) + content


class SANetAttention(nn.Module):
    """A single style-attention module. ``forward(content, style)`` on NHWC
    features of ``in_planes`` channels -> NHWC of the content's shape."""

    def __init__(self, in_planes: int, device=None, dtype=None):
        super().__init__()
        for name in ("f", "g", "h", "out_conv"):
            self.add_module(name, nn.Conv2d(in_planes, in_planes, 1,
                                            device=device, dtype=dtype))

    def pairs(self):
        return [(m.weight, m.bias)
                for m in (self.f, self.g, self.h, self.out_conv)]

    def forward(self, content, style, attention: Attention = sanet_attention):
        return sanet_attention_block(content, style, *self.pairs(),
                                     attention=attention)


class Transform(nn.Module):
    """Merge the relu4_1 and the upsampled relu5_1 attention outputs."""

    def __init__(self, in_planes: int = 512, device=None, dtype=None):
        super().__init__()
        self.sanet4_1 = SANetAttention(in_planes, device, dtype)
        self.sanet5_1 = SANetAttention(in_planes, device, dtype)
        self.merge_conv = PadConv(in_planes, in_planes, 3, 1, "reflect",
                                  device=device, dtype=dtype)

    def forward(self, c4, s4, c5, s5, attention: Attention = sanet_attention):
        """NHWC relu4_1 / relu5_1 features -> the fused feature, NCHW (the
        decoder's layout)."""
        a4 = self.sanet4_1(c4, s4, attention)
        a5 = self.sanet5_1(c5, s5, attention)
        merged = a4 + upsample_nearest_2x_nhwc(a5)
        return self.merge_conv(merged.permute(0, 3, 1, 2))


class SAModel(nn.Module):
    """Static SANet: trains ``transform`` and ``decoder`` over frozen VGG
    features. ``attention`` replaces B6's public function (a benchmark
    passes the plain version or a library call to time them)."""

    def __init__(self, adaptive: bool = False, img_size: int = 512,
                 device=None, dtype=None):
        super().__init__()
        if adaptive:
            raise NotImplementedError(
                "the adaptive SANet (dynamic_sanet: AEA thresholds, adaptive "
                "blockwise attention) is not ported yet: ROADMAP.md section "
                "A slice 6b")
        self.img_size = img_size
        self.transform = Transform(512, device, dtype)
        self.decoder = VGGMirrorDecoder(device, dtype)
        self.attention: Attention = sanet_attention

    def stylize_from_feats(self, content_feats: Sequence[torch.Tensor],
                           style_feats: Sequence[torch.Tensor]):
        """[relu1_1 .. relu5_1] NHWC feature lists -> image (N, H, W, 3)."""
        fusion = self.transform(content_feats[3], style_feats[3],
                                content_feats[4], style_feats[4],
                                self.attention)
        return self.decoder(fusion).permute(0, 2, 3, 1)

    def forward(self, content_feats, style_feats):
        return self.stylize_from_feats(content_feats, style_feats)

    def loss(self, vgg_features: Callable[[torch.Tensor], List[torch.Tensor]],
             content: torch.Tensor,
             style: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The loss parts (sanet.py:248-275): the normalized content loss on
        relu4_1 + relu5_1, style statistics over five stages, and the two
        identity losses; three stylize calls and five VGG encodes. The
        content and style features carry no gradient."""
        with torch.no_grad():
            content_feats = vgg_features(content)
            style_feats = vgg_features(style)
        g_t = self.stylize_from_feats(content_feats, style_feats)
        g_t_feats = vgg_features(g_t)
        loss_c = (normalized_content_loss(g_t_feats[3], content_feats[3])
                  + normalized_content_loss(g_t_feats[4], content_feats[4]))
        loss_s = sum(style_stat_loss(g, s)
                     for g, s in zip(g_t_feats, style_feats))
        icc = self.stylize_from_feats(content_feats, content_feats)
        iss = self.stylize_from_feats(style_feats, style_feats)
        l_identity1 = mse(icc, content) + mse(iss, style)
        fcc = vgg_features(icc)
        fss = vgg_features(iss)
        l_identity2 = sum(mse(a, b) + mse(c, d) for a, b, c, d in
                          zip(fcc, content_feats, fss, style_feats))
        return {"content_loss": loss_c, "style_loss": loss_s,
                "l_identity1_loss": l_identity1,
                "l_identity2_loss": l_identity2}
