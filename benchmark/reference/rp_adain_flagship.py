"""Plain reference of ``rp_adain_flagship``: the multiscale RP AdaIN network
of RP-Style-Transfer (``network/adain_rp.py``, ``MultiScaleAdaINRPNet``)
over a constant-width RP stack, with its perceptual training loss.

  * Encoder: ``rp_blocks`` blocks of reflect pad 1, 3x3 conv, leaky ReLU
    (0.2), widths 3 -> hidden -> ... -> hidden, shared by content and
    style; every block's output is kept.
  * Decoder: AdaIN (Huang & Belongie 2017: the content's per-channel mean
    and std, over H and W, unbiased variance, eps 1e-5 inside the root,
    replaced by the style's) at the deepest block, then decoder block 0;
    walking back up, each shallower scale's AdaIN is added before the next
    decoder block: y = dec[i + 1](y + AdaIN(c_i, s_i)); widths hidden ->
    ... -> hidden -> 3, the same blocks.
  * Loss: VGG-19 (frozen, the 1x1 normalization head, reflect-padded 3x3
    convs, ceil-mode pools) taps relu1_1 .. relu4_1; the style loss sums
    the MSE of the per-channel means and of the stds of the stylized
    image's taps against the style image's; the content loss is the MSE of
    relu4_1 against the content image's. The targets carry no gradient.

Departures from the published description, all the configuration's:
``attention: none`` (the yaml's SE bottleneck is left out), no masks
(``use_mask: false``), and the VGG is random (He-uniform, from the seed),
not the pre-trained ``vgg_normalised``. Standard layout, float32; the
caller turns TF32 off. Weights are the program's state dict keys.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from common import (Precision, adain, conv, mse, nhwc, pair,
                    style_stat_loss, vgg_features)

VGG_STAGES = 4


class Reference:
    def __init__(self, settings: Dict, weights: Dict[str, torch.Tensor],
                 vgg: Dict[str, torch.Tensor], precision: str = "f32"):
        self.s = settings
        self.blocks = int(settings["rp_blocks"])
        self.weights = weights
        self.vgg = vgg
        self.prec = Precision(precision)
        self.trained = [k for k in weights]

    def _block(self, p, stack, i, x):
        w, b = pair(p, f"{stack}.block_{i}.PadConv_0.Conv_0")
        return F.leaky_relu(conv(x, w, b, 1, self.prec), 0.2)

    def _encode(self, p, img) -> List[torch.Tensor]:
        x, feats = img.permute(0, 3, 1, 2), []
        for i in range(self.blocks):
            x = self._block(p, "rp_shared_encoder", i, x)
            feats.append(x)
        return feats

    def stylize(self, content, style, p=None) -> torch.Tensor:
        """(N, H, W, 3) content and style -> (N, H, W, 3)."""
        p = self.weights if p is None else p
        cf, sf = self._encode(p, content), self._encode(p, style)
        y = self._block(p, "rp_decoder", 0,
                        adain(cf[-1], sf[-1], self.prec))
        for i, (c, s) in enumerate(reversed(list(zip(cf[:-1], sf[:-1])))):
            y = self._block(p, "rp_decoder", i + 1,
                            y + adain(c, s, self.prec))
        return nhwc(y)

    def loss(self, p, content, style) -> Dict[str, torch.Tensor]:
        """The loss parts, unweighted, and their weighted sum
        (``total_loss``)."""
        stylized = self.stylize(content, style, p)
        g = vgg_features(self.vgg, stylized, VGG_STAGES, self.prec)
        n = style.shape[0]
        with torch.no_grad():
            t = vgg_features(self.vgg, torch.cat([style, content]),
                             VGG_STAGES, self.prec)
        loss_s = sum(style_stat_loss(a, b[:n], self.prec)
                     for a, b in zip(g, t))
        loss_c = mse(g[-1], t[-1][n:])
        total = (float(self.s["content_weight"]) * loss_c
                 + float(self.s["style_weight"]) * loss_s)
        return {"total_loss": total, "content_loss": loss_c,
                "style_loss": loss_s}


def build(settings, weights, vgg, precision: str = "f32") -> Reference:
    return Reference(settings, weights, vgg, precision)
