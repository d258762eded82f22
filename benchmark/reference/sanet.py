"""Plain reference of ``sanet``: the static style-attentional network (Park
& Lee, CVPR 2019, arXiv:1812.02342) as RP-Style-Transfer runs it
(``network/sanet.py``), with its training loss.

  * Features: a frozen VGG-19 (the 1x1 normalization head, reflect-padded
    3x3 convs, ceil-mode pools), taps relu1_1 .. relu5_1.
  * SANet module on (content F_c, style F_s): f = 1x1(mvn(F_c)), g =
    1x1(mvn(F_s)), h = 1x1(F_s); O = softmax_q(f g^T) h (no scaling, no
    mask); out = 1x1(O) + F_c. mvn is the per-channel normalization (mean,
    std with the unbiased variance and eps 1e-5 inside the root).
  * Transform: the relu4_1 module's output plus the nearest-2x upsampled
    relu5_1 module's, through a reflect-padded 3x3 merge conv.
  * Decoder: the VGG mirror, reflect-padded 3x3 convs 512 -> 256 -> 256 ->
    256 -> 256 -> 128 -> 128 -> 64 -> 64 -> 3, ReLU after each but the
    last, nearest 2x before the 2nd, 6th and 8th.
  * Loss: content = MSE of mvn(relu4_1) and of mvn(relu5_1) of the
    stylized image against the content's; style = the per-channel mean and
    std MSEs over the five taps against the style's; identity 1 = the
    MSEs of stylize(c, c) to c and of stylize(s, s) to s; identity 2 = the
    MSEs of their five taps to the content's and style's. Weighted by the
    configuration (content 1, style 3, identity 50 and 1).

Departures: the VGG is random (He-uniform, from the seed), not the
pre-trained ``vgg_normalised``. Standard layout, float32 throughout; the
caller turns TF32 off. Weights are the program's state dict keys.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from common import (Precision, conv, matmul, mean_variance_norm, mse, nhwc,
                    pair, style_stat_loss, vgg_features)

VGG_STAGES = 5
DECODER = ((512, 256), (256, 256), (256, 256), (256, 256), (256, 128),
           (128, 128), (128, 64), (64, 64), (64, 3))
UP_BEFORE = (1, 5, 7)


class Reference:
    def __init__(self, settings: Dict, weights: Dict[str, torch.Tensor],
                 vgg: Dict[str, torch.Tensor], precision: str = "f32"):
        self.s = settings
        self.weights = weights
        self.vgg = vgg
        self.prec = Precision(precision)

    def features(self, img) -> List[torch.Tensor]:
        return vgg_features(self.vgg, img, VGG_STAGES, self.prec)

    def _module(self, p, name, c, s):
        n, ch, hc, wc = c.shape

        def proj(x, conv1x1):
            w, b = pair(p, f"transform.{name}.{conv1x1}")
            y = matmul(w.reshape(ch, ch), x.reshape(n, ch, -1), self.prec)
            return y + b[None, :, None]
        f = proj(mean_variance_norm(c, self.prec), "f")   # (N, C, HWc)
        g = proj(mean_variance_norm(s, self.prec), "g")   # (N, C, HWs)
        h = proj(s, "h")
        attn = torch.softmax(matmul(f.transpose(1, 2), g, self.prec), -1)
        o = matmul(h, attn.transpose(1, 2), self.prec)   # (N, C, HWc)
        return proj(o, "out_conv").reshape(n, ch, hc, wc) + c

    def stylize_feats(self, p, cf, sf) -> torch.Tensor:
        a4 = self._module(p, "sanet4_1", cf[3], sf[3])
        a5 = self._module(p, "sanet5_1", cf[4], sf[4])
        x = a4 + F.interpolate(a5, scale_factor=2, mode="nearest")
        x = conv(x, *pair(p, "transform.merge_conv.Conv_0"), 1, self.prec)
        for i in range(len(DECODER)):
            if i in UP_BEFORE:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = conv(x, *pair(p, f"decoder.conv{i}.Conv_0"), 1, self.prec)
            if i != len(DECODER) - 1:
                x = F.relu(x)
        return nhwc(x)

    def stylize(self, content, style, p=None) -> torch.Tensor:
        """(N, H, W, 3) content and style -> (N, H, W, 3)."""
        p = self.weights if p is None else p
        return self.stylize_feats(p, self.features(content),
                                  self.features(style))

    def loss(self, p, content, style) -> Dict[str, torch.Tensor]:
        """The loss parts, unweighted, and their weighted sum
        (``total_loss``)."""
        s = self.s
        with torch.no_grad():
            cf, sf = self.features(content), self.features(style)
        g_t = self.stylize_feats(p, cf, sf)
        gf = self.features(g_t)
        def mvn(x):
            return mean_variance_norm(x, self.prec)
        loss_c = mse(mvn(gf[3]), mvn(cf[3])) + mse(mvn(gf[4]), mvn(cf[4]))
        loss_s = sum(style_stat_loss(a, b, self.prec)
                     for a, b in zip(gf, sf))
        icc = self.stylize_feats(p, cf, cf)
        iss = self.stylize_feats(p, sf, sf)
        l1 = mse(icc, content) + mse(iss, style)
        fcc, fss = self.features(icc), self.features(iss)
        l2 = sum(mse(a, b) + mse(c, d)
                 for a, b, c, d in zip(fcc, cf, fss, sf))
        total = (float(s["content_weight"]) * loss_c
                 + float(s["style_weight"]) * loss_s
                 + float(s["l_identity1_weight"]) * l1
                 + float(s["l_identity2_weight"]) * l2)
        return {"total_loss": total, "content_loss": loss_c,
                "style_loss": loss_s, "l_identity1_loss": l1,
                "l_identity2_loss": l2}


def build(settings, weights, vgg, precision: str = "f32") -> Reference:
    return Reference(settings, weights, vgg, precision)

