"""SourceNet, the baseline AdaIN of Huang & Belongie; port of
``rpst.models.src_adain`` (reference ``network/base.py:562-649``).

A frozen 4-stage VGG encoder (``bundle.vgg``) and a trainable VGG-mirror
decoder: the relu4_1 features are fused by AdaIN and decoded. The content
loss compares the stylized image's relu4_1 against the AdaIN target ``t``
(base.py:634-639), not against the content's features. ``use_mask`` is
read only by a labelled test-mode stylize: the label maps are resized to
the relu4_1 grid by rpst's integer nearest index and the fusion is the
segment-masked AdaIN of ``ops.segment``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch import nn

from ..nn.decoder import VGGMirrorDecoder
from ..ops.segment import masked_adain_batch
from ..ops.stats import adaptive_instance_normalization as adain
from .base import feature_mse, style_stat_loss


def resize_labels(labels: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H, W) labels -> (N, h, w) by rpst's ``_resize_labels``: the
    integer nearest index ``(arange(h) * H) // h`` (``F.interpolate``'s
    nearest computes it from a float scale and can pick another row)."""
    hi = torch.arange(h, device=labels.device) * labels.shape[1] // h
    wi = torch.arange(w, device=labels.device) * labels.shape[2] // w
    return labels.index_select(1, hi).index_select(2, wi)


class SourceNet(nn.Module):
    """``forward(content_feats, style_feats)``: [relu1_1 .. relu4_1] NHWC
    feature lists -> image (N, H, W, 3)."""

    def __init__(self, use_mask: bool = False, max_seg_labels: int = 64,
                 device=None, dtype=None):
        super().__init__()
        self.use_mask, self.max_seg_labels = use_mask, max_seg_labels
        self.decoder = VGGMirrorDecoder(device, dtype)

    def decode(self, t: torch.Tensor) -> torch.Tensor:
        """NHWC relu4_1-sized feature -> NHWC image."""
        return self.decoder(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def stylize_from_feats(self, content_feats: Sequence[torch.Tensor],
                           style_feats: Sequence[torch.Tensor],
                           c_labels=None, s_labels=None,
                           test_mode: bool = False) -> torch.Tensor:
        c4, s4 = content_feats[-1], style_feats[-1]
        if self.use_mask and test_mode and c_labels is not None:
            h, w = c4.shape[1:3]
            t = masked_adain_batch(c4, s4, resize_labels(c_labels, h, w),
                                   resize_labels(s_labels, h, w),
                                   self.max_seg_labels)
        else:
            t = adain(c4, s4)
        return self.decode(t)

    def forward(self, content_feats, style_feats, c_labels=None,
                s_labels=None, test_mode: bool = False):
        return self.stylize_from_feats(content_feats, style_feats, c_labels,
                                       s_labels, test_mode)

    def loss(self, vgg_features: Callable[[torch.Tensor], List[torch.Tensor]],
             content: torch.Tensor,
             style: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The loss parts: style statistics over the four taps, and the
        content loss of the stylized relu4_1 against the AdaIN target; the
        content and style features, and so the target, carry no gradient."""
        with torch.no_grad():
            content_feats = vgg_features(content)
            style_feats = vgg_features(style)
            t = adain(content_feats[-1], style_feats[-1])
        g_t_feats = vgg_features(self.decode(t))
        loss_c = feature_mse(g_t_feats[-1], t)
        loss_s = sum(style_stat_loss(g, s)
                     for g, s in zip(g_t_feats, style_feats))
        return {"style_loss": loss_s, "content_loss": loss_c}
