"""Segmentation-aware AdaIN RP; port of ``rpst.models.seg_adain``
(reference ``network/seg_adain_rp.py``):

  * ``cross_entropy_loss``: class-weighted cross entropy with the ignore
    label -1, the logits resized to the label's size first
    (seg_adain_rp.py:6-22);
  * ``SegRPNet``: the RP segmentation head over the encoder's features, a
    constant Conv2dBlock stack (reflect pad, LeakyReLU 0.2 after every
    block, the last one too) ending at ``class_num``;
  * ``SegAdaINRP``: ``AdaINRP`` under ``adain_rp`` (its stylize, so its q8
    path is adain's on that subtree) and, when ``seg_loss_weight > 0``, the
    head ``seg_head``; its loss adds the segmentation term when the batch
    carries content labels.

rpst's version is the runnable form of the reference's evident intent (the
reference class fails on construction); the port follows rpst.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.collectives import all_reduce, batch_axes
from ..nn.blocks import RPStack, rp_constant_dims
from .adain_rp import AdaINRP
from .base import perceptual_rp_losses

# seg_adain_rp.py:87-91 (commented out in the reference)
CITYSCAPES_CLASS_WEIGHTS = (
    0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489,
    0.8786, 1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955,
    1.0865, 1.1529, 1.0507)


def resize_logits(logits: torch.Tensor, size) -> torch.Tensor:
    """NHWC logits resized to ``size`` (H, W) as ``jax.image.resize(...,
    "linear")``: half-pixel centres, the triangle kernel widened by the
    factor where it shrinks (antialiased), edge weights renormalized;
    ``F.interpolate``'s bilinear with ``antialias=True`` computes the
    same."""
    x = logits.permute(0, 3, 1, 2)
    shrinks = size[0] < x.shape[2] or size[1] < x.shape[3]
    y = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=shrinks)
    return y.permute(0, 2, 3, 1)


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       ignore_label: int = -1) -> torch.Tensor:
    """Class-weighted cross entropy: logits (N, h, w, C) NHWC, target (N,
    H, W) integer; the logits are resized to (H, W) when they differ;
    pixels at ``ignore_label`` count for nothing; the sum is divided by
    max(sum of the weights, 1). The log-softmax runs in the logits' type,
    as rpst's."""
    th, tw = target.shape[1:3]
    if logits.shape[1:3] != (th, tw):
        logits = resize_logits(logits, (th, tw))
    valid = target != ignore_label
    safe = torch.where(valid, target, torch.zeros_like(target)).long()
    with torch.autocast(logits.device.type, enabled=False):
        logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    w_map = (weight.to(logits.device)[safe] if weight is not None
             else torch.ones_like(picked))
    w_map = torch.where(valid, w_map, torch.zeros_like(w_map))
    num, den = -(picked * w_map).sum(), w_map.sum()
    axes = batch_axes()
    if axes:  # a data-parallel step: the global batch's sums
        num, den = all_reduce(torch.stack([num, den]), axes)
    return num / torch.clamp(den, min=1.0)


class SegRPNet(nn.Module):
    """The RP segmentation head: ``seg_head`` (an ``RPStack`` of
    rp_constant_dims(rp_blocks, in_dim, seg_hidden_dim, class_num))."""

    def __init__(self, in_dim: int, rp_blocks: int = 5,
                 seg_hidden_dim: int = 32, class_num: int = 19, device=None):
        super().__init__()
        self.seg_head = RPStack(rp_constant_dims(rp_blocks, in_dim,
                                                 seg_hidden_dim, class_num),
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW features -> NHWC logits."""
        return self.seg_head(x).permute(0, 2, 3, 1)


class SegAdaINRP(nn.Module):
    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 16,
                 class_num: int = 19, seg_hidden_dim: int = 32,
                 seg_loss_weight: float = 1.0, device=None):
        super().__init__()
        self.class_num = class_num
        self.adain_rp = AdaINRP(rp_blocks=rp_blocks, hidden_dim=hidden_dim,
                                device=device)
        if seg_loss_weight > 0:
            self.seg_head = SegRPNet(hidden_dim * 2 ** (rp_blocks - 1),
                                     rp_blocks, seg_hidden_dim, class_num,
                                     device=device)

    def forward(self, content: torch.Tensor, style: torch.Tensor,
                c_labels=None, s_labels=None):
        """content, style (N, H, W, 3) -> stylized: ``AdaINRP``'s. rpst's
        ``SegAdaINRP`` takes the labels and reads none of them
        (``seg_adain.py:91-93``): its ``adain_rp`` has no ``use_mask``."""
        return self.adain_rp(content, style)

    def loss(self, vgg, content: torch.Tensor, style: torch.Tensor,
             content_label: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """{style_loss, content_loss} (rpst's perceptual loss at weights 1,
        1; the bundle mixes them), plus ``seg_loss`` when the head exists
        and ``content_label`` (N, H, W) is given."""
        stylized = self.adain_rp(content, style)
        parts, _ = perceptual_rp_losses(vgg, stylized, style, content, 1.0,
                                        1.0)
        out = {"style_loss": parts["style_loss"],
               "content_loss": parts["content_loss"]}
        if hasattr(self, "seg_head") and content_label is not None:
            cf = self.adain_rp.encoder(content.permute(0, 3, 1, 2))
            weight = torch.tensor(CITYSCAPES_CLASS_WEIGHTS[:self.class_num])
            out["seg_loss"] = cross_entropy_loss(self.seg_head(cf),
                                                 content_label, weight)
        return out
