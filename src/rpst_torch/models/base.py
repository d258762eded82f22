"""The perceptual losses of the RP family; port of ``rpst.models.base``
(reference ``network/adain_rp.py:81-88, 321-345``).

  * style loss: the MSE between the per-channel instance (mean, std) of the
    stylized image's frozen-VGG features and the style image's, summed over
    relu1_1 .. relu4_1;
  * content loss: the MSE between the relu4_1 features of the stylized
    image and the content image.

The targets (style and content features) carry no gradient: they run under
``torch.no_grad`` as one batched 2N VGG forward, where rpst wraps the same
forward in ``stop_gradient``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..ops.stats import calc_mean_std, mean_variance_norm

VGGFeatures = Callable[[torch.Tensor], List[torch.Tensor]]


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def style_stat_loss(input_feat: torch.Tensor,
                    target_feat: torch.Tensor) -> torch.Tensor:
    """MSE of instance mean/std pairs of NHWC features (``calc_style_loss``,
    adain_rp.py:84-88)."""
    im, istd = calc_mean_std(input_feat)
    tm, tstd = calc_mean_std(target_feat)
    return mse(im, tm) + mse(istd, tstd)


def normalized_content_loss(input_feat: torch.Tensor,
                            target_feat: torch.Tensor) -> torch.Tensor:
    """SANet's mean-variance-normalized content MSE (sanet.py:226-230); the
    target carries no gradient."""
    return mse(mean_variance_norm(input_feat),
               mean_variance_norm(target_feat.detach()))


def perceptual_rp_losses(vgg_features: VGGFeatures, stylized: torch.Tensor,
                         style: torch.Tensor, content: torch.Tensor,
                         content_weight: float, style_weight: float
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The standard RP-family loss (adain_rp.py:321-345) on NHWC images:
    ``vgg_features`` maps an image batch to [relu1_1, ..., relu4_1]."""
    f_stylized = vgg_features(stylized)
    n = style.shape[0]
    with torch.no_grad():
        f_sc = vgg_features(torch.cat([style, content], dim=0))
    loss_s = sum(style_stat_loss(a, b[:n]) for a, b in zip(f_stylized, f_sc))
    loss_c = mse(f_stylized[-1], f_sc[-1][n:])
    total = content_weight * loss_c + style_weight * loss_s
    return {"style_loss": loss_s, "content_loss": loss_c,
            "total_loss": total}, total
