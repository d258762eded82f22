"""The perceptual losses of the RP family; port of ``rpst.models.base``
(reference ``network/adain_rp.py:81-88, 321-345``).

  * style loss: the MSE between the per-channel instance (mean, std) of the
    stylized image's frozen-VGG features and the style image's, summed over
    relu1_1 .. relu4_1;
  * content loss: the MSE between the relu4_1 features of the stylized
    image and the content image;
  * ``channel_shuffle``, the test-time shuffle of the multiscale models,
    and ``sort_channels_by_attention``, their ``sort`` by SE weights.

The targets (style and content features) carry no gradient: they run under
``torch.no_grad`` as one batched 2N VGG forward, where rpst wraps the same
forward in ``stop_gradient``.

On a row share (``dist.row_shares``: the row-sharded standard layout) the
statistics are the whole image's already (``ops.stats``), and
``feature_mse`` takes the mean of an image-shaped MSE over the whole
image, so every rank holds the global loss.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..dist.collectives import row_axis, sum_rows
from ..ops.stats import calc_mean_std, mean_variance_norm

VGGFeatures = Callable[[torch.Tensor], List[torch.Tensor]]


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def feature_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mse`` of two image-shaped tensors (features or images, either
    layout); on a row share the mean over the whole image: the shares'
    sums of squared errors (in float32 at least, float64 across them)
    over the global count, in the squared error's type."""
    d = (a - b) ** 2
    ax = row_axis(d)
    if ax is None:
        return d.mean()
    v = d.to(torch.promote_types(d.dtype, torch.float32))
    return (sum_rows(v.sum(), ax) / (d.numel() * ax.size)).to(d.dtype)


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
    return feature_mse(mean_variance_norm(input_feat),
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
    loss_c = feature_mse(f_stylized[-1], f_sc[-1][n:])
    total = content_weight * loss_c + style_weight * loss_s
    return {"style_loss": loss_s, "content_loss": loss_c,
            "total_loss": total}, total


def channel_shuffle(feat: torch.Tensor, groups: int = 4) -> torch.Tensor:
    """Channel shuffle of an NCHW tensor (rpst ``models/base.py:78-85``, the
    reference's ``adain_rp.py:304-311``): channel g * (C / groups) + j moves
    to j * groups + g."""
    n, c, h, w = feat.shape
    return (feat.reshape(n, groups, c // groups, h, w).transpose(1, 2)
            .reshape(n, c, h, w))


def sort_channels_by_attention(feat: torch.Tensor,
                               attention: torch.Tensor) -> torch.Tensor:
    """The channels of an NCHW tensor in descending order of the SE weights
    ``attention`` (N, C, 1, 1) (rpst ``models/base.py:86-92``, the
    reference's ``sort_by_weights``). rpst's ``argsort`` is stable, so tied
    weights keep their channel order here too."""
    order = torch.argsort(-attention[:, :, 0, 0], dim=1, stable=True)
    return feat.gather(1, order[:, :, None, None].expand_as(feat))
