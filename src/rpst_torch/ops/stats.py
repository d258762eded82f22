"""Feature statistics of the AdaIN family, NHWC; port of ``rpst.ops.stats``.

  * ``calc_mean_std``  per-(N, C) mean and unbiased-variance std over H*W,
    eps inside the sqrt (reference ``network/base.py:399-407``)
  * ``adaptive_instance_normalization`` (``network/base.py:410-418``)
  * ``mean_variance_norm`` (``network/sanet.py:20-24``)

Reductions run in float32 whatever the activation type, and use the
two-pass form (mean, then the sum of squared deviations), as rpst does.
"""

from __future__ import annotations

import torch


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """feat (N, H, W, C) -> mean, std, each (N, 1, 1, C) in feat's type."""
    if feat.ndim != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(feat.shape)}")
    f32 = feat.float()
    mean = f32.mean(dim=(1, 2), keepdim=True)
    n = feat.shape[1] * feat.shape[2]
    var = ((f32 - mean) ** 2).sum(dim=(1, 2), keepdim=True) / max(n - 1, 1)
    std = torch.sqrt(var + eps)
    return mean.to(feat.dtype), std.to(feat.dtype)


def adaptive_instance_normalization(content_feat: torch.Tensor,
                                    style_feat: torch.Tensor,
                                    eps: float = 1e-5) -> torch.Tensor:
    """Re-normalize the content statistics to the style statistics."""
    if content_feat.shape[-1] != style_feat.shape[-1]:
        raise ValueError(f"channel mismatch {tuple(content_feat.shape)} vs "
                         f"{tuple(style_feat.shape)}")
    style_mean, style_std = calc_mean_std(style_feat, eps)
    content_mean, content_std = calc_mean_std(content_feat, eps)
    normalized = (content_feat - content_mean) / content_std
    return normalized * style_std + style_mean


def mean_variance_norm(feat: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Zero mean, unit std per (N, C)."""
    mean, std = calc_mean_std(feat, eps)
    return (feat - mean) / std
