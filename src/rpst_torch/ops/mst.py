"""Multimodal style transfer (MST): channel matching on the device; port
of ``rpst.ops.mst`` (``mst_transfer``, ``mst_transfer_batch``), plain
PyTorch.

Per sample (reference ``utils/mst.py:114-177``):
  1. k-means over the style channels, each channel's HW response a point
     (``ops.kmeans``);
  2. the data term: the cosine distance of every content channel to each
     style cluster center;
  3. labels: the exact chain MAP (``ops.graphcut``), or a per-channel
     argmin when lambda is 0, as the reference builds it;
  4. recolor: each content channel normalized and re-scaled to its matched
     cluster's prototype, the mean of its member channels' (mean, std).

rpst's ``labeled_whiten_and_color`` is dead code in the reference pipeline
and is not ported.
"""

from __future__ import annotations

import torch

from .graphcut import chain_map_labeling, potts_pairwise
from .kmeans import kmeans


def _channel_mean_std(x: torch.Tensor, eps: float = 1e-5):
    """Per-channel mean and unbiased std (eps inside the sqrt) of x (HW,
    C)."""
    n = x.shape[0]
    mean = x.mean(dim=0)
    var = ((x - mean) ** 2).sum(dim=0) / max(n - 1, 1)
    return mean, torch.sqrt(var + eps)


def mst_labels(cf: torch.Tensor, sf: torch.Tensor, n_clusters: int = 3,
               lam: float = 0.0, kmeans_iters: int = 25):
    """Steps 1-3 on (HW, C) float32 features: the style channels' cluster
    labels (C,) and the content channels' matched clusters (C,)."""
    s_labels, centers = kmeans(sf.t(), n_clusters, iters=kmeans_iters)
    c_channels = cf.t()                                # (C, HW)
    dots = c_channels @ centers.t()                    # (C, k)
    c_norm = torch.linalg.norm(c_channels, dim=1, keepdim=True)
    k_norm = torch.linalg.norm(centers, dim=1, keepdim=True).t()
    d = 1.0 - dots / torch.clamp(c_norm @ k_norm, min=1e-12)
    if lam == 0.0:
        c_labels = torch.argmin(d, dim=1)
    else:
        c_labels = chain_map_labeling(
            d, potts_pairwise(n_clusters, lam, device=d.device)).long()
    return s_labels, c_labels


def mst_transfer(content_feat: torch.Tensor, style_feat: torch.Tensor,
                 n_clusters: int = 3, lam: float = 0.0,
                 kmeans_iters: int = 25) -> torch.Tensor:
    """MST fusion of one sample: (H, W, C) content and style features ->
    (H, W, C) in the content's type; float32 inside."""
    h, w, c = content_feat.shape
    cf = content_feat.reshape(-1, c).float()           # (HW, C)
    sf = style_feat.reshape(-1, c).float()
    s_labels, c_labels = mst_labels(cf, sf, n_clusters, lam, kmeans_iters)
    c_mean, c_std = _channel_mean_std(cf)
    s_mean, s_std = _channel_mean_std(sf)
    onehot = torch.nn.functional.one_hot(s_labels, n_clusters).float()
    count = torch.clamp(onehot.sum(dim=0), min=1.0)
    mean_proto = (onehot.t() @ s_mean) / count
    std_proto = (onehot.t() @ s_std) / count
    normalized = (cf - c_mean[None, :]) / c_std[None, :]
    out = normalized * std_proto[c_labels][None, :] \
        + mean_proto[c_labels][None, :]
    return out.reshape(h, w, c).to(content_feat.dtype)


def mst_transfer_batch(content_feat: torch.Tensor, style_feat: torch.Tensor,
                       n_clusters: int = 3, lam: float = 0.0
                       ) -> torch.Tensor:
    """MST over a batch of NHWC features, sample by sample as the reference
    loops."""
    return torch.stack([mst_transfer(c, s, n_clusters, lam)
                        for c, s in zip(content_feat, style_feat)])
