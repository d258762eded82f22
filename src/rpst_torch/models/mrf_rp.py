"""The MRF RP model; port of ``rpst.models.mrf_rp`` (reference
``network/mrf_rp.py``).

Two increasing-depth RP encoders with their own weights (content and
style), a channel concat of their deepest features and a halving RP
decoder, every conv zero-padded, stride 1, ReLU. The loss has three parts
(mrf_rp.py:109-136):

  * ``mrf_loss``: the squared distances between the frozen VGG's relu4_1
    features of the stylized image and of the style image, masked by the
    union of the row and column top-k of their cosine similarity and
    normalized by HW * k; the style side carries no gradient, nor does the
    mask;
  * the cycle losses: the stylized image re-encoded by both encoders, its
    style-encoder statistics against the style encoding's and its
    content-encoder features against the content encoding.

As in rpst, the loss is computed per sample and averaged (the reference's
``view(C, -1)`` mixes the samples of a batch above 1). On a row share
(``dist.row_shares``) the top-k runs over the whole image: the two relu4_1
features are gathered (``dist.gather_rows``) and the MRF term is one
device's on every rank, ties at the k-th similarity in its order.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..dist.collectives import gather_rows, row_axis
from ..nn.blocks import RPSequence, rp_decrease_dims, rp_increase_dims
from ..ops.affinity import (cal_affinity_map, cal_dist,
                            mrf_topk_masked_dist_sum)
from .base import feature_mse, style_stat_loss


def mrf_loss(content_feat: torch.Tensor, style_feat: torch.Tensor,
             k: int = 5, chunk: int = 0) -> torch.Tensor:
    """The MRF loss of (N, H, W, C) NHWC features, in their type: the
    per-sample masked distance sum over H * W * k, averaged. ``chunk > 0``
    streams the (HW, HW) matrices in row chunks of that many positions
    (``mrf_topk_masked_dist_sum``). On a row share both features are
    gathered whole first, and the loss is a plain tensor, equal on every
    rank."""
    ax = row_axis()
    if ax is not None:
        content_feat, style_feat = (gather_rows(f, 1, ax)
                                    for f in (content_feat, style_feat))
    n, h, w, c = content_feat.shape
    if chunk:
        totals = torch.stack([mrf_topk_masked_dist_sum(cf, sf, k, chunk)
                              for cf, sf in zip(content_feat, style_feat)])
    else:
        aff = cal_affinity_map(content_feat, style_feat, k)
        dist = cal_dist(content_feat.reshape(n, h * w, c).transpose(1, 2),
                        style_feat.reshape(n, h * w, c).transpose(1, 2))
        totals = (aff * dist).sum(dim=(1, 2))
    return (totals / (h * w * k)).mean().as_subclass(torch.Tensor)


class MRFRP(nn.Module):
    """``rp_content_encoder`` and ``rp_style_encoder`` (3 -> hidden -> ... ->
    hidden * 2^(rp_blocks - 1)) and ``rp_decoder`` (twice that -> ... -> 3),
    the flax module names."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 16, k: int = 5,
                 mrf_chunk: int = 0, device=None, dtype=None):
        super().__init__()
        self.k, self.mrf_chunk = k, mrf_chunk
        enc_out = hidden_dim * 2 ** (rp_blocks - 1)
        enc = rp_increase_dims(rp_blocks, 3, hidden_dim, enc_out)
        self.rp_content_encoder = RPSequence(enc, device=device, dtype=dtype)
        self.rp_style_encoder = RPSequence(enc, device=device, dtype=dtype)
        self.rp_decoder = RPSequence(
            rp_decrease_dims(rp_blocks, enc_out * 2, enc_out, 3),
            device=device, dtype=dtype)

    def encode(self, content: torch.Tensor, style: torch.Tensor):
        """NHWC images -> NCHW deepest features of each encoder."""
        return (self.rp_content_encoder(content.permute(0, 3, 1, 2)),
                self.rp_style_encoder(style.permute(0, 3, 1, 2)))

    def forward(self, content: torch.Tensor, style: torch.Tensor):
        """content, style (N, H, W, 3) NHWC -> stylized (N, H, W, 3)."""
        cf, sf = self.encode(content, style)
        return self.rp_decoder(torch.cat([cf, sf], dim=1)).permute(0, 2, 3, 1)

    def loss(self, vgg, content: torch.Tensor,
             style: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{mrf_loss, style_loss, content_loss} (rpst ``MRFRP.loss``) on
        the frozen 4-stage ``vgg``."""
        cf, sf = self.encode(content, style)
        stylized = self.rp_decoder(torch.cat([cf, sf], dim=1))
        f_stylized = vgg(stylized.permute(0, 2, 3, 1))
        with torch.no_grad():
            f_style = vgg(style)
        loss_mrf = mrf_loss(f_stylized[-1], f_style[-1], self.k,
                            chunk=self.mrf_chunk)
        content_prime = self.rp_content_encoder(stylized)
        style_prime = self.rp_style_encoder(stylized)
        loss_s = style_stat_loss(style_prime.permute(0, 2, 3, 1),
                                 sf.permute(0, 2, 3, 1))
        loss_c = feature_mse(content_prime, cf)
        return {"mrf_loss": loss_mrf, "style_loss": loss_s,
                "content_loss": loss_c}
