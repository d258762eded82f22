"""Segment-masked AdaIN, NHWC; port of ``rpst.ops.segment``.

The reference (``network/base.py:421-530``) reads segmentation PNGs inside
the forward pass and stylizes each label's pixel set by its own
statistics. rpst (and so the port) takes the label maps as dense integer
tensors (N, H, W) from the data pipeline and works over a fixed universe
of ``num_labels`` labels (config ``max_seg_labels``):

  * the per-label statistics of both sides come from one-hot products, in
    rpst's one-pass unbiased form ``(sum x^2 - n mean^2) / max(n - 1, 1)``,
    then ``sqrt(max(var, 0) + 1e-5)`` (``torch.var`` is another function:
    it cancels differently where mean^2 >> var);
  * a label is valid when both sides hold more than 10 of its pixels and
    neither side holds 100x the other's count (``compute_label_info``,
    ``base.py:421-439``);
  * pixels of an invalid label, or of a label outside [0, num_labels),
    keep the content feature untouched.

The statistics and the normalization run in float32 with autocast off
(under a bfloat16 autocast the one-hot products would run in bfloat16);
the output is cast back to the content feature's type. On the card TF32
must be off for float32 matmuls (``train_torch.py`` and ``test_torch.py``
turn it off), or the sums lose 13 bits.
"""

from __future__ import annotations

import torch

_EPS = 1e-5


def _per_label_stats(feat2d: torch.Tensor, onehot: torch.Tensor):
    """feat2d (P, C) float32, onehot (L, P) {0, 1} float32 -> mean (L, C),
    std (L, C), count (L,)."""
    count = onehot.sum(dim=1)
    mean = (onehot @ feat2d) / torch.clamp(count, min=1.0)[:, None]
    sq = onehot @ (feat2d * feat2d)
    var = ((sq - count[:, None] * mean * mean)
           / torch.clamp(count - 1.0, min=1.0)[:, None])
    std = torch.sqrt(torch.clamp(var, min=0.0) + _EPS)
    return mean, std, count


def _valid(c_count: torch.Tensor, s_count: torch.Tensor) -> torch.Tensor:
    """rpst's label filter on the per-label pixel counts of both sides."""
    return ((c_count > 10) & (s_count > 10)
            & (c_count < 100 * s_count) & (s_count < 100 * c_count))


def label_validity(content_labels: torch.Tensor, style_labels: torch.Tensor,
                   num_labels: int) -> torch.Tensor:
    """(N, num_labels) bool: which labels of each sample pass the filter
    at the label maps' own size (the RP models' every scale; SourceNet
    fuses at relu4_1, on maps resized to its grid)."""
    def counts(labels):
        flat = labels.reshape(labels.shape[0], -1).long()
        ok = (flat >= 0) & (flat < num_labels)
        return torch.stack([torch.bincount(f[m], minlength=num_labels)
                            for f, m in zip(flat, ok)]).float()
    return _valid(counts(content_labels), counts(style_labels))


def masked_adain(content_feat: torch.Tensor, style_feat: torch.Tensor,
                 content_labels: torch.Tensor, style_labels: torch.Tensor,
                 num_labels: int) -> torch.Tensor:
    """Per-label AdaIN of one sample: content_feat (H, W, C), style_feat
    (Hs, Ws, C), content_labels (H, W) and style_labels (Hs, Ws) integer
    label maps -> (H, W, C) in content_feat's type."""
    h, w, c = content_feat.shape
    with torch.autocast(content_feat.device.type, enabled=False):
        cf = content_feat.reshape(-1, c).float()
        sf = style_feat.reshape(-1, c).float()
        cl = content_labels.reshape(-1).to(cf.device)
        sl = style_labels.reshape(-1).to(cf.device)
        lids = torch.arange(num_labels, device=cf.device, dtype=cl.dtype)
        c_mean, c_std, c_count = _per_label_stats(
            cf, (cl[None, :] == lids[:, None]).float())
        s_mean, s_std, s_count = _per_label_stats(
            sf, (sl[None, :] == lids[:, None]).float())
        valid = _valid(c_count, s_count)
        in_range = (cl >= 0) & (cl < num_labels)
        idx = torch.clamp(cl, 0, num_labels - 1).long()
        pix_valid = (valid[idx] & in_range)[:, None]
        normalized = (cf - c_mean[idx]) / c_std[idx] * s_std[idx] + s_mean[idx]
        out = torch.where(pix_valid, normalized, cf)
    return out.reshape(h, w, c).to(content_feat.dtype)


def masked_adain_batch(content_feat: torch.Tensor, style_feat: torch.Tensor,
                       content_labels: torch.Tensor,
                       style_labels: torch.Tensor,
                       num_labels: int) -> torch.Tensor:
    """``masked_adain`` over a batch (N, H, W, C), one sample at a time as
    the reference loops (``do_mask_stylized``, ``adain_rp.py:313-319``;
    rpst vmaps): the temporaries stay one sample's size."""
    return torch.stack([
        masked_adain(content_feat[i], style_feat[i], content_labels[i],
                     style_labels[i], num_labels)
        for i in range(content_feat.shape[0])])


def masked_adain_nchw(content_feat: torch.Tensor, style_feat: torch.Tensor,
                      content_labels: torch.Tensor,
                      style_labels: torch.Tensor,
                      num_labels: int) -> torch.Tensor:
    """``masked_adain_batch`` on NCHW features (views in and out)."""
    out = masked_adain_batch(content_feat.permute(0, 2, 3, 1),
                             style_feat.permute(0, 2, 3, 1), content_labels,
                             style_labels, num_labels)
    return out.permute(0, 3, 1, 2)
