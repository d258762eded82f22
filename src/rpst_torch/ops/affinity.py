"""Affinity and distance ops; port of ``rpst.ops.affinity``:

  * ``cal_affinity_matrix``: the adaptive SANet's batched cosine affinity
    (reference ``network/sanet.py:12-18``);
  * ``cal_dist``, ``cal_affinity_map`` and the streamed
    ``mrf_topk_masked_dist_sum``: the MRF loss's squared distances and its
    top-k union mask (reference ``network/base.py:317-360``).

Plain PyTorch on the device: rpst has no Pallas kernel for them.
"""

from __future__ import annotations

import torch


def l2_normalize_channels(x: torch.Tensor) -> torch.Tensor:
    """(N, P, C) rows divided by their L2 norm, clamped at 1e-12 (the
    reference's ``F.normalize`` over channels)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=2, keepdim=True),
                           min=1e-12)


def cal_affinity_matrix(content_feat: torch.Tensor,
                        style_feat: torch.Tensor) -> torch.Tensor:
    """Batched cosine affinity: (N, Hc, Wc, C), (N, Hs, Ws, C) NHWC ->
    (N, HWc, HWs), in the features' type."""
    n, h, w, c = content_feat.shape
    cf = l2_normalize_channels(content_feat.reshape(n, h * w, c))
    sf = l2_normalize_channels(style_feat.reshape(n, -1, c))
    return torch.matmul(cf, sf.transpose(1, 2))


# ---------------------------------------------------------------- MRF

def cal_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances: a (..., d, m), b (..., d, n)
    -> (..., m, n), D[i, j] = |a[:, i]|^2 + |b[:, j]|^2 - 2 a[:, i] . b[:, j]
    (reference ``network/base.py:349-360``; cancellation may leave small
    negative values, which the MRF loss tolerates)."""
    a2 = (a * a).sum(dim=-2).unsqueeze(-1)
    b2 = (b * b).sum(dim=-2).unsqueeze(-2)
    return a2 + b2 - 2.0 * torch.matmul(a.transpose(-1, -2), b)


def _topk_mask(scores: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """0/1 mask (scores' type) with the top-k entries along ``dim`` set, by
    index, as rpst's ``lax.top_k`` + scatter: a stable descending sort, so
    that among exact ties (post-ReLU features repeat) the lower index is
    taken, as ``lax.top_k`` takes it (``torch.topk`` may take another)."""
    idx = torch.sort(scores, dim=dim, descending=True,
                     stable=True).indices.narrow(dim, 0, k)
    return torch.zeros_like(scores).scatter_(dim, idx, 1.0)


def cal_affinity_map(content_feat: torch.Tensor, style_feat: torch.Tensor,
                     k: int = 3, reverse: bool = False) -> torch.Tensor:
    """0/1 affinity between content and style positions: (..., H, W, C)
    NHWC maps (one sample or a batch) -> (..., HW, HW), 1 where a pair is
    among its column's or its row's top-k of the channel-normalized cosine
    similarity (``reverse``: of its negation); in the features' type. The
    mask is a constant of the loss: it carries no gradient."""
    *lead, h, w, c = content_feat.shape
    with torch.no_grad():
        cf = l2_normalize_channels(content_feat.reshape(-1, h * w, c))
        sf = l2_normalize_channels(style_feat.reshape(-1, h * w, c))
        attention = torch.matmul(cf, sf.transpose(1, 2))
        if reverse:
            attention = -attention
        mask = torch.maximum(_topk_mask(attention, k, 1),
                             _topk_mask(attention, k, 2))
    return mask.reshape(*lead, h * w, h * w)


def mrf_topk_masked_dist_sum(content_feat: torch.Tensor,
                             style_feat: torch.Tensor, k: int,
                             chunk: int = 1024) -> torch.Tensor:
    """``sum(cal_affinity_map * cal_dist)`` of one (H, W, C) pair in row
    chunks of ``chunk`` content positions, never holding an (HW, HW) matrix
    (rpst's streamed form, ``ops/affinity.py:89-162``): a first pass keeps
    every style position's running top-k similarity over the chunks, a
    second builds each chunk's union mask ``sim >= row k-th or sim >=
    column k-th`` and sums the masked distances. Equal to the dense route
    for distinct similarities; exact ties at a k-th value may add pairs.
    The gradient flows through the distances only."""
    h, w, c = content_feat.shape
    hw = h * w
    cf = content_feat.reshape(hw, c)
    sf = style_feat.reshape(hw, c)
    chunk = min(chunk, hw)
    with torch.no_grad():
        cfn = l2_normalize_channels(cf[None])[0]
        sfn = l2_normalize_channels(sf[None])[0]
        col_top = torch.full((hw, k), float("-inf"), dtype=cf.dtype,
                             device=cf.device)
        for i in range(0, hw, chunk):
            sim = cfn[i:i + chunk] @ sfn.T              # (chunk, HW)
            col_top = torch.topk(torch.cat([col_top, sim.T], dim=1), k,
                                 dim=1).values
        col_kth = col_top[:, -1]
    b2 = (sf * sf).sum(dim=1)
    total = torch.zeros((), dtype=cf.dtype, device=cf.device)
    for i in range(0, hw, chunk):
        cfc = cf[i:i + chunk]
        with torch.no_grad():
            sim = cfn[i:i + chunk] @ sfn.T
            row_kth = torch.topk(sim, k, dim=1).values[:, -1]
            mask = (sim >= row_kth[:, None]) | (sim >= col_kth[None, :])
        a2 = (cfc * cfc).sum(dim=1)
        dist = a2[:, None] + b2[None, :] - 2.0 * (cfc @ sf.T)
        total = total + torch.where(mask, dist, dist.new_zeros(())).sum()
    return total
