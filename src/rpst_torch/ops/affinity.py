"""The content-style cosine affinity of the adaptive SANet; port of
``rpst.ops.affinity.cal_affinity_matrix`` (reference
``network/sanet.py:12-18``). The MRF top-k functions of that module come
with slice 5b.
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
