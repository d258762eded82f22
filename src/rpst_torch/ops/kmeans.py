"""Deterministic k-means for MST's style clustering; port of
``rpst.ops.kmeans``, in plain PyTorch on the device (rpst's is XLA, no
Pallas kernel).

Farthest-point seeding from the first row, then a fixed number of Lloyd
steps. An empty cluster keeps its previous center. ``argmax`` / ``argmin``
take the first index on ties, as ``jnp``'s do. Distances use rpst's
expanded form ``|x|^2 + |y|^2 - 2 x.y`` clamped at 0, whose float sums run
in another order on cuBLAS than on XLA: a near-tie can flip a label.
"""

from __future__ import annotations

import torch


def _pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (n, d), y (m, d) -> (n, m) squared distances."""
    x2 = (x * x).sum(dim=1)[:, None]
    y2 = (y * y).sum(dim=1)[None, :]
    return torch.clamp(x2 + y2 - 2.0 * (x @ y.t()), min=0.0)


def _seed_centers(x: torch.Tensor, k: int) -> torch.Tensor:
    """Farthest-point seeding (k-means++ without randomness)."""
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[0]
    mind = ((x - x[0]) ** 2).sum(dim=1)
    for i in range(1, k):
        nxt = torch.argmax(mind)
        centers[i] = x[nxt]
        mind = torch.minimum(mind, ((x - x[nxt]) ** 2).sum(dim=1))
    return centers


def kmeans(x: torch.Tensor, k: int, iters: int = 25):
    """Cluster the rows of x (n, d) into k groups -> (labels (n,) int64,
    centers (k, d) float32)."""
    x = x.float()
    centers = _seed_centers(x, k)
    for _ in range(iters):
        labels = torch.argmin(_pairwise_sq_dist(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        count = onehot.sum(dim=0)
        sums = onehot.t() @ x
        centers = torch.where(count[:, None] > 0,
                              sums / torch.clamp(count, min=1.0)[:, None],
                              centers)
    labels = torch.argmin(_pairwise_sq_dist(x, centers), dim=1)
    return labels, centers
