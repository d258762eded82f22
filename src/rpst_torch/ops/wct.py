"""Whitening-coloring transform (WCT) by symmetric eigendecomposition; port
of ``rpst.ops.wct`` (reference ``network/wct_rp.py:7-114``).

The covariances are symmetric positive semi-definite, so the matrix powers
come from ``torch.linalg.eigh``. Numerics as in rpst and the reference:
``+1e-4`` on the covariance diagonal before the decomposition, eigenvalues
below ``1e-5`` cut, ``+I`` on the content covariance only, both the
"original" (Li et al.) and the "closed-form" (Lu et al., the default) color
transforms, and no gradient into the fused features' inputs.

``eigh`` is free in the sign of each eigenvector and in the basis of
near-equal eigenvalues, and the two frameworks choose differently; ``V f(L)
V^T`` does not depend on the choice. So tests compare fused features, never
eigenvectors. The matrix products run in the ``dtype`` asked for (float32 by
default, float64 works on the CPU and on the card); on CUDA, float32 matmuls
are full float32 unless ``torch.backends.cuda.matmul.allow_tf32`` is set.

On a row share (``dist.row_shares``) the means and covariances are the
whole image's: each share's sums all-reduced in float64 and cast to the
whitening type, the mean first and the centred products about it after,
one device's two passes. Every rank then decomposes the same matrices; no
eigenvector needs to travel, and none would have to agree in sign:
``V f(L) V^T`` is free in each eigenvector's sign.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..dist.collectives import row_axis, sum_rows
from ..dist.mesh import Axis

_EIG_CUTOFF = 1e-5
_DIAG_REG = 1e-4


def _eig_pow(a: torch.Tensor, power: float) -> torch.Tensor:
    """V diag(e^power) V^T with the reference's regularization and cutoff."""
    a = a + _DIAG_REG * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    e, v = torch.linalg.eigh(a)
    e = torch.clamp(e, min=0.0)
    d = torch.where(e >= _EIG_CUTOFF,
                    torch.clamp(e, min=_EIG_CUTOFF) ** power,
                    torch.zeros_like(e))
    return (v * d[..., None, :]) @ v.transpose(-1, -2)


def matrix_sqrt(a: torch.Tensor) -> torch.Tensor:
    """PSD matrix square root; reference ``wct_rp.py:24-40``."""
    return _eig_pow(a, 0.5)


def matrix_inv_sqrt(a: torch.Tensor) -> torch.Tensor:
    """PSD matrix inverse square root; reference ``wct_rp.py:7-22``."""
    return _eig_pow(a, -0.5)


def whiten_and_color(cF: torch.Tensor, sF: torch.Tensor,
                     method: str = "closed-form",
                     rows: Optional[Axis] = None) -> torch.Tensor:
    """WCT on flattened features: cF (..., C, Mc) content (channels x
    pixels), sF (..., C, Ms) style -> (..., C, Mc); leading batch dimensions
    are carried through (rpst maps the same function over the batch).
    ``rows``: the pixels are this rank's row share of that axis, and the
    means and covariances are summed over the shares."""
    def mean(f):
        if rows is None:
            return f.mean(dim=-1, keepdim=True)
        m = f.shape[-1] * rows.size
        return (sum_rows(f.sum(dim=-1, keepdim=True), rows) / m).to(f.dtype)

    def gram(fc):
        g = fc @ fc.transpose(-1, -2)
        return g if rows is None else sum_rows(g, rows).to(g.dtype)

    k = 1 if rows is None else rows.size
    c, mc = cF.shape[-2:]
    c_mean = mean(cF)
    cFc = cF - c_mean
    eye = torch.eye(c, dtype=cF.dtype, device=cF.device)
    content_conv = gram(cFc) / (mc * k - 1) + eye

    ms = sF.shape[-1]
    s_mean = mean(sF)
    sFc = sF - s_mean
    style_conv = gram(sFc) / (ms * k - 1)

    if method == "original":  # Li et al.
        target = matrix_sqrt(style_conv) @ (matrix_inv_sqrt(content_conv)
                                            @ cFc)
    elif method == "closed-form":  # Lu et al. (the reference's default)
        c_sqrt = matrix_sqrt(content_conv)
        c_inv_sqrt = matrix_inv_sqrt(content_conv)
        middle = matrix_sqrt(c_sqrt @ style_conv @ c_sqrt)
        target = (c_inv_sqrt @ middle @ c_inv_sqrt) @ cFc
    else:
        raise ValueError(f"unknown WCT method {method!r}")
    return target + s_mean


def wct_fuse(content_feat: torch.Tensor, style_feat: torch.Tensor,
             method: str = "closed-form",
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched NHWC WCT fusion, detached from its inputs (reference
    ``fuse``, ``wct_rp.py:157-166``): (N, H, W, C) x 2 -> (N, H, W, C) in
    content_feat's type."""
    n, h, w, c = content_feat.shape
    rows = row_axis(content_feat)
    if rows is not row_axis(style_feat):
        raise ValueError("wct_fuse: content and style must both be row "
                         "shares or both whole")
    cf = content_feat.detach().to(dtype).reshape(n, h * w, c).transpose(1, 2)
    sf = style_feat.detach().to(dtype).reshape(n, -1, c).transpose(1, 2)
    # the covariances and matrix powers stay in ``dtype`` under a caller's
    # bfloat16 autocast too (the style covariance is the signal)
    with torch.autocast(cf.device.type, enabled=False):
        fused = whiten_and_color(cf, sf, method, rows)
    return fused.transpose(1, 2).reshape(n, h, w, c).to(content_feat.dtype)
