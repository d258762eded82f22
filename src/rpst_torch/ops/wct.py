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
"""

from __future__ import annotations

import torch

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
                     method: str = "closed-form") -> torch.Tensor:
    """WCT on flattened features: cF (..., C, Mc) content (channels x
    pixels), sF (..., C, Ms) style -> (..., C, Mc); leading batch dimensions
    are carried through (rpst maps the same function over the batch)."""
    c, mc = cF.shape[-2:]
    c_mean = cF.mean(dim=-1, keepdim=True)
    cFc = cF - c_mean
    eye = torch.eye(c, dtype=cF.dtype, device=cF.device)
    content_conv = cFc @ cFc.transpose(-1, -2) / (mc - 1) + eye

    ms = sF.shape[-1]
    s_mean = sF.mean(dim=-1, keepdim=True)
    sFc = sF - s_mean
    style_conv = sFc @ sFc.transpose(-1, -2) / (ms - 1)

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
    cf = content_feat.detach().to(dtype).reshape(n, h * w, c).transpose(1, 2)
    sf = style_feat.detach().to(dtype).reshape(n, -1, c).transpose(1, 2)
    # the covariances and matrix powers stay in ``dtype`` under a caller's
    # bfloat16 autocast too (the style covariance is the signal)
    with torch.autocast(cf.device.type, enabled=False):
        fused = whiten_and_color(cf, sf, method)
    return fused.transpose(1, 2).reshape(n, h, w, c).to(content_feat.dtype)
