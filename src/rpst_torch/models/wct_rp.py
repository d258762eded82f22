"""The WCT RP model; port of ``rpst.models.wct_rp.WCTRP`` (reference
``network/wct_rp.py:42-194``).

The increasing RP encoder and decreasing RP decoder of ``AdaINRP`` with a
whitening-coloring fuse at the deepest feature. The fuse detaches both
inputs, so only the decoder receives gradients through it (the encoder's
are zero, as in rpst). A training run that resumes freezes the encoder
(``train_torch.py``, rpst's ``freeze_prefixes``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.wct import wct_fuse
from .adain_rp import encode_pair, rp_sequence_pair

WCT_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class WCTRP(nn.Module):
    """``method``: "closed-form" (the reference's default) or "original";
    ``wct_dtype``: "float32" or "float64" (the reference whitens in float64),
    the type of the covariance and eigendecomposition."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 16,
                 method: str = "closed-form", wct_dtype: str = "float32",
                 device=None, dtype=None):
        super().__init__()
        if wct_dtype not in WCT_DTYPES:
            raise ValueError(f"wct_dtype must be one of {sorted(WCT_DTYPES)}, "
                             f"got {wct_dtype!r}")
        self.method, self.wct_dtype = method, WCT_DTYPES[wct_dtype]
        self.encoder, self.decoder = rp_sequence_pair(rp_blocks, hidden_dim,
                                                      device, dtype)

    def forward(self, content: torch.Tensor, style: torch.Tensor):
        """content, style (N, H, W, 3) NHWC -> stylized (N, H, W, 3)."""
        cf, sf = encode_pair(self.encoder, content, style)
        fused = wct_fuse(cf.permute(0, 2, 3, 1), sf.permute(0, 2, 3, 1),
                         method=self.method, dtype=self.wct_dtype)
        return self.decoder(fused.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
