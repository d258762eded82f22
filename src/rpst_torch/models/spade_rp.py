"""The SPADE RP model; port of ``rpst.models.spade_rp`` (reference
``network/spade_rp.py:149-247``).

Two increasing-depth RP encoders (content and style, zero-padded conv +
ReLU), and a SPADE generator that decodes the *style* features conditioned
on the *content* features (spade_rp.py:215, 227: rpst keeps the argument
order, and so does the port). The encoders run in the working type (under
autocast); the generator computes float32, as rpst's flax convs do
(``nn.spade``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import RPSequence, rp_increase_dims
from ..nn.spade import SpadeDecoder


def autocast_dtype(device_type: str) -> Optional[torch.dtype]:
    """The enclosing autocast's type on ``device_type``, None when off."""
    if not torch.is_autocast_enabled(device_type):
        return None
    return torch.get_autocast_dtype(device_type)


class SpadeRP(nn.Module):
    """``rp_content_encoder``, ``rp_style_encoder`` (3 -> hidden -> ... ->
    hidden * 2^(rp_blocks - 1)) and the SPADE generator ``rp_decoder``."""

    def __init__(self, rp_blocks: int = 5, hidden_dim: int = 2, ndf: int = 2,
                 spade_norm: str = "instance", device=None):
        super().__init__()
        enc_out = hidden_dim * 2 ** (rp_blocks - 1)
        enc = rp_increase_dims(rp_blocks, 3, hidden_dim, enc_out)
        self.rp_content_encoder = RPSequence(enc, device=device)
        self.rp_style_encoder = RPSequence(enc, device=device)
        self.rp_decoder = SpadeDecoder(ndf, spade_norm, condition_nc=enc_out,
                                       device=device)

    def forward(self, content: torch.Tensor, style: torch.Tensor):
        """content, style (N, H, W, 3) NHWC -> stylized (N, H, W, 3)
        float32; the working type is the enclosing autocast's."""
        dtype = autocast_dtype(content.device.type)
        cf = self.rp_content_encoder(content.permute(0, 3, 1, 2))
        sf = self.rp_style_encoder(style.permute(0, 3, 1, 2))
        return self.rp_decoder(sf, cf, dtype).permute(0, 2, 3, 1)
