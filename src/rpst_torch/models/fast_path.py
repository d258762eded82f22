"""Folded (space-to-depth) inference of the flagship; port of
``rpst.models.fast_path.stylize_multi_adain_folded``.

``stylize_multi_adain_folded`` runs MultiScaleAdaINRP (constant stack)
entirely in the folded (H/2, W/2, 4C) domain: fold once at the input, every
conv / pad / AdaIN / lrelu in folded space, unfold once at the output. It
consumes the same parameters as the standard model, folded once by
``folded_blocks``; it is an execution strategy, not a different model.

Every conv layer goes through ``_conv_lrelu``, the one dispatch point: on a
CUDA tensor it launches the hand-written B1 kernel at every layer, the
12->128 and 128->12 image layers included; on a CPU tensor it takes B1's
plain PyTorch version. rpst's TPU batch policy and 128-lane gate do not
carry over.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from ..ops.folded import fold, fold_bias, fold_conv_kernel, folded_adain, unfold
from ..ops.folded_conv import fused_folded_conv

Blocks = List[Tuple[torch.Tensor, torch.Tensor]]


def _conv_lrelu(x, k, b):
    """One folded conv + bias + lrelu layer (B1 on CUDA, plain on CPU)."""
    return fused_folded_conv(x, k, b, 0.2)


def _stack_blocks(stack, dtype) -> Blocks:
    out = []
    for blk in stack.blocks:
        conv = blk.PadConv_0.Conv_0
        kernel = conv.weight.detach().permute(2, 3, 1, 0)  # OIHW -> HWIO
        out.append((fold_conv_kernel(kernel).to(dtype).contiguous(),
                    fold_bias(conv.bias.detach()).to(dtype).contiguous()))
    return out


def folded_blocks(model, dtype=torch.bfloat16) -> Tuple[Blocks, Blocks]:
    """(encoder, decoder) lists of (folded_kernel, folded_bias) in ``dtype``
    from a MultiScaleAdaINRP; fold once, stylize many times."""
    return (_stack_blocks(model.rp_shared_encoder, dtype),
            _stack_blocks(model.rp_decoder, dtype))


def stylize_multi_adain_folded(blocks: Tuple[Blocks, Blocks], content,
                               style, dtype=torch.bfloat16,
                               batch_encode: bool = False,
                               conv: Callable = _conv_lrelu) -> torch.Tensor:
    """Folded-domain MultiScaleAdaINRP forward: encode both images keeping
    all intermediates, AdaIN at the deepest scale, then per-scale residual
    re-fusion through the decoder. content, style (N, H, W, 3) NHWC with
    even H, W; ``blocks`` from ``folded_blocks(model, dtype)``.

    ``batch_encode`` runs content and style as one 2N encoder pass (exact:
    the encoder is shared), 5 + 5 layers instead of 5 + 5 + 5 at rp_blocks 5.
    ``conv`` is the layer function; a benchmark passes B1's plain version
    to time it on the card."""
    enc, dec = blocks

    def encode(img):
        x = fold(img.to(dtype))
        feats = []
        for k, b in enc:
            x = conv(x, k, b)
            feats.append(x)
        return feats

    if batch_encode:
        n = content.shape[0]
        feats = encode(torch.cat([content, style], dim=0))
        c_feats = [f[:n] for f in feats]
        s_feats = [f[n:] for f in feats]
    else:
        c_feats = encode(content)
        s_feats = encode(style)

    k, b = dec[0]
    stylized = conv(folded_adain(c_feats[-1], s_feats[-1]), k, b)
    pairs = list(zip(c_feats[:-1], s_feats[:-1]))[::-1]
    for i, (cf, sf) in enumerate(pairs):
        k, b = dec[i + 1]
        stylized = conv(stylized + folded_adain(cf, sf), k, b)
    return unfold(stylized).to(content.dtype)
