"""Folded (space-to-depth) forward of the flagship; port of
``rpst.models.fast_path.stylize_multi_adain_folded``.

``stylize_multi_adain_folded`` runs MultiScaleAdaINRP (constant stack)
entirely in the folded (H/2, W/2, 4C) domain: fold once at the input, every
conv / pad / AdaIN / lrelu in folded space, unfold once at the output. It
consumes the same parameters as the standard model; it is an execution
strategy, not a different model. Serving folds them once, detached, with
``folded_blocks``; training folds the live parameters on every step with
``live_folded_blocks``, so that B3's dk sums back through
``fold_conv_kernel`` onto each HWIO kernel (36 placements of 9 taps).

Every conv layer goes through ``_conv_lrelu``, the one dispatch point: on a
CUDA tensor it launches the hand-written B1 kernel at every layer, the
12->128 and 128->12 image layers included, and under grad mode B1's
autograd Function, whose backward is B2 + B3; on a CPU tensor it takes the
kernels' plain PyTorch versions. rpst's TPU batch policy and 128-lane gate do not
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


def _stack_blocks(stack, dtype, detach: bool = True) -> Blocks:
    out = []
    for blk in stack.blocks:
        conv = blk.PadConv_0.Conv_0
        weight, bias = conv.weight, conv.bias
        if detach:
            weight, bias = weight.detach(), bias.detach()
        kernel = weight.permute(2, 3, 1, 0)  # OIHW -> HWIO
        out.append((fold_conv_kernel(kernel).to(dtype).contiguous(),
                    fold_bias(bias).to(dtype).contiguous()))
    return out


def folded_blocks(model, dtype=torch.bfloat16) -> Tuple[Blocks, Blocks]:
    """(encoder, decoder) lists of (folded_kernel, folded_bias) in ``dtype``
    from a MultiScaleAdaINRP; fold once, stylize many times."""
    return (_stack_blocks(model.rp_shared_encoder, dtype),
            _stack_blocks(model.rp_decoder, dtype))


def live_folded_blocks(model, dtype=torch.float32) -> Tuple[Blocks, Blocks]:
    """``folded_blocks`` without the detach: folded from the live
    parameters inside autograd, for the training step (fold every step)."""
    return (_stack_blocks(model.rp_shared_encoder, dtype, detach=False),
            _stack_blocks(model.rp_decoder, dtype, detach=False))


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
    to time it on the card. With ``live_folded_blocks`` the result is
    differentiable with respect to the model's parameters."""
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
