"""Folded (space-to-depth) forwards of the constant-stack families; port of
``rpst.models.fast_path``.

``stylize_multi_adain_folded`` runs MultiScaleAdaINRP (constant stack)
entirely in the folded (H/2, W/2, 4C) domain: fold once at the input, every
conv / pad / AdaIN / lrelu in folded space, unfold once at the output. It
consumes the same parameters as the standard model; it is an execution
strategy, not a different model. Serving folds them once, detached, with
``folded_blocks``; training folds the live parameters on every step with
``live_folded_blocks``, so that B3's dk sums back through
``fold_conv_kernel`` onto each HWIO kernel (36 placements of 9 taps).

The three variants on the same stack (rpst ``fast_path.py:139-392``):

  * ``stylize_sel_multi_adain_folded`` (and ``_train``): the running AdaIN
    re-fusion with the SE bottleneck on the last fusion, its BatchNorms
    from the running statistics (eval) or the batch's (train, which also
    moves the running statistics, ``_folded_bn_train``); the bottleneck's
    1x1 / zero-pad 3x3 convs fold exactly and run ``F.conv2d``, as rpst
    leaves them to XLA;
  * ``stylize_ccam_folded``: the CCAM residual before each decoder block,
    its position sums as one full-width (4C, 4C) product (``_folded_ccam``);
  * ``stylize_mst_folded``: the MST transform on the deepest scale, on
    features unfolded to raster order for it (its k-means and chain
    labeling are order-sensitive) and refolded.

The row-sharded forms of the three (``models.fast_path_spatial``) run these
same bodies on a row share of the images, with the layer function
(``conv``), the AdaIN (``adain``), the SE bottleneck's 3x3 conv and pool and
the CCAM energy's sum swapped for their halo-exchanging or all-reducing
forms.

Every RP conv layer goes through ``_conv_lrelu``, the one dispatch point: on a
CUDA tensor it launches the hand-written B1 kernel at every layer, the
12->128 and 128->12 image layers included, and under grad mode B1's
autograd Function, whose backward is B2 + B3; on a CPU tensor it takes the
kernels' plain PyTorch versions. rpst's TPU batch policy and 128-lane gate do not
carry over.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.tp import folded_column, tag_folded
from ..nn.attention import BN_EPS, SEBottleneck, bn_batch_stats
from ..ops.folded import (fold, fold_bias, fold_conv1x1_kernel,
                          fold_conv_kernel, folded_adain,
                          folded_channel_affine, folded_channel_pool,
                          folded_zero_conv, unfold)
from ..ops.folded_conv import fused_folded_conv
from ..ops.mst import mst_transfer_batch

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
        # a column share (model axis) folds to the share's 4 Co / tp
        # outputs, tagged for ``dist.tp.folded_column``
        out.append((tag_folded(fold_conv_kernel(kernel).to(dtype)
                               .contiguous(), conv.weight),
                    fold_bias(bias).to(dtype).contiguous()))
    return out


def folded_blocks(model, dtype=torch.bfloat16,
                  detach: bool = True) -> Tuple[Blocks, Blocks]:
    """(encoder, decoder) lists of (folded_kernel, folded_bias) in ``dtype``
    from a MultiScaleAdaINRP, or from a variant's ``ms``; fold once,
    stylize many times."""
    ms = getattr(model, "ms", model)
    return (_stack_blocks(ms.rp_shared_encoder, dtype, detach),
            _stack_blocks(ms.rp_decoder, dtype, detach))


def live_folded_blocks(model, dtype=torch.float32) -> Tuple[Blocks, Blocks]:
    """``folded_blocks`` without the detach: folded from the live
    parameters inside autograd, for the training step (fold every step)."""
    return folded_blocks(model, dtype, detach=False)


def _encode(enc: Blocks, img, dtype, conv: Callable) -> List[torch.Tensor]:
    """The folded encoder's intermediate features of one image batch."""
    x = fold(img.to(dtype))
    feats = []
    for k, b in enc:
        x = conv(x, k, b)
        feats.append(x)
    return feats


def _encode_folded(blocks, content, style, dtype, conv: Callable = _conv_lrelu):
    """Content and style through the shared folded encoder, two passes as
    rpst runs them: (content features, style features)."""
    return (_encode(blocks[0], content, dtype, conv),
            _encode(blocks[0], style, dtype, conv))


def stylize_multi_adain_folded(blocks: Tuple[Blocks, Blocks], content,
                               style, dtype=torch.bfloat16,
                               batch_encode: bool = False,
                               conv: Callable = _conv_lrelu,
                               adain: Callable = folded_adain
                               ) -> torch.Tensor:
    """Folded-domain MultiScaleAdaINRP forward: encode both images keeping
    all intermediates, AdaIN at the deepest scale, then per-scale residual
    re-fusion through the decoder. content, style (N, H, W, 3) NHWC with
    even H, W; ``blocks`` from ``folded_blocks(model, dtype)``.

    ``batch_encode`` runs content and style as one 2N encoder pass (exact:
    the encoder is shared), 5 + 5 layers instead of 5 + 5 + 5 at rp_blocks 5.
    ``conv`` is the layer function; a benchmark passes B1's plain version
    to time it on the card; ``adain`` the fusion (a row shard's all-reduces
    its statistics). With ``live_folded_blocks`` the result is
    differentiable with respect to the model's parameters."""
    enc, dec = blocks
    if batch_encode:
        n = content.shape[0]
        feats = _encode(enc, torch.cat([content, style], dim=0), dtype, conv)
        c_feats = [f[:n] for f in feats]
        s_feats = [f[n:] for f in feats]
    else:
        c_feats, s_feats = _encode_folded(blocks, content, style, dtype,
                                          conv)

    k, b = dec[0]
    stylized = conv(adain(c_feats[-1], s_feats[-1]), k, b)
    pairs = list(zip(c_feats[:-1], s_feats[:-1]))[::-1]
    for i, (cf, sf) in enumerate(pairs):
        k, b = dec[i + 1]
        stylized = conv(stylized + adain(cf, sf), k, b)
    return unfold(stylized).to(content.dtype)


# ---------------------------------------------------------------------------
# sel_multi_adain: the SE bottleneck in the folded domain
# ---------------------------------------------------------------------------

def se_weights(block: SEBottleneck, dtype, detach: bool = True
               ) -> Dict[str, object]:
    """The SE bottleneck's weights for the folded path: the three convs
    folded in ``dtype`` (``k1`` / ``k3`` block-diagonal 1x1, ``k2`` the
    folded 3x3), the BatchNorms' (weight, bias) and the SE layer's two
    Linear weights in float32, and the modules themselves (``bn``, whose
    running statistics eval mode reads and train mode moves). Detached
    for serving; live (differentiable) for training. A conv whose kernel
    a model axis shards folds to its share's outputs, tagged for
    ``dist.tp.folded_column`` (column parallel, as the RP stacks)."""
    def p(t):
        return t.detach() if detach else t

    def folded(conv, fold_kernel):
        k = fold_kernel(p(conv.weight).permute(2, 3, 1, 0)).to(dtype)
        return tag_folded(k, conv.weight)

    return {
        "k1": folded(block.conv1, fold_conv1x1_kernel),
        "k2": folded(block.conv2, fold_conv_kernel),
        "k3": folded(block.conv3, fold_conv1x1_kernel),
        "affine": [(p(bn.weight).float(), p(bn.bias).float())
                   for bn in (block.bn1, block.bn2, block.bn3)],
        "dense": [p(block.SELayer_0.Dense_0.weight).float(),
                  p(block.SELayer_0.Dense_1.weight).float()],
        "bn": [block.bn1, block.bn2, block.bn3],
    }


def _folded_bn_affine(affine, bn, eps: float = BN_EPS):
    """Eval-mode BatchNorm (running statistics) as a per-channel affine,
    float32."""
    weight, bias = affine
    scale = weight / torch.sqrt(bn.running_var + eps)
    return scale, bias - bn.running_mean * scale


def _folded_bn_train(x_f, affine, bn, eps: float = BN_EPS):
    """Train-mode BatchNorm on a folded tensor: the batch statistics reduce
    exactly over (N, Hf, Wf, sub-position) per original channel, in rpst's
    E[x^2] - E[x]^2 form in float32; the module's running statistics move
    (momentum 0.9, in place)."""
    n, hh, ww, c4 = x_f.shape
    # one row per original channel, its N * Hf * Wf * 4 values contiguous
    rows = x_f.reshape(-1, c4 // 4).t()
    mean, var = bn_batch_stats(rows, 1)
    weight, bias = affine
    scale = weight / torch.sqrt(var + eps)
    shift = bias - mean * scale
    bn.update_running(mean.detach(), var.detach())
    return folded_channel_affine(x_f, scale.to(x_f.dtype),
                                 shift.to(x_f.dtype))


def _folded_se_bottleneck(x_f, se, dtype, train: bool = False,
                          conv3x3: Callable = folded_zero_conv,
                          pool: Callable = folded_channel_pool):
    """SEBottleneck (rpst ``nn/attention.py:53-82``) in the folded domain:
    the 1x1 and zero-pad 3x3 convs fold exactly, the BatchNorms apply as
    tiled channel affines (running statistics, or the batch's in train
    mode), and the SE pool is the exact mean over (Hf, Wf, sub-position).
    ``conv3x3`` and ``pool``: the zero-pad 3x3 conv and the pool (a row
    shard's exchange halo rows and all-reduce the sums). A column share's
    kernel (``se_weights`` on a model axis) computes its output channels,
    gathered in the folded channel order."""
    def bn(x, i):
        if train:
            return _folded_bn_train(x, se["affine"][i], se["bn"][i])
        s, b = _folded_bn_affine(se["affine"][i], se["bn"][i])
        return folded_channel_affine(x, s.to(dtype), b.to(dtype))

    def column(conv):
        return folded_column(lambda x, k, b: conv(x, k))

    conv1x1 = column(folded_zero_conv)
    out = F.relu(bn(conv1x1(x_f, se["k1"], None), 0))
    out = F.relu(bn(column(conv3x3)(out, se["k2"], None), 1))
    out = bn(conv1x1(out, se["k3"], None), 2)
    y = pool(out).float()
    y = F.relu(F.linear(y, se["dense"][0]))
    y = torch.sigmoid(F.linear(y, se["dense"][1]))
    out = folded_channel_affine(out, y.to(out.dtype))
    return F.relu(out + x_f)


def stylize_sel_multi_adain_folded(blocks, se, content, style,
                                   dtype=torch.bfloat16,
                                   conv: Callable = _conv_lrelu,
                                   train: bool = False,
                                   adain: Callable = folded_adain,
                                   bottleneck: Callable = _folded_se_bottleneck
                                   ) -> torch.Tensor:
    """Folded SELastRP (reference ``adain_rp.py:451-481``): the running
    AdaIN re-fusion, the SE bottleneck (``se_weights``) on the final
    fusion, no residual add. ``train`` is rpst's
    ``stylize_sel_multi_adain_folded_train``: batch-statistic BatchNorms,
    whose running statistics move in place (the caller restores them on a
    skipped step)."""
    c_feats, s_feats = _encode_folded(blocks, content, style, dtype, conv)
    dec = blocks[1]
    k, b = dec[0]
    stylized = conv(adain(c_feats[-1], s_feats[-1]), k, b)
    pairs = s_feats[:-1][::-1]
    for i, sf in enumerate(pairs):
        stylized = adain(stylized, sf)
        if i == len(pairs) - 1:
            stylized = bottleneck(stylized, se, dtype, train)
        k, b = dec[i + 1]
        stylized = conv(stylized, k, b)
    return unfold(stylized).to(content.dtype)


# ---------------------------------------------------------------------------
# ccam and mst
# ---------------------------------------------------------------------------

def _block_eye4(attention: torch.Tensor) -> torch.Tensor:
    """(N, C, C) -> kron(I4, attention) (N, 4C, 4C)."""
    n, c, _ = attention.shape
    eye = torch.eye(4, dtype=attention.dtype, device=attention.device)
    return torch.einsum("st,nck->nsctk", eye, attention).reshape(
        n, 4 * c, 4 * c)


def _ccam_attention(energy: torch.Tensor, scale: float = 1.0
                    ) -> torch.Tensor:
    """softmax(max - e) over the last axis, e the sum of the diagonal blocks
    of the folded (N, 4C, 4C) cross product (the position sums split exactly
    over the 4 sub-position blocks), times ``scale`` (the int8 path's
    s_x s_y)."""
    n, c4, _ = energy.shape
    c = c4 // 4
    blocks = energy.reshape(n, 4, c, 4, c)
    e = blocks[:, 0, :, 0] + blocks[:, 1, :, 1] + blocks[:, 2, :, 2] \
        + blocks[:, 3, :, 3]
    if scale != 1.0:
        e = e * scale
    return torch.softmax(e.amax(dim=-1, keepdim=True) - e, dim=-1)


def _folded_ccam(x_f, y_f, scale, reduce: Optional[Callable] = None):
    """CCAMDec (reference ``adain_rp.py:167-189``) on folded tensors: the
    energy from one full-width (4C, 4C) product in float32 (its diagonal
    blocks summed), the recombination through kron(I4, attention) in the
    features' type. Inputs detached: only ``scale`` gets a gradient.
    ``reduce``: applied to the energy, a sum over positions (a row shard
    all-reduces it)."""
    x_f, y_f = x_f.detach(), y_f.detach()
    n, hh, ww, c4 = x_f.shape
    xr = x_f.reshape(n, hh * ww, c4)
    yr = y_f.reshape(n, hh * ww, c4)
    energy = torch.einsum("npa,npb->nab", xr.float(), yr.float())
    if reduce is not None:
        energy = reduce(energy)
    att4 = _block_eye4(_ccam_attention(energy))
    out = torch.einsum("npk,nck->npc", yr, att4.to(yr.dtype))
    return x_f + scale * out.reshape(n, hh, ww, c4)


def stylize_ccam_folded(blocks, scales, content, style,
                        stylized_layers: int = 5, dtype=torch.bfloat16,
                        conv: Callable = _conv_lrelu,
                        adain: Callable = folded_adain,
                        ccam: Callable = _folded_ccam) -> torch.Tensor:
    """Folded CCAMRP (reference ``adain_rp.py:348-422``): AdaIN fusion plus
    the CCAM residual before each decoder block, ``stylized_layers``
    scales. ``scales`` are the ``ccam_{i}.scale`` parameters (live in
    training)."""
    c_feats, s_feats = _encode_folded(blocks, content, style, dtype, conv)
    dec = blocks[1]

    def scale(i):
        return scales[i].to(dtype)

    stylized = adain(c_feats[-1], s_feats[-1])
    att_res = ccam(c_feats[-1], s_feats[-1], scale(0))
    k, b = dec[0]
    stylized = conv(stylized + att_res, k, b)
    for i, sf in enumerate(s_feats[:-1][::-1]):
        k, b = dec[i + 1]
        if i + 1 < stylized_layers:
            stylized = adain(stylized, sf)
            stylized = conv(stylized + ccam(stylized, sf, scale(i + 1)), k,
                            b)
        else:
            stylized = conv(stylized, k, b)
    return unfold(stylized).to(content.dtype)


def folded_mst(cf_f, sf_f, n_clusters: int, lam: float, dtype):
    """The MST transform of two folded tensors (detached): unfolded to
    raster order for it, refolded in ``dtype``."""
    out = mst_transfer_batch(unfold(cf_f.detach()), unfold(sf_f.detach()),
                             n_clusters, lam)
    return fold(out.to(dtype))


def stylize_mst_folded(blocks, content, style, stylized_layers: int = 1,
                       n_clusters: int = 3, mst_lambda: float = 0.0,
                       dtype=torch.bfloat16,
                       conv: Callable = _conv_lrelu) -> torch.Tensor:
    """Folded MSTRP (reference ``adain_rp.py:425-448``): the MST transform
    on the deepest scale (and the next ``stylized_layers - 1``), everything
    else folded. The transform detaches its inputs, so gradients reach only
    the decoder; the encoder runs without autograd."""
    with torch.no_grad():
        c_feats, s_feats = _encode_folded(blocks, content, style, dtype,
                                          conv)
    dec = blocks[1]
    k, b = dec[0]
    stylized = conv(folded_mst(c_feats[-1], s_feats[-1], n_clusters,
                               mst_lambda, dtype), k, b)
    for i, sf in enumerate(s_feats[:-1][::-1]):
        if i + 1 < stylized_layers:
            stylized = folded_mst(stylized, sf, n_clusters, mst_lambda,
                                  dtype)
        k, b = dec[i + 1]
        stylized = conv(stylized, k, b)
    return unfold(stylized).to(content.dtype)
