"""The VGG perceptual loss with stages 1-2 in the folded (space-to-depth)
domain; port of ``rpst.nn.vgg_folded``.

The same math as ``VGG19Encoder`` + ``perceptual_rp_losses`` up to float
reassociation, through two exact identities besides the folded conv:

  * the ceil-mode 2x2/2 max pool of the image equals the max over the 4
    sub-position channel blocks of the folded tensor (``_group_max_pool``),
    already in standard layout at the pooled resolution;
  * per-channel instance mean/std equal ``folded_calc_mean_std``.

The four folded layers (relu1_1 12->256, relu1_2 256->256, relu2_1
256->512, relu2_2 512->512 folded channels) go through ``conv_act``, by
default B1's autograd Function with alpha = 0: B1 forward on every pass,
B2 backward into the stylized image; B3 never runs, since the encoder's
weights are frozen. rpst's batch <= 4 and 128-lane gates and its Mosaic
gate are TPU policy and do not carry over. Stages 3-4 stay standard
``F.conv2d``, as rpst leaves them to XLA.

``perceptual_rp_losses_q8targets`` (``train_q8_targets``) computes the
style and content targets through the int8 VGG chain on B5 instead, and
``perceptual_rp_losses_folded_pretargets`` takes them precomputed (the
target cache).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from ..ops.folded import fold, folded_calc_mean_std
from ..ops.folded_conv import folded_conv_act
from ..ops.stats import calc_mean_std
from .blocks import pad2d
from .vgg import VGG19Encoder, maxpool_ceil

# conv_act(x_f, folded_kernel, folded_bias, alpha, listed=False): the live
# training fold passes listed=True (the kernel is fold_conv_kernel's output,
# so B3 may compute only its 36 listed blocks); the frozen VGG never does
ConvAct = Callable[..., torch.Tensor]
Stats = List[Tuple[torch.Tensor, torch.Tensor]]


def _folded_conv_relu(x_f, kf, bf, conv_act: ConvAct = folded_conv_act):
    """relu(folded reflect conv + bias): ``conv_act`` with alpha = 0."""
    return conv_act(x_f, kf, bf, 0.0)


def _group_max_pool(x_f: torch.Tensor) -> torch.Tensor:
    """Folded (N, H, W, 4C) -> pooled standard (N, H, W, C): the ceil-mode
    2x2/2 max pool of the unfolded tensor (exact: it was foldable)."""
    n, h, w, c4 = x_f.shape
    return x_f.reshape(n, h, w, 4, c4 // 4).amax(dim=3)


def vgg_perceptual_stats(vgg: VGG19Encoder, x: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16,
                         conv_act: ConvAct = folded_conv_act
                         ) -> Tuple[Stats, torch.Tensor]:
    """relu{1..4}_1 per-channel instance (mean, std) pairs, each (N, C)
    float32, and relu4_1 (N, H/8, W/8, 512), with stages 1-2 folded.
    x (N, H, W, 3) NHWC with H, W divisible by 4; the 4-stage encoder."""
    if vgg.num_stages != 4:
        raise ValueError("vgg_perceptual_stats takes the 4-stage encoder")

    def kb(i):
        conv = vgg.conv(i)
        return conv.weight.to(dtype), conv.bias.to(dtype)

    def folded_stats(x_f):
        m4, s4 = folded_calc_mean_std(x_f)
        c = x_f.shape[-1] // 4
        return m4[:, 0, 0, :c].float(), s4[:, 0, 0, :c].float()

    def std_stats(x):
        m, s = calc_mean_std(x.permute(0, 2, 3, 1).float())
        return m[:, 0, 0, :], s[:, 0, 0, :]

    folded = vgg.folded_weights(dtype)
    stats = []
    # conv_0: the 1x1 normalization head, standard
    k0, b0 = kb(0)
    x = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), k0, b0).permute(0, 2, 3, 1)
    # stage 1 (folded): relu1_1, relu1_2, pool
    f = _folded_conv_relu(fold(x).contiguous(), *folded[0], conv_act)
    stats.append(folded_stats(f))
    f = _folded_conv_relu(f, *folded[1], conv_act)
    x = _group_max_pool(f)
    # stage 2 (folded): relu2_1, relu2_2, pool
    f = _folded_conv_relu(fold(x).contiguous(), *folded[2], conv_act)
    stats.append(folded_stats(f))
    f = _folded_conv_relu(f, *folded[3], conv_act)
    x = _group_max_pool(f).permute(0, 3, 1, 2)
    # stages 3-4 (standard, NCHW)
    x = F.relu(F.conv2d(pad2d(x, 1), *kb(5)))             # relu3_1
    stats.append(std_stats(x))
    for i in (6, 7, 8):
        x = F.relu(F.conv2d(pad2d(x, 1), *kb(i)))         # relu3_2..3_4
    x = F.relu(F.conv2d(pad2d(maxpool_ceil(x), 1), *kb(9)))  # relu4_1
    stats.append(std_stats(x))
    return stats, x.permute(0, 2, 3, 1)


def perceptual_rp_losses_folded(vgg: VGG19Encoder, stylized, style, content,
                                content_weight: float, style_weight: float,
                                dtype: torch.dtype = torch.bfloat16,
                                conv_act: ConvAct = folded_conv_act):
    """``models.base.perceptual_rp_losses`` through the folded VGG: the
    style-stat MSE over relu1..4_1 plus the relu4_1 content MSE. The style
    and content targets run as one 2N pass under ``torch.no_grad``."""
    from ..models.base import mse  # models imports this module
    g_stats, g_relu4 = vgg_perceptual_stats(vgg, stylized, dtype, conv_act)
    n = style.shape[0]
    with torch.no_grad():
        t_stats, t_relu4 = vgg_perceptual_stats(
            vgg, torch.cat([style, content], dim=0), dtype, conv_act)
    loss_s = sum(mse(gm, tm[:n]) + mse(gs, ts[:n])
                 for (gm, gs), (tm, ts) in zip(g_stats, t_stats))
    loss_c = mse(g_relu4.float(), t_relu4[n:].float())
    total = content_weight * loss_c + style_weight * loss_s
    return {"style_loss": loss_s, "content_loss": loss_c}, total


def perceptual_rp_losses_folded_pretargets(
        vgg: VGG19Encoder, stylized, t_stats: Stats, t_relu4: torch.Tensor,
        content_weight: float, style_weight: float,
        dtype: torch.dtype = torch.bfloat16,
        conv_act: ConvAct = folded_conv_act):
    """``perceptual_rp_losses_folded`` with the style and content targets
    given, precomputed (``train.target_cache``): the style images' relu1..4_1
    (mean, std) pairs ``t_stats``, each (N, C) float32, and the content
    images' relu4_1 ``t_relu4``. They depend only on the images and the
    frozen encoder, so the step keeps one VGG sweep, the stylized pass that
    carries the gradient (rpst ``nn/vgg_folded.py:166-192``)."""
    from ..models.base import mse  # models imports this module
    g_stats, g_relu4 = vgg_perceptual_stats(vgg, stylized, dtype, conv_act)
    loss_s = sum(mse(gm, tm.detach()) + mse(gs, ts.detach())
                 for (gm, gs), (tm, ts) in zip(g_stats, t_stats))
    loss_c = mse(g_relu4.float(), t_relu4.detach().float())
    total = content_weight * loss_c + style_weight * loss_s
    return {"style_loss": loss_s, "content_loss": loss_c}, total


def perceptual_rp_losses_q8targets(vgg: VGG19Encoder, scales, stylized, style,
                                   content, content_weight: float,
                                   style_weight: float,
                                   dtype: torch.dtype = torch.bfloat16,
                                   conv_act: ConvAct = folded_conv_act):
    """``perceptual_rp_losses_folded`` with the two no-grad target forwards
    (style and content, one 2N pass) through the chained-int8 VGG encoder
    on B5 (``fast_path_q8_std.vgg_target_taps_q8`` with ``scales`` from
    ``calibrate_vgg_targets_q8``). Only the stylized image's VGG pass
    carries gradients and it stays on the folded path; int8 perturbs the
    target values by quantization noise and the backward sweep not at all."""
    from ..models.base import mse  # models imports this module
    from ..models.fast_path_q8_std import vgg_target_taps_q8
    g_stats, g_relu4 = vgg_perceptual_stats(vgg, stylized, dtype, conv_act)
    n = style.shape[0]
    with torch.no_grad():
        taps = vgg_target_taps_q8(vgg, scales,
                                  torch.cat([style, content], dim=0), dtype)
        t_stats = []
        for t in taps:
            m, s = calc_mean_std(t[:n].float())
            t_stats.append((m[:, 0, 0, :], s[:, 0, 0, :]))
        t_relu4 = taps[-1][n:]
    loss_s = sum(mse(gm, tm) + mse(gs, ts)
                 for (gm, gs), (tm, ts) in zip(g_stats, t_stats))
    loss_c = mse(g_relu4.float(), t_relu4.float())
    total = content_weight * loss_c + style_weight * loss_s
    return {"style_loss": loss_s, "content_loss": loss_c}, total
