"""Space-to-depth ("folded") execution of stride-1 RP conv stacks; port of
``rpst.ops.folded`` on NHWC torch tensors.

Every transformation is exact:

  * a stride-1 3x3 conv on the image equals a stride-1 3x3 conv on the
    folded tensor with a structurally sparse (3, 3, 4C, 4Co) kernel
    (``fold_conv_kernel``): 4x the MACs, 9 non-zero taps per output block;
  * a 1-pixel reflection pad equals a ring of channel-block-permuted
    interior slices in the folded domain (``folded_reflect_pad``);
  * AdaIN statistics combine exactly over the 4 sub-position blocks of each
    original channel (``folded_calc_mean_std``).

Channel layout: folded channel (2*si + sj)*C + c holds original pixel
(2i+si, 2j+sj, c). The rpst version builds the ring selects from lane-iota
``where``s to dodge an XLA:TPU miscompile; here they are plain slices.
``folded_conv(impl="bc")`` is not ported (it measured slower on the TPU
and is off the serving path). The SE bottleneck's folded pieces
(``fold_conv1x1_kernel``, ``folded_zero_conv``, ``folded_channel_pool``,
``folded_channel_affine``) stay plain PyTorch, as rpst leaves them to XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def fold(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C). H, W must be even."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"fold needs even H, W; got {(h, w)}")
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def unfold(x_f: torch.Tensor) -> torch.Tensor:
    """(N, H/2, W/2, 4C) -> (N, H, W, C)."""
    n, hh, ww, c4 = x_f.shape
    c = c4 // 4
    x = x_f.reshape(n, hh, ww, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, hh * 2, ww * 2, c)


@functools.lru_cache(maxsize=None)
def _fold_placement(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """P (3, 3, 4, 4, 9) of 0/1: P[fr, fc, s_in, s_out, tap] = 1 where the
    image tap (di, dj) = divmod(tap, 3) - 1 of output sub-position s_out
    reads input sub-position s_in at folded offset (fr, fc) - 1. Each of
    the 9 taps lands at 4 places (one per s_out): 36 of the 144 blocks."""
    p = np.zeros((3, 3, 4, 4, 9), np.float32)
    for oi in range(2):
        for oj in range(2):
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    fr, si = divmod(oi + di, 2)
                    fc, sj = divmod(oj + dj, 2)
                    p[fr + 1, fc + 1, 2 * si + sj, 2 * oi + oj,
                      (di + 1) * 3 + dj + 1] = 1.0
    # a normal tensor even when first asked for under inference_mode
    # (serving), since training later saves it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(p).to(device=device, dtype=dtype)


def fold_conv_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO -> (3, 3, 4Cin, 4Cout) folded-equivalent kernel.

    One contraction with the constant 0/1 placement tensor, so that inside
    autograd (training folds the live kernel every step) the fold is one
    op and its backward, which sums each tap's 4 placements, one more. Each
    folded entry is one kernel entry times 1 plus zeros: exact in float32
    (a non-finite entry, which a trained kernel never holds, would spread
    through the products with 0)."""
    kh, kw, cin, cout = kernel.shape
    if (kh, kw) != (3, 3):
        raise ValueError("the folded path supports 3x3 kernels")
    p = _fold_placement(kernel.dtype, kernel.device)
    kf = torch.einsum("abstk,kio->absito", p, kernel.reshape(9, cin, cout))
    return kf.reshape(3, 3, 4 * cin, 4 * cout)


def fold_bias(bias: torch.Tensor) -> torch.Tensor:
    """(C,) -> (4C,): each sub-position block shares the original bias."""
    return bias.repeat(4)


def _row_ring(x_f: torch.Tensor, top: bool) -> torch.Tensor:
    """The folded ring row above (top) or below x_f, (N, 1, W, 4C).

    Folded row -1 holds original rows (-2, -1) = reflected rows (2, 1):
    the sub-row-0 blocks {0, 1} (first 2C channels) of folded row 1 and the
    sub-row-1 blocks {2, 3} (last 2C) of folded row 0. The bottom ring is
    the mirror image: row H-1's first half, row H-2's second half."""
    h, half = x_f.shape[1], x_f.shape[-1] // 2
    near, far = (x_f[:, 1:2], x_f[:, 0:1]) if top else \
        (x_f[:, h - 1:h], x_f[:, h - 2:h - 1])
    return torch.cat([near[..., :half], far[..., half:]], dim=-1)


def _sub_col_select(src_even: torch.Tensor, src_odd: torch.Tensor):
    """Channel blocks {0, 2} (sub-column 0) from ``src_even``, blocks
    {1, 3} from ``src_odd``."""
    n, h, w, c4 = src_even.shape
    e = src_even.reshape(n, h, w, 2, 2, c4 // 4)
    o = src_odd.reshape(n, h, w, 2, 2, c4 // 4)
    return torch.cat([e[..., 0:1, :], o[..., 1:2, :]], dim=-2).reshape(
        n, h, w, c4)


def _col_ring(x_f: torch.Tensor, left: bool) -> torch.Tensor:
    """The folded ring column left (or right) of x_f, (N, H, 1, 4C)."""
    w = x_f.shape[2]
    if left:
        return _sub_col_select(x_f[:, :, 1:2], x_f[:, :, 0:1])
    return _sub_col_select(x_f[:, :, w - 1:w], x_f[:, :, w - 2:w - 1])


def _pad_cols_ring(x_f: torch.Tensor) -> torch.Tensor:
    return torch.cat([_col_ring(x_f, True), x_f, _col_ring(x_f, False)],
                     dim=2)


def folded_reflect_pad(x_f: torch.Tensor, rings: torch.Tensor | None = None):
    """1-original-pixel ReflectionPad2d in the folded domain: +1 folded ring
    on each side. ``rings`` (N, 2, W, 4C) overrides the two ring rows (row 0
    above, row 1 below); the ring columns are always reflect, built on the
    row-padded tensor so the corners fall out."""
    if rings is None:
        top, bottom = _row_ring(x_f, True), _row_ring(x_f, False)
    else:
        top, bottom = rings[:, 0:1], rings[:, 1:2]
    return _pad_cols_ring(torch.cat([top, x_f, bottom], dim=1))


def conv_nhwc(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VALID stride-1 conv: x (N, H, W, Ci) NHWC, k (kh, kw, Ci, Co) HWIO."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def folded_conv(x_f: torch.Tensor, folded_kernel: torch.Tensor,
                folded_bias: torch.Tensor,
                rings: torch.Tensor | None = None) -> torch.Tensor:
    """Reflect-pad + 3x3 VALID conv + bias in the folded domain (rpst's
    ``impl='ring'``): materializes the padded tensor and convolves it.
    ``rings`` overrides the ring rows, as in ``folded_reflect_pad``."""
    return conv_nhwc(folded_reflect_pad(x_f, rings), folded_kernel) \
        + folded_bias


def folded_calc_mean_std(x_f: torch.Tensor, eps: float = 1e-5):
    """Per-original-channel instance stats from the folded tensor: mean, std
    of shape (N, 1, 1, 4C), block-tiled. Unbiased variance over the original
    H*W, eps inside the sqrt, rpst's one-pass ``s2 - m*mean^2`` form. Each
    folded row is summed in float32 and the row sums in float64 (no extra
    pass over the tensor): the sums' rounding is what the CCAM softmax and
    the SE bottleneck's BatchNorm backward amplify, and one float32 sum
    over all positions moved sel_multi_adain's gradients much further from
    rpst's than rpst's own two paths sit apart (``tools/grad_noise.py``)."""
    n, hh, ww, c4 = x_f.shape
    c = c4 // 4
    m = hh * ww * 4  # original pixel count per channel
    v = x_f.float().reshape(n, hh, ww * 4, c)
    s1 = v.sum(dim=2).double().sum(dim=1)
    s2 = (v * v).sum(dim=2).double().sum(dim=1)
    mean = s1 / m
    var = ((s2 - m * mean * mean) / max(m - 1, 1)).float()
    mean = mean.float()
    std = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    mean4 = mean.repeat(1, 4)[:, None, None, :].to(x_f.dtype)
    std4 = std.repeat(1, 4)[:, None, None, :].to(x_f.dtype)
    return mean4, std4


def folded_adain(content_f: torch.Tensor, style_f: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    cm, cs = folded_calc_mean_std(content_f, eps)
    sm, ss = folded_calc_mean_std(style_f, eps)
    return (content_f - cm) / cs * ss + sm


# ---------------------------------------------------------------------------
# the SE bottleneck's pieces (rpst ``ops/folded.py:246-290``): XLA in rpst,
# so plain PyTorch here
# ---------------------------------------------------------------------------

def fold_conv1x1_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(1, 1, Cin, Cout) -> (1, 1, 4Cin, 4Cout): a 1x1 conv acts on each
    sub-position block alone, so the folded kernel is the block-diagonal
    kron(I4, W) (one differentiable op)."""
    w = kernel[0, 0]
    return torch.block_diag(w, w, w, w)[None, None]


def folded_zero_conv(x_f: torch.Tensor, folded_kernel: torch.Tensor
                     ) -> torch.Tensor:
    """A 1x1 or 3x3 conv with 1-pixel zero padding in the folded domain,
    no bias: an original-domain zero ring folds to an all-zero folded ring,
    so SAME zero padding of the folded tensor is exact."""
    pad = folded_kernel.shape[0] // 2
    y = F.conv2d(x_f.permute(0, 3, 1, 2), folded_kernel.permute(3, 2, 0, 1),
                 padding=pad)
    return y.permute(0, 2, 3, 1)


def folded_channel_pool(x_f: torch.Tensor) -> torch.Tensor:
    """The exact per-original-channel global average pool: (N, Hf, Wf, 4C)
    -> (N, C) in x_f's type (the mean accumulates in float32, as
    ``jnp.mean`` does): the 4 sub-position blocks of a channel hold equal
    pixel counts."""
    n, hh, ww, c4 = x_f.shape
    return x_f.reshape(n, hh * ww, 4, c4 // 4).float().mean(
        dim=(1, 2)).to(x_f.dtype)


def _tile_channels(v: torch.Tensor) -> torch.Tensor:
    """(C,) -> (4C,), or (N, C) -> (N, 1, 1, 4C)."""
    if v.ndim == 2:
        return v.repeat(1, 4)[:, None, None, :]
    return v.repeat(4)


def folded_channel_affine(x_f: torch.Tensor, scale: torch.Tensor,
                          shift=None) -> torch.Tensor:
    """A per-original-channel affine (scale and shift (C,) or (N, C)) on a
    folded tensor, tiled over the 4 sub-position blocks."""
    y = x_f * _tile_channels(scale)
    return y if shift is None else y + _tile_channels(shift)
