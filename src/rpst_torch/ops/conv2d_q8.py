"""B5: the standard-layout 3x3 conv of the wide-channel paths, int8 and
bf16; port of ``rpst.ops.pallas.conv2d_q8``.

  * ``fused_conv2d_q8``: act_alpha(conv3x3(pad(x_q)) * (x_scale * w_scale) +
    bias) on the plain (unfolded) layout, int8 x int8 summed in int32, an
    f32 epilogue, int8 (requantized by a stored reciprocal) or bfloat16 out;
  * ``fused_conv2d_bf16``: the same conv on bfloat16 operands with a float32
    sum (no path of rpst or of the port calls it; rpst keeps it as a
    verified utility, and so does the port).

Both run ``csrc/conv2d_q8.cu`` on CUDA tensors: an implicit GEMM on the
int8 (bfloat16) tensor cores. The kernel reads its weights K-major in
32-byte steps (``pack_conv2d_weights``); the public functions take HWIO and
repack per call unless the caller hands in the packed copy it keeps
(``w_packed``, as ``models.fast_path_q8_std`` does per layer).

``pad_mode`` is "reflect" (one pixel: row -1 = row 1, row H = row H-2, the
same for columns) or "zero"; ``alpha`` is the leaky slope (0.0 = relu, 1.0
= no activation, 0.2 = the Conv2dBlock lrelu), computed as ``where(y >= 0,
y, alpha * y)``, so alpha = 0 leaves -0.0 for a negative y in the bfloat16
output, as rpst does.

Layout: activations are NHWC, ``(N, H, W, C)`` contiguous (a channels-last
image), weights HWIO ``(3, 3, C, Co)``, as in rpst, so the tests compare
like with like and a chain of int8 layers never transposes.

A CUDA tensor reaches the kernel or raises; a CPU tensor takes the
``*_plain`` version, the same function in plain PyTorch, which the CPU
tests hold against rpst's kernel in interpret mode and against a numpy
int64 oracle. ``<wrapper>.launches`` counts kernel launches and nothing
else. rpst's Mosaic knobs (``block_rows``, ``wide_k``, the slab double
buffer, the ``rings`` operand, ``interpret``) are how the TPU kernel is
built, not what it computes, and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .folded_conv import _count, pack_k_major
from .folded_conv_q8 import check_q8_tensors

_PAD = {"reflect": "reflect", "zero": "constant"}


def _pad_conv(x: torch.Tensor, w: torch.Tensor, pad_mode: str):
    """conv3x3(pad(x)) for NHWC x and HWIO w in their own float type."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=_PAD[pad_mode])
    return F.conv2d(xp, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def _act(y: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(y >= 0, y, alpha * y)


def fused_conv2d_q8_plain(x_q, w_q, scales, out_int8: bool,
                          alpha: float = 0.2, pad_mode: str = "reflect"):
    """B5 in plain PyTorch. The padded int8 values are convolved in float64,
    where every partial sum (at most 9 * C * 127^2) is an exact integer, as
    the kernel's int32 sum is; the epilogue is the kernel's float32
    arithmetic: two roundings (no fused multiply-add), ``alpha * y`` for a
    negative y, a multiply by the stored reciprocal, round half to even."""
    acc = _pad_conv(x_q.to(torch.float64), w_q.to(torch.float64), pad_mode)
    y = _act(acc.float() * scales[0] + scales[1], alpha)
    if out_int8:
        return torch.clamp(torch.round(y * scales[2]), -127, 127).to(
            torch.int8)
    return y.to(torch.bfloat16)


def fused_conv2d_bf16_plain(x, w, b, alpha: float = 0.0,
                            pad_mode: str = "reflect"):
    """B5' in plain PyTorch: the operands rounded to bfloat16, the conv and
    the bias add in float32, the result rounded to bfloat16."""
    y = _pad_conv(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(),
                  pad_mode) + b.float()
    return _act(y, alpha).to(torch.bfloat16)


def pack_conv2d_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C, Co) int8 or bfloat16 weights in the CUDA kernel's
    order: (3, 3, ceil(C / KE), Co, KE) contiguous, KE = 32 int8 or 16
    bfloat16 input channels (32 bytes, one k-step of the kernel's ``mma``),
    zeros past C. ``packed[dr, dc, s, co, e] = w[dr, dc, s * KE + e, co]``."""
    if w.ndim != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"pack_conv2d_weights: expected (3, 3, C, Co) int8 "
                         f"or bfloat16, got {tuple(w.shape)} {w.dtype}")
    return pack_k_major(w)


def _packed(name, w, w_packed):
    if w_packed is None:
        return pack_conv2d_weights(w)
    ke = 32 // w.element_size()
    want = (3, 3, -(-w.shape[2] // ke), w.shape[3], ke)
    if tuple(w_packed.shape) != want or w_packed.dtype != w.dtype \
            or w_packed.device != w.device or not w_packed.is_contiguous():
        raise ValueError(f"{name}: w_packed must be pack_conv2d_weights(w): "
                         f"{want} {w.dtype} contiguous on {w.device}, got "
                         f"{tuple(w_packed.shape)} {w_packed.dtype} on "
                         f"{w_packed.device}")
    return w_packed


def _check_layer(name, x, w, pad_mode, unit):
    if pad_mode not in _PAD:
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    if x.ndim != 4 or x.shape[1] < 2 or x.shape[2] < 2:
        raise ValueError(f"{name}: expected x (N, H, W, C) with H, W >= 2, "
                         f"got {tuple(x.shape)}")
    c = x.shape[3]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"{name}: w must be (3, 3, {c}, Co), got "
                         f"{tuple(w.shape)}")
    if c % unit or w.shape[3] % unit:
        raise ValueError(f"{name}: C and Co must be multiples of {unit} (the "
                         f"kernel's packed reads), got {c} -> {w.shape[3]}")
    return w.shape[3]


def fused_conv2d_q8(x_q, w_q, scales, out_int8: bool, alpha: float = 0.2,
                    pad_mode: str = "reflect", w_packed=None):
    """Quantized act_alpha(conv3x3(pad(x)) + bias) in the standard layout.

    x_q (N, H, W, C) int8, NHWC contiguous; w_q (3, 3, C, Co) int8, HWIO;
    scales (3, Co) float32 rows [x_scale * w_scale, bias, 1 / out_scale]
    (row 2 unused when ``out_int8`` is False); C and Co multiples of 4, H
    and W at least 2, all on one device; ``w_packed`` is
    ``pack_conv2d_weights(w_q)`` where the caller keeps it (the CUDA kernel
    reads that copy; without it the call repacks). Returns (N, H, W, Co)
    int8 (requantized with row 2) or bfloat16."""
    name = "fused_conv2d_q8"
    co = _check_layer(name, x_q, w_q, pad_mode, 4)
    if tuple(scales.shape) != (3, co):
        raise ValueError(f"{name}: scales must be (3, {co}) rows [x_scale * "
                         f"w_scale, bias, 1 / out_scale], got "
                         f"{tuple(scales.shape)}")
    check_q8_tensors(name, (("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
                            ("scales", scales, torch.float32)), x_q.device)
    if x_q.device.type == "cpu":
        return fused_conv2d_q8_plain(x_q, w_q, scales, out_int8, alpha,
                                     pad_mode)
    n, h, w, c = x_q.shape
    y = torch.empty((n, h, w, co), device=x_q.device,
                    dtype=torch.int8 if out_int8 else torch.bfloat16)
    from ..kernels.build import launch
    launch("conv2d_q8", "rpst_conv2d_q8", "B5", x_q,
           _packed(name, w_q, w_packed), scales, y, n, h, w, c, co,
           int(out_int8), int(pad_mode == "reflect"), float(alpha))
    _count(fused_conv2d_q8)
    return y


fused_conv2d_q8.launches = 0


def fused_conv2d_bf16(x, w, b, alpha: float = 0.0, pad_mode: str = "reflect"):
    """bfloat16 act_alpha(conv3x3(pad(x)) + bias), float32 accumulate.

    x (N, H, W, C) NHWC and w (3, 3, C, Co) HWIO of any float type (cast to
    bfloat16, as rpst casts them), b (Co,) (cast to float32); C and Co
    multiples of 8, H and W at least 2. Returns (N, H, W, Co) bfloat16."""
    name = "fused_conv2d_bf16"
    x, w, b = x.to(torch.bfloat16), w.to(torch.bfloat16), b.float()
    co = _check_layer(name, x, w, pad_mode, 8)
    if tuple(b.shape) != (co,):
        raise ValueError(f"{name}: b must be ({co},), got {tuple(b.shape)}")
    check_q8_tensors(name, (("x", x, torch.bfloat16), ("w", w, torch.bfloat16),
                            ("b", b, torch.float32)), x.device)
    if x.device.type == "cpu":
        return fused_conv2d_bf16_plain(x, w, b, alpha, pad_mode)
    n, h, wd, c = x.shape
    y = torch.empty((n, h, wd, co), device=x.device, dtype=torch.bfloat16)
    from ..kernels.build import launch
    launch("conv2d_q8", "rpst_conv2d_bf16", "B5 (bf16)", x,
           pack_conv2d_weights(w), b, y, n, h, wd, c, co,
           int(pad_mode == "reflect"), float(alpha))
    _count(fused_conv2d_bf16)
    return y


fused_conv2d_bf16.launches = 0
