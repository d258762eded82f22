"""B4: the int8 fused folded conv of the quantized serving path; port of
``rpst.ops.pallas.folded_conv_q8``.

  * ``quantize_weights`` / ``quantize_activations``: symmetric int8, weights
    per output channel, activations per tensor (rpst's PTQ recipe);
  * ``fused_folded_conv_q8``: lrelu_0.2(conv3x3(folded_reflect_pad(x_q)) *
    (x_scale * w_scale) + bias) on the folded layout, int8 x int8 summed in
    int32, an f32 epilogue, int8 (requantized) or bfloat16 out, and with
    ``with_stats`` the f32 per-image channel sums of the post-activation
    values that feed AdaIN (CUDA ``csrc/folded_conv_q8.cu``: B1's
    tensor-core main loop, ``csrc/folded_mma.cuh``, with int8 operands;
    each launch packs ``w_q`` and lists its non-zero blocks on the device,
    as B1's do, so a quantized fold of an image kernel costs its 36 of 144
    blocks).

A CUDA tensor reaches the kernel or raises; a CPU tensor takes
``fused_folded_conv_q8_plain``, the same function in plain PyTorch, which
the CPU tests hold against rpst's kernel in interpret mode.
``fused_folded_conv_q8.launches`` counts kernel launches and nothing else.
rpst's Mosaic knobs (``block_rows``, ``wide_k``, ``dma_depth``,
``ring_dma``, the timing stubs, ``interpret``) have no counterpart here.
"""

from __future__ import annotations

import torch

from .folded import conv_nhwc, folded_reflect_pad
from .folded_conv import _count, _scratch


def div_f32(t: torch.Tensor, v: float) -> torch.Tensor:
    """t / float32(v) as a true division on every device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead, which
    can move the last bit and with it a requantization boundary."""
    return t / torch.full((), v, dtype=torch.float32, device=t.device)


def quantize_weights(w: torch.Tensor):
    """(..., Cout) float32 -> (int8 weights, (Cout,) float32 scales):
    absmax per output channel / 127, round half to even, clip to +-127."""
    absmax = w.reshape(-1, w.shape[-1]).abs().amax(dim=0)
    scale = div_f32(torch.clamp(absmax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_activations(x: torch.Tensor, scale: float) -> torch.Tensor:
    """float -> int8 with one per-tensor scale (a Python float, applied in
    float32 as rpst does), round half to even, clip to +-127."""
    q = torch.clamp(torch.round(div_f32(x.float(), scale)), -127, 127)
    return q.to(torch.int8)


def fused_folded_conv_q8_plain(x_q, w_q, scales, out_int8: bool,
                               with_stats: bool = False):
    """B4 in plain PyTorch. The int8 ring is padded as values and the conv
    runs in float64, where every partial sum (at most 9 * 4C * 127^2) is an
    exact integer, as the kernel's int32 sum is; the epilogue is the
    kernel's float32 arithmetic: two roundings (no fused multiply-add),
    lrelu 0.2, round half to even."""
    acc = conv_nhwc(folded_reflect_pad(x_q.to(torch.float64)),
                    w_q.to(torch.float64))
    y = acc.float() * scales[0] + scales[1]
    y = torch.where(y >= 0, y, 0.2 * y)
    out = (torch.clamp(torch.round(y * scales[2]), -127, 127).to(torch.int8)
           if out_int8 else y.to(torch.bfloat16))
    if with_stats:
        return out, y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2))
    return out


def check_q8_input(name, x_q):
    if x_q.ndim != 4 or x_q.shape[1] < 2 or x_q.shape[2] < 2:
        raise ValueError(f"{name}: expected x_q (N, Hf, Wf, 4C) with Hf, Wf "
                         f">= 2, got {tuple(x_q.shape)}")
    if x_q.shape[3] % 16:
        raise ValueError(f"{name}: 4C must be a multiple of 16 (int8 words "
                         f"of one folded channel block), got {x_q.shape[3]}")


def check_q8_layer(name, c4, w_q, scales):
    """The (w_q, scales) pair of one layer reading c4 channels; returns 4Co."""
    if w_q.ndim != 4 or tuple(w_q.shape[:3]) != (3, 3, c4) \
            or w_q.shape[3] % 4:
        raise ValueError(f"{name}: w_q must be (3, 3, {c4}, 4Co) with 4Co a "
                         f"multiple of 4, got {tuple(w_q.shape)}")
    c4o = w_q.shape[3]
    if tuple(scales.shape) != (3, c4o):
        raise ValueError(f"{name}: scales must be (3, {c4o}) rows [x_scale * "
                         f"w_scale, bias, 1 / out_scale], got "
                         f"{tuple(scales.shape)}")
    return c4o


def check_q8_tensors(name, tensors, device):
    """Device, type and layout of every (name, tensor, dtype); the kernels
    read 16-byte words, so CUDA tensors must start 16-byte aligned."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {device}")
    for tname, t, dtype in tensors:
        if t.device != device:
            raise ValueError(f"{tname} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{tname} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
        if device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{tname} must start 16-byte aligned")


def stats_scratch(lib, tiles_fn, n, h, w, floats_per_tile, device):
    """The kernel's per-tile partial sums: (N * tiles * floats_per_tile,)
    float32, tiles as the kernel cuts (H, W)."""
    from ..kernels.build import load
    tiles = getattr(load(lib), tiles_fn)(h, w)
    return torch.empty(n * tiles * floats_per_tile, dtype=torch.float32,
                       device=device)


def fused_folded_conv_q8(x_q, w_q, scales, out_int8: bool,
                         with_stats: bool = False):
    """Quantized lrelu(folded_reflect_conv(x) + bias).

    x_q (N, Hf, Wf, 4C) int8, 4C a multiple of 16; w_q (3, 3, 4C, 4Co)
    int8, 4Co a multiple of 4; scales (3, 4Co) float32 rows [x_scale *
    w_scale, bias, 1 / out_scale] (row 2 unused when ``out_int8`` is
    False); all contiguous on one device. Returns int8 (requantized with
    row 2) or bfloat16, (N, Hf, Wf, 4Co); with ``with_stats`` returns
    ``(out, s1, s2)``, the (N, 4Co) float32 per-image sums of the
    post-activation values and of their squares, before requantization."""
    name = "fused_folded_conv_q8"
    check_q8_input(name, x_q)
    c4o = check_q8_layer(name, x_q.shape[3], w_q, scales)
    check_q8_tensors(name, (("x_q", x_q, torch.int8),
                            ("w_q", w_q, torch.int8),
                            ("scales", scales, torch.float32)), x_q.device)
    if x_q.device.type == "cpu":
        return fused_folded_conv_q8_plain(x_q, w_q, scales, out_int8,
                                          with_stats)
    n, h, w, c4 = x_q.shape
    dev = x_q.device
    y = torch.empty((n, h, w, c4o), device=dev,
                    dtype=torch.int8 if out_int8 else torch.bfloat16)
    s1 = s2 = part = None
    if with_stats:
        s1 = torch.empty((n, c4o), dtype=torch.float32, device=dev)
        s2 = torch.empty_like(s1)
        part = stats_scratch("folded_conv_q8", "rpst_folded_conv_q8_tiles",
                             n, h, w, 2 * c4o, dev)
    from ..kernels.build import launch
    launch("folded_conv_q8", "rpst_folded_conv_q8", "B4", x_q, w_q,
           *_scratch(w_q), scales, y, s1, s2, part, n, h, w, c4, c4o,
           int(out_int8), int(with_stats))
    _count(fused_folded_conv_q8)
    return (y, s1, s2) if with_stats else y


fused_folded_conv_q8.launches = 0
