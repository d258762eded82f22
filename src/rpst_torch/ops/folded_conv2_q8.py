"""B7: two chained int8 folded conv layers in one kernel; port of
``rpst.ops.pallas.folded_conv2_q8``.

``fused_folded_conv2_q8`` computes B4 twice, layer 2 reading layer 1's
requantized int8 output, without the round trip of that output through
device memory (CUDA ``csrc/folded_conv2_q8.cu``). Its documented contract
(rpst's module docstring) is bit-equality with two
``fused_folded_conv_q8`` calls, and that is exactly its plain version.

A CUDA tensor reaches the kernel or raises; a CPU tensor takes the plain
version. ``fused_folded_conv2_q8.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .folded_conv import _count
from .folded_conv_q8 import (check_q8_input, check_q8_layer,
                             check_q8_tensors, fused_folded_conv_q8_plain,
                             stats_scratch)

# the kernel keeps one layer's whole weight set and every channel of a
# position in its block: 4C, 4Cm, 4Co at most 128 (the flagship's widths)
MAX_CHANNELS = 128


def fused_folded_conv2_q8_plain(x_q, w1_q, scales1, w2_q, scales2,
                                out_int8: bool = True,
                                with_stats: bool = False):
    """B7 in plain PyTorch: two chained ``fused_folded_conv_q8_plain``
    calls, the function rpst's kernel is documented to equal."""
    if with_stats:
        y1, s11, s12 = fused_folded_conv_q8_plain(x_q, w1_q, scales1, True,
                                                  True)
        y2, s21, s22 = fused_folded_conv_q8_plain(y1, w2_q, scales2,
                                                  out_int8, True)
        return y1, y2, s11, s12, s21, s22
    y1 = fused_folded_conv_q8_plain(x_q, w1_q, scales1, True)
    return y1, fused_folded_conv_q8_plain(y1, w2_q, scales2, out_int8)


def fused_folded_conv2_q8(x_q, w1_q, scales1, w2_q, scales2,
                          out_int8: bool = True, with_stats: bool = False):
    """Chained lrelu(conv(requant(lrelu(conv(x))))) with int8 between the
    layers.

    x_q (N, Hf, Wf, 4C) int8; w1_q (3, 3, 4C, 4Cm), w2_q (3, 3, 4Cm, 4Co)
    int8; scales1 (3, 4Cm) / scales2 (3, 4Co) float32 rows [x_scale *
    w_scale, bias, 1 / out_scale] (scales1's row 2 is required: layer 2
    reads the requantized rows; scales2's is unused without ``out_int8``).
    4C and 4Cm are multiples of 16, 4Co of 4, each at most 128. Returns
    ``(y1_q, y2)`` (y2 int8 or bfloat16), or with ``with_stats`` ``(y1_q,
    y2, s11, s12, s21, s22)``: each layer's (N, channels) float32 sums of
    the post-activation values and their squares."""
    name = "fused_folded_conv2_q8"
    check_q8_input(name, x_q)
    c4m = check_q8_layer(name, x_q.shape[3], w1_q, scales1)
    if c4m % 16:
        raise ValueError(f"{name}: 4Cm must be a multiple of 16, got {c4m}")
    c4o = check_q8_layer(name, c4m, w2_q, scales2)
    if max(x_q.shape[3], c4m, c4o) > MAX_CHANNELS:
        raise ValueError(f"{name}: 4C, 4Cm, 4Co must be at most "
                         f"{MAX_CHANNELS}, got {x_q.shape[3]}, {c4m}, {c4o}")
    check_q8_tensors(name, (("x_q", x_q, torch.int8),
                            ("w1_q", w1_q, torch.int8),
                            ("scales1", scales1, torch.float32),
                            ("w2_q", w2_q, torch.int8),
                            ("scales2", scales2, torch.float32)), x_q.device)
    if x_q.device.type == "cpu":
        return fused_folded_conv2_q8_plain(x_q, w1_q, scales1, w2_q, scales2,
                                           out_int8, with_stats)
    n, h, w, c4 = x_q.shape
    dev = x_q.device
    y1 = torch.empty((n, h, w, c4m), dtype=torch.int8, device=dev)
    y2 = torch.empty((n, h, w, c4o), device=dev,
                     dtype=torch.int8 if out_int8 else torch.bfloat16)
    stats, part = [None] * 4, None
    if with_stats:
        f32 = dict(dtype=torch.float32, device=dev)
        stats = [torch.empty((n, c), **f32) for c in (c4m, c4m, c4o, c4o)]
        part = stats_scratch("folded_conv2_q8", "rpst_folded_conv2_q8_tiles",
                             n, h, w, 2 * c4m + 2 * c4o, dev)
    from ..kernels.build import launch
    launch("folded_conv2_q8", "rpst_folded_conv2_q8", "B7", x_q, w1_q,
           scales1, w2_q, scales2, y1, y2, *stats, part, n, h, w, c4, c4m,
           c4o, int(out_int8), int(with_stats))
    _count(fused_folded_conv2_q8)
    return (y1, y2, *stats) if with_stats else (y1, y2)


fused_folded_conv2_q8.launches = 0
