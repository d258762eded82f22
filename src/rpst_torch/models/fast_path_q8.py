"""Int8 quantized folded serving of the flagship; port of the multi_adain
part of ``rpst.models.fast_path_q8``.

Post-training quantization (PTQ) of ``stylize_multi_adain_folded``: int8
weights per output channel, int8 activations per tensor with static scales
from one calibration pass. The layers whose folded widths are multiples of
128 (``_q8_eligible``: the 128->128 layers at hidden_dim 32) run int8 on
B4 (``ops.folded_conv_q8``), or in pairs on B7 (``ops.folded_conv2_q8``)
with ``fuse_pairs``; the image layers (12->128, 128->12) stay on B1 in the
working type. AdaIN statistics and the residual fusions stay float: the
encoder's come out of B4's epilogue as channel sums (``_stats_from_sums``),
layer 0's from its int8 output (``_folded_stats_q8``).

The 128-lane gate was a TPU tiling rule in rpst, but it also decides which
layers are quantized, and so what the function computes: it is kept as is.
Scale arithmetic follows rpst: Python float64, then float32.

Usage::

    scales = calibrate_multi_adain_q8(blocks_bf16, content, style)
    img = stylize_multi_adain_folded_q8(blocks, quantize_blocks(blocks_f32),
                                        scales, content, style)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import policy
from ..ops.folded import fold, folded_adain, unfold
from ..ops.folded_conv2_q8 import fused_folded_conv2_q8
from ..ops.folded_conv_q8 import (div_f32, fused_folded_conv_q8,
                                  quantize_activations, quantize_weights)
from .fast_path import Blocks, _conv_lrelu


@dataclasses.dataclass(frozen=True)
class Q8Layer:
    """One eligible layer's int8 weights: the folded kernel quantized per
    output lane (3, 3, 4C, 4Co) int8, its (4Co,) float32 scales, and the
    folded bias in float32. The standard-layout path (B5) builds its
    layers with its kernel's repacked copy of ``w_q`` in ``w_packed``; a
    layer is not changed after it is built."""
    w_q: torch.Tensor
    w_scale: torch.Tensor
    bias: torch.Tensor
    w_packed: Optional[torch.Tensor] = None


QBlocks = List[Optional[Q8Layer]]


def _q8_eligible(k) -> bool:
    return k.shape[2] % 128 == 0 and k.shape[3] % 128 == 0


def quantize_blocks(blocks: Tuple[Blocks, Blocks]
                    ) -> Tuple[QBlocks, QBlocks]:
    """(encoder, decoder) lists of ``Q8Layer`` for the eligible layers and
    None for the others, from the float32 folded weights (rpst quantizes
    ``k.astype(float32)`` of the folded kernel)."""
    def stack(layers):
        out = []
        for k, b in layers:
            if not _q8_eligible(k):
                out.append(None)
                continue
            w_q, w_scale = quantize_weights(k.float())
            out.append(Q8Layer(w_q.contiguous(), w_scale, b.float()))
        return out
    return stack(blocks[0]), stack(blocks[1])


def q8_plan(enc_kernels, dec_kernels, fuse_pairs: bool) -> Dict[str, int]:
    """What one stylize call runs, derived from the layers' eligibility as
    ``_encode_q8`` and the decoder walk below decide it: the act scales it
    consumes ("scales") and its B1, B4 and B7 launches on CUDA."""
    elig = [_q8_eligible(k) for k in enc_kernels]
    plan = {"scales": 0, "B1": 0, "B4": 0, "B7": 0}
    for _ in range(2):  # content and style encodes
        li = 0
        while li < len(elig):
            if fuse_pairs and elig[li] and li + 1 < len(elig) \
                    and elig[li + 1]:
                plan["B7"] += 1
                plan["scales"] += 2
                li += 2
                continue
            if elig[li]:
                plan["B4"] += 1
                plan["scales"] += 1
            else:
                plan["B1"] += 1
                if li + 1 < len(elig) and elig[li + 1]:
                    plan["scales"] += 1
            li += 1
    for k in dec_kernels:
        e = _q8_eligible(k)
        plan["B4" if e else "B1"] += 1
        plan["scales"] += int(e)
    return plan


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _forward_collect(blocks, content, style):
    """The folded forward in the blocks' type (bfloat16 for calibration),
    recording the observables in exactly the order
    ``stylize_multi_adain_folded_q8`` consumes scales: per encode, the
    output absmax of each layer whose output is quantized (the chained int8
    out/in scales); then the absmax of every quantized decoder input.
    Returns (image, list of 0-dim float32 absmax tensors)."""
    enc, dec = blocks
    dtype = enc[0][0].dtype
    absmax: List[torch.Tensor] = []

    def encode(img):
        x = fold(img.to(dtype))
        feats = []
        for li, (k, b) in enumerate(enc):
            x = _conv_lrelu(x, k, b)
            nxt_eligible = li + 1 < len(enc) and _q8_eligible(enc[li + 1][0])
            if nxt_eligible or (li == len(enc) - 1 and _q8_eligible(k)):
                absmax.append(x.float().abs().amax())
            feats.append(x)
        return feats

    c_feats = encode(content)
    s_feats = encode(style)
    stylized = folded_adain(c_feats[-1], s_feats[-1])
    k, b = dec[0]
    if _q8_eligible(k):
        absmax.append(stylized.float().abs().amax())
    stylized = _conv_lrelu(stylized, k, b)
    pairs = list(zip(c_feats[:-1], s_feats[:-1]))[::-1]
    for i, (cf, sf) in enumerate(pairs):
        k, b = dec[i + 1]
        x_in = stylized + folded_adain(cf, sf)
        if _q8_eligible(k):
            absmax.append(x_in.float().abs().amax())
        stylized = _conv_lrelu(x_in, k, b)
    return unfold(stylized).to(content.dtype), absmax


def calibrate_multi_adain_q8(blocks, content, style) -> Dict[str, np.ndarray]:
    """One calibration pass -> {'act_scales': (L,) float32}, per-tensor
    symmetric scales absmax / 127 (at least 1e-6 / 127), computed in Python
    float64 as rpst does. ``blocks`` are the bfloat16 folded weights (rpst
    calibrates its bf16 forward); feed representative batches."""
    with torch.inference_mode():
        _, absmax = _forward_collect(blocks, content, style)
        values = torch.stack(absmax).cpu().tolist()  # one device sync
    return {"act_scales": np.asarray([max(float(a), 1e-6) / 127.0
                                      for a in values], np.float32)}


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def _tile4(v):
    return v.repeat(1, 4)[:, None, None, :]


def _folded_stats_q8(q, scale: float, eps: float = 1e-5):
    """folded_calc_mean_std of an int8 tensor with a per-tensor scale: the
    statistics are linear in the scale, so they reduce over the int8 values
    and rescale once. The integer sums are exact (int64), then float32."""
    n, hh, ww, c4 = q.shape
    c = c4 // 4
    m = hh * ww * 4
    v = q.to(torch.int32).reshape(n, hh * ww, 4, c)
    s1 = v.sum(dim=(1, 2)).float()
    s2 = (v * v).sum(dim=(1, 2)).float()
    mean = div_f32(s1, float(m)) * scale
    var = (div_f32(s2, float(max(m - 1, 1)))
           - div_f32(s1 * s1, float(m) * float(max(m - 1, 1)))) \
        * scale * scale
    std = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    return _tile4(mean), _tile4(std)


def _stats_from_sums(s1, s2, m: int, eps: float = 1e-5):
    """(mean4, std4) from a kernel's fused per-image channel sums (s1, s2:
    (N, 4C) float32 over the folded lanes): combine the 4 sub-position
    blocks of each channel, unbiased variance over the m original pixels."""
    n, c4 = s1.shape
    c = c4 // 4
    s1c = s1.reshape(n, 4, c).sum(dim=1)
    s2c = s2.reshape(n, 4, c).sum(dim=1)
    mean = div_f32(s1c, float(m))
    var = div_f32(s2c - div_f32(s1c * s1c, float(m)), float(max(m - 1, 1)))
    std = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    return _tile4(mean), _tile4(std)


def _adain_affine_q8(c_feat, s_feat, c_stats=None, s_stats=None):
    """AdaIN between (int8, scale) feature pairs -> float32 fusion tensor;
    ``c_stats``/``s_stats`` are (mean4, std4) from the kernel sums, or None
    to reduce the int8 features."""
    (cq, cs), (sq, ss) = c_feat, s_feat
    cm, cstd = c_stats if c_stats is not None else _folded_stats_q8(cq, cs)
    sm, sstd = s_stats if s_stats is not None else _folded_stats_q8(sq, ss)
    return (cq.float() * cs - cm) / cstd * sstd + sm


# ---------------------------------------------------------------------------
# the int8 layers
# ---------------------------------------------------------------------------

def _scale_rows(x_scale: float, layer: Q8Layer, out_scale=None):
    """(3, 4Co) float32 [x_scale * w_scale, bias, 1 / out_scale]; row 2 is
    zeros for a bf16 output."""
    deq = x_scale * layer.w_scale
    inv = (torch.zeros_like(deq) if out_scale is None
           else torch.full_like(deq, 1.0 / out_scale))
    return torch.stack([deq, layer.bias, inv])


def _conv_q(x_q, x_scale: float, layer: Q8Layer, out_scale=None,
            want_stats: bool = False):
    """One eligible layer on B4: int8 out with ``out_scale``, bf16 out
    without (the caller casts it)."""
    return fused_folded_conv_q8(x_q, layer.w_q,
                                _scale_rows(x_scale, layer, out_scale),
                                out_int8=out_scale is not None,
                                with_stats=want_stats)


def _conv2_q(x_q, x_scale: float, l1: Q8Layer, out1: float, l2: Q8Layer,
             out2: float):
    """An eligible layer pair on B7: both outputs int8, with both layers'
    stat sums."""
    return fused_folded_conv2_q8(x_q, l1.w_q, _scale_rows(x_scale, l1, out1),
                                 l2.w_q, _scale_rows(out1, l2, out2),
                                 out_int8=True, with_stats=True)


def _encode_q8(enc: Blocks, enc_q: QBlocks, act_scales, it, img, dtype,
               fuse_pairs: bool):
    """The chained int8 constant-stack encoder (rpst's ``_encode_q8`` with
    ``fuse_stats``): feats are (int8, scale) pairs, stats the per-layer
    (mean4, std4) from the kernel epilogues (None for layers on B1). With
    ``fuse_pairs`` consecutive eligible layers run as one B7 launch, in the
    same scale order (bit-equal to the unfused chain)."""
    x = fold(img.to(dtype))
    feats, stats = [], []
    li = 0
    while li < len(enc):
        k, b = enc[li]
        if (fuse_pairs and enc_q[li] is not None and li + 1 < len(enc)
                and enc_q[li + 1] is not None and isinstance(x, tuple)
                and x[1] is not None):
            x_q, x_scale = x
            out1 = float(act_scales[next(it)])
            out2 = float(act_scales[next(it)])
            y1, y2, s11, s12, s21, s22 = _conv2_q(x_q, x_scale, enc_q[li],
                                                  out1, enc_q[li + 1], out2)
            # the sums are of float32 post-activation values in real units
            m = y1.shape[1] * y1.shape[2] * 4
            feats += [(y1, out1), (y2, out2)]
            stats += [_stats_from_sums(s11, s12, m),
                      _stats_from_sums(s21, s22, m)]
            x = (y2, out2)
            li += 2
            continue
        st = None
        if enc_q[li] is None:
            if isinstance(x, tuple):
                # the previous layer left (tensor, scale or None): dequantize
                # (or unwrap) before the float conv
                q, s = x
                x = (q.float() * s).to(dtype) if s is not None else q
            x = _conv_lrelu(x, k, b)
            if li + 1 < len(enc) and enc_q[li + 1] is not None:
                s = float(act_scales[next(it)])
                x = (quantize_activations(x, s), s)
            else:
                x = (x, None)
        else:
            x_q, x_scale = x
            out_s = float(act_scales[next(it)])
            y, s1, s2 = _conv_q(x_q, x_scale, enc_q[li], out_s,
                                want_stats=True)
            st = _stats_from_sums(s1, s2, y.shape[1] * y.shape[2] * 4)
            x = (y, out_s)
        feats.append(x)
        stats.append(st)
        li += 1
    return feats, stats


def stylize_multi_adain_folded_q8(blocks: Tuple[Blocks, Blocks],
                                  qblocks: Tuple[QBlocks, QBlocks], scales,
                                  content, style, dtype=torch.bfloat16,
                                  fuse_pairs="auto") -> torch.Tensor:
    """Quantized folded stylize. ``blocks``: the folded weights in
    ``dtype`` (``fast_path.folded_blocks``), which the B1 layers use;
    ``qblocks``: ``quantize_blocks`` of the float32 folded weights;
    ``scales`` from ``calibrate_multi_adain_q8``. content, style (N, H, W,
    3) NHWC, even H and W.

    The encoder chains int8 -> int8 (requantization in B4's epilogue, AdaIN
    statistics from its sums); the decoder's int8 layers output bfloat16,
    cast to ``dtype``. ``fuse_pairs`` runs consecutive eligible encoder
    layers as one B7 launch (bit-equal); "auto" takes
    ``policy.FUSE_PAIRS``, the H100 A/B's winner."""
    enc, dec = blocks
    enc_q, dec_q = qblocks
    if fuse_pairs == "auto":
        fuse_pairs = policy.FUSE_PAIRS
    act_scales = np.asarray(scales["act_scales"], np.float32)
    want = q8_plan([k for k, _ in enc], [k for k, _ in dec],
                   bool(fuse_pairs))["scales"]
    if len(act_scales) != want:
        raise ValueError(f"{len(act_scales)} act scales for a stack that "
                         f"consumes {want}: calibrate this model's weights")
    it = iter(range(len(act_scales)))

    c_feats, c_stats = _encode_q8(enc, enc_q, act_scales, it, content, dtype,
                                  fuse_pairs)
    s_feats, s_stats = _encode_q8(enc, enc_q, act_scales, it, style, dtype,
                                  fuse_pairs)

    stylized = _adain_affine_q8(c_feats[-1], s_feats[-1], c_stats[-1],
                                s_stats[-1]).to(dtype)
    s_in = float(act_scales[next(it)])
    stylized = _conv_q(quantize_activations(stylized, s_in), s_in,
                       dec_q[0]).to(dtype)
    pairs = list(zip(c_feats[:-1], s_feats[:-1], c_stats[:-1],
                     s_stats[:-1]))[::-1]
    for i, (cf, sf, cst, sst) in enumerate(pairs):
        fusion = _adain_affine_q8(cf, sf, cst, sst).to(dtype)
        k, b = dec[i + 1]
        if dec_q[i + 1] is not None:
            s_in = float(act_scales[next(it)])
            x = stylized.float() + fusion.float()
            stylized = _conv_q(quantize_activations(x, s_in), s_in,
                               dec_q[i + 1]).to(dtype)
        else:
            stylized = _conv_lrelu(stylized + fusion, k, b)
    return unfold(stylized).to(content.dtype)
