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
from ..ops.folded import fold, folded_adain, folded_calc_mean_std, unfold
from ..ops.folded_conv2_q8 import fused_folded_conv2_q8
from ..ops.folded_conv_q8 import (div_f32, fused_folded_conv_q8,
                                  quantize_activations, quantize_weights)
from ..ops.mst import mst_transfer_batch
from .fast_path import (Blocks, _block_eye4, _ccam_attention, _conv_lrelu,
                        _folded_se_bottleneck)


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

def _encode_collect(enc: Blocks, img, dtype, absmax: List[torch.Tensor]):
    """The float folded encoder of a calibration pass, recording the output
    absmax of each layer whose output the int8 chain quantizes (the next
    layer is eligible, or it is the last layer and eligible itself)."""
    x = fold(img.to(dtype))
    feats = []
    for li, (k, b) in enumerate(enc):
        x = _conv_lrelu(x, k, b)
        nxt_eligible = li + 1 < len(enc) and _q8_eligible(enc[li + 1][0])
        if nxt_eligible or (li == len(enc) - 1 and _q8_eligible(k)):
            absmax.append(x.float().abs().amax())
        feats.append(x)
    return feats


def _scales_of(absmax: List[torch.Tensor]) -> Dict[str, np.ndarray]:
    """{'act_scales'}: absmax / 127 (at least 1e-6 / 127) in Python float64,
    then float32, as rpst computes them (one device sync)."""
    values = torch.stack(absmax).cpu().tolist()
    return {"act_scales": np.asarray([max(float(a), 1e-6) / 127.0
                                      for a in values], np.float32)}


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
    c_feats = _encode_collect(enc, content, dtype, absmax)
    s_feats = _encode_collect(enc, style, dtype, absmax)
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
        return _scales_of(_forward_collect(blocks, content, style)[1])


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def _tile4(v):
    return v.repeat(1, 4)[:, None, None, :]


def _folded_stats_q8(q, scale: float, eps: float = 1e-5):
    """folded_calc_mean_std of an int8 tensor with a per-tensor scale: the
    statistics are linear in the scale, so they reduce over the int8 values
    and rescale once. The integer sums are exact (int64), then float32. A
    float tensor (the calibration passes' exact features, scale 1) sums in
    float32, as rpst's does."""
    n, hh, ww, c4 = q.shape
    c = c4 // 4
    m = hh * ww * 4
    if q.dtype.is_floating_point:
        v = q.float().reshape(n, hh * ww, 4, c)
        s1, s2 = v.sum(dim=(1, 2)), (v * v).sum(dim=(1, 2))
    else:
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
               fuse_pairs: bool = False, fuse_stats: bool = True):
    """The chained int8 constant-stack encoder (rpst's ``_encode_q8``):
    feats are (int8, scale) pairs, and with ``fuse_stats`` stats the
    per-layer (mean4, std4) from the kernel epilogues (None for layers on
    B1; every entry None without). With ``fuse_pairs`` consecutive eligible
    layers run as one B7 launch, in the same scale order (bit-equal to the
    unfused chain)."""
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
            if fuse_stats:
                y, s1, s2 = _conv_q(x_q, x_scale, enc_q[li], out_s,
                                    want_stats=True)
                st = _stats_from_sums(s1, s2, y.shape[1] * y.shape[2] * 4)
            else:
                y = _conv_q(x_q, x_scale, enc_q[li], out_s)
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


def _check_scales(act_scales, blocks: Tuple[Blocks, Blocks]) -> None:
    want = q8_plan([k for k, _ in blocks[0]], [k for k, _ in blocks[1]],
                   False)["scales"]
    if len(act_scales) != want:
        raise ValueError(f"{len(act_scales)} act scales for a stack that "
                         f"consumes {want}: calibrate this model's weights")


def _dec_conv_q8(x, k, b, layer: Optional[Q8Layer], dtype, act_scales, it,
                 collect: Optional[list], want_stats: bool = False):
    """One decoder conv of the three variants' int8 paths -> (out in
    ``dtype``, (mean4, std4) from B4's sums or None). An eligible layer
    (``_q8_eligible(k)``) quantizes its float32 input with the next act
    scale and runs on B4; the others run the float conv on B1. With
    ``collect`` (a calibration pass) it records the eligible input's absmax
    and runs the float conv instead."""
    if _q8_eligible(k):
        if collect is not None:
            collect.append(x.float().abs().amax())
            return _conv_lrelu(x.to(dtype), k, b), None
        s_in = float(act_scales[next(it)])
        x_q = quantize_activations(x.float(), s_in)
        if want_stats:
            y, s1, s2 = _conv_q(x_q, s_in, layer, want_stats=True)
            return y.to(dtype), _stats_from_sums(
                s1, s2, y.shape[1] * y.shape[2] * 4)
        return _conv_q(x_q, s_in, layer).to(dtype), None
    return _conv_lrelu(x.to(dtype), k, b), None


def _float_feats(feats) -> list:
    """Exact float features as (x, 1.0) pairs: the calibration passes'
    decoders read them where the int8 paths read (int8, scale)."""
    return [(f, 1.0) for f in feats]


# ---------------------------------------------------------------------------
# sel_multi_adain (rpst ``fast_path_q8.py:333-469``)
# ---------------------------------------------------------------------------

def _sel_decode_q8(se, c_feats, s_feats, dec: Blocks, dec_q: QBlocks,
                   act_scales, it, dtype, collect=None, c_stats=None,
                   s_stats=None):
    """SELastRP's decode on (int8, scale) encoder features: the running
    fusion's statistics from B4's sums where there are some (the style's
    from the encoder, the running ``stylized``'s from the previous decoder
    conv), the SE bottleneck in ``dtype`` (running-statistic BatchNorms and
    a sigmoid gate). With ``collect`` the same walk records calibration
    absmax."""
    last = [None]

    def dec_conv(x, i, want_stats=False):
        y, last[0] = _dec_conv_q8(x, *dec[i], dec_q[i], dtype, act_scales,
                                  it, collect, want_stats)
        return y

    def enc_stats(stats, idx, feat):
        if stats is not None and stats[idx] is not None:
            return stats[idx]
        return _folded_stats_q8(*feat)

    stylized = _adain_affine_q8(
        c_feats[-1], s_feats[-1],
        c_stats[-1] if c_stats is not None else None,
        s_stats[-1] if s_stats is not None else None)
    stylized = dec_conv(stylized, 0, want_stats=True)
    pairs = s_feats[:-1][::-1]
    for i, sf in enumerate(pairs):
        cm, cstd = (last[0] if last[0] is not None
                    else folded_calc_mean_std(stylized.float()))
        sm, sstd = enc_stats(s_stats, len(pairs) - 1 - i, sf)
        stylized = (stylized.float() - cm) / cstd * sstd + sm
        if i == len(pairs) - 1:
            stylized = _folded_se_bottleneck(stylized.to(dtype), se, dtype)
        stylized = dec_conv(stylized, i + 1, want_stats=i + 1 < len(pairs))
    return unfold(stylized.float())


def calibrate_sel_multi_adain_q8(blocks, se, content, style
                                 ) -> Dict[str, np.ndarray]:
    """Calibration absmax for ``stylize_sel_multi_adain_folded_q8`` in
    consumption order (content encode, style encode, each quantized decoder
    input), from one float32 folded forward (rpst calibrates this family in
    float32): ``blocks`` and ``se`` in float32."""
    with torch.inference_mode():
        absmax: List[torch.Tensor] = []
        enc, dec = blocks
        feats = [_float_feats(_encode_collect(enc, img, torch.float32,
                                              absmax))
                 for img in (content, style)]
        _sel_decode_q8(se, *feats, dec, [None] * len(dec), None, None,
                       torch.float32, collect=absmax)
        return _scales_of(absmax)


def stylize_sel_multi_adain_folded_q8(blocks, qblocks, se, scales, content,
                                      style, dtype=torch.bfloat16
                                      ) -> torch.Tensor:
    """Int8 folded serving of SELastRP: the chained int8 encoder with B4's
    fused statistics, the running-fusion decode, the SE bottleneck in
    ``dtype``. ``blocks`` / ``se`` in ``dtype``, ``qblocks`` from
    ``quantize_blocks``, ``scales`` from ``calibrate_sel_multi_adain_q8``."""
    act_scales = np.asarray(scales["act_scales"], np.float32)
    _check_scales(act_scales, blocks)
    it = iter(range(len(act_scales)))
    (enc, dec), (enc_q, dec_q) = blocks, qblocks
    c_feats, c_stats = _encode_q8(enc, enc_q, act_scales, it, content, dtype)
    s_feats, s_stats = _encode_q8(enc, enc_q, act_scales, it, style, dtype)
    out = _sel_decode_q8(se, c_feats, s_feats, dec, dec_q, act_scales, it,
                         dtype, c_stats=c_stats, s_stats=s_stats)
    return out.to(content.dtype)


# ---------------------------------------------------------------------------
# ccam (rpst ``fast_path_q8.py:470-619``)
# ---------------------------------------------------------------------------

def _folded_ccam_q8(x_feat, y_feat, scale):
    """CCAMDec on folded (int8, scale) or float features. The energy is
    bilinear, so it reduces over the int8 values (exactly, in float64: no
    int8 product on CUDA; rpst's is an int32 einsum) and rescales once:
    energy = (sum x_q y_q) s_x s_y; the recombination dequantizes y."""
    def split(f):
        if isinstance(f, tuple):
            return f[0], 1.0 if f[1] is None else f[1]
        return f, 1.0

    xq, sx = split(x_feat)
    yq, sy = split(y_feat)
    n, hh, ww, c4 = xq.shape
    xr = xq.reshape(n, hh * ww, c4)
    yr = yq.reshape(n, hh * ww, c4)
    if xr.dtype == torch.int8 and yr.dtype == torch.int8:
        e4 = torch.einsum("npa,npb->nab", xr.double(), yr.double()).float()
    else:
        e4 = torch.einsum("npa,npb->nab", xr.float(), yr.float())
    att4 = _block_eye4(_ccam_attention(e4, sx * sy))
    out = torch.einsum("npk,nck->npc", yr.float() * sy, att4)
    return xq.float() * sx + scale * out.reshape(n, hh, ww, c4)


def _ccam_decode_q8(scales, c_feats, s_feats, dec: Blocks, dec_q: QBlocks,
                    stylized_layers: int, act_scales, it, dtype,
                    collect=None):
    """CCAMRP's decode on (int8, scale) encoder features, the AdaIN
    statistics reduced over the int8 values; with ``collect`` the
    calibration walk. ``scales`` are the ``ccam_{i}.scale`` values."""
    def dec_conv(x, i):
        return _dec_conv_q8(x, *dec[i], dec_q[i], dtype, act_scales, it,
                            collect)[0]

    def scale(i):
        return scales[i].float()

    stylized = _adain_affine_q8(c_feats[-1], s_feats[-1])
    att_res = _folded_ccam_q8(c_feats[-1], s_feats[-1], scale(0))
    stylized = dec_conv(stylized + att_res, 0)
    for i, sf in enumerate(s_feats[:-1][::-1]):
        if i + 1 < stylized_layers:
            cm, cstd = folded_calc_mean_std(stylized.float())
            sm, sstd = _folded_stats_q8(*sf)
            stylized = (stylized.float() - cm) / cstd * sstd + sm
            att_res = _folded_ccam_q8(stylized, sf, scale(i + 1))
            stylized = dec_conv(stylized + att_res, i + 1)
        else:
            stylized = dec_conv(stylized, i + 1)
    return unfold(stylized.float())


def calibrate_ccam_q8(blocks, scales, content, style,
                      stylized_layers: int = 5) -> Dict[str, np.ndarray]:
    """Calibration absmax for ``stylize_ccam_folded_q8``, from one float32
    folded forward (``blocks`` in float32), as rpst's."""
    with torch.inference_mode():
        absmax: List[torch.Tensor] = []
        enc, dec = blocks
        feats = [_float_feats(_encode_collect(enc, img, torch.float32,
                                              absmax))
                 for img in (content, style)]
        _ccam_decode_q8(scales, *feats, dec, [None] * len(dec),
                        stylized_layers, None, None, torch.float32,
                        collect=absmax)
        return _scales_of(absmax)


def stylize_ccam_folded_q8(blocks, qblocks, ccam_scales, scales, content,
                           style, stylized_layers: int = 5,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """Int8 folded serving of CCAMRP: the chained int8 encoder, the CCAM
    energies reduced over int8, the AdaIN fusions with int8-reduced style
    statistics."""
    act_scales = np.asarray(scales["act_scales"], np.float32)
    _check_scales(act_scales, blocks)
    it = iter(range(len(act_scales)))
    (enc, dec), (enc_q, dec_q) = blocks, qblocks
    c_feats, _ = _encode_q8(enc, enc_q, act_scales, it, content, dtype,
                            fuse_stats=False)
    s_feats, _ = _encode_q8(enc, enc_q, act_scales, it, style, dtype,
                            fuse_stats=False)
    out = _ccam_decode_q8(ccam_scales, c_feats, s_feats, dec, dec_q,
                          stylized_layers, act_scales, it, dtype)
    return out.to(content.dtype)


# ---------------------------------------------------------------------------
# mst (rpst ``fast_path_q8.py:921-1032``)
# ---------------------------------------------------------------------------

def _mst_fuse_f32(cf_f, sf_f, n_clusters: int, lam: float):
    """The MST transform on folded float32 features, unfolded to raster
    order for it (as ``fast_path.stylize_mst_folded``)."""
    return fold(mst_transfer_batch(unfold(cf_f).float(), unfold(sf_f).float(),
                                   n_clusters, lam))


def calibrate_mst_q8(blocks, content, style, stylized_layers: int = 1,
                     n_clusters: int = 3, mst_lambda: float = 0.0
                     ) -> Dict[str, np.ndarray]:
    """Calibration absmax for ``stylize_mst_folded_q8``: the encoder chain
    scales of both images, then each eligible decoder conv's input, from one
    bfloat16 folded forward (``blocks`` in bfloat16), as rpst's."""
    with torch.inference_mode():
        absmax: List[torch.Tensor] = []
        enc, dec = blocks
        dtype = enc[0][0].dtype
        c_feats, s_feats = (_encode_collect(enc, img, dtype, absmax)
                            for img in (content, style))
        stylized = _mst_fuse_f32(c_feats[-1], s_feats[-1], n_clusters,
                                 mst_lambda)
        for i, sf in enumerate([None] + s_feats[:-1][::-1]):
            if 0 < i < stylized_layers:
                stylized = _mst_fuse_f32(stylized, sf, n_clusters,
                                         mst_lambda)
            stylized = _dec_conv_q8(stylized, *dec[i], None, dtype, None,
                                    None, absmax)[0]
        return _scales_of(absmax)


def stylize_mst_folded_q8(blocks, qblocks, scales, content, style,
                          stylized_layers: int = 1, n_clusters: int = 3,
                          mst_lambda: float = 0.0,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Int8 folded serving of MSTRP: the chained int8 encode of both images,
    the MST transform in float32 on raster-order features, the decoder's
    eligible convs on B4."""
    act_scales = np.asarray(scales["act_scales"], np.float32)
    _check_scales(act_scales, blocks)
    it = iter(range(len(act_scales)))
    (enc, dec), (enc_q, dec_q) = blocks, qblocks
    c_feats, _ = _encode_q8(enc, enc_q, act_scales, it, content, dtype,
                            fuse_stats=False)
    s_feats, _ = _encode_q8(enc, enc_q, act_scales, it, style, dtype,
                            fuse_stats=False)

    def deq(pair):
        q, s = pair
        return q.float() * s if s is not None else q.float()

    stylized = _mst_fuse_f32(deq(c_feats[-1]), deq(s_feats[-1]), n_clusters,
                             mst_lambda)
    for i, sf in enumerate([None] + s_feats[:-1][::-1]):
        if 0 < i < stylized_layers:
            stylized = _mst_fuse_f32(stylized, deq(sf), n_clusters,
                                     mst_lambda)
        stylized = _dec_conv_q8(stylized.float(), *dec[i], dec_q[i], dtype,
                                act_scales, it, None)[0]
    return unfold(stylized).to(content.dtype)
