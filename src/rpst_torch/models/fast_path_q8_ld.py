"""Int8 serving of the LD family's v1 and v2 (``ld_adain``, ``ld_adain2``);
port of ``rpst.models.fast_path_q8`` :1402-1769.

Both encode content and style in one 2N pass (exact: no op of the stacks
couples the batch). A layer whose convs have both widths a multiple of 128
(``ld_eligible``; rpst's gate, kept because it decides which layers are
quantized) runs int8 on B5, the rest ``F.conv2d`` in the working type;
every AdaIN fusion stays float (the style signal), and a decoder conv that
is eligible quantizes its own input (per-conv scales).

  * v1 (``stylize_ld_q8`` on v1's ``ld_blocks``): at an eligible layer
    the shared input is quantized once, and both branches read the same
    int8 tensor: the 3x3
    small branch on B5, the 7x7 big branch on B5's 7x7 form, both lrelu
    (0.2) with reflect padding; when the next layer is eligible too, both
    requantize to one shared output scale, so the branch concat is an int8
    concat. At the yaml's width (hidden 16, 5 layers) layers 3 and 4
    (128 -> 128 and 256 -> 256) and decoder convs 0 and 1 (512 -> 256,
    256 -> 128) are eligible: 4 activation scales, 6 B5 launches a
    stylize (four 3x3, two 7x7). rpst runs its 7x7 convs through its
    compiler's int8 conv (``_xla_conv_q8``) and offers its 3x3s to either
    engine (``conv_impl``, a TPU layout choice); both compute the same
    int8 sums, so here every eligible conv is B5.
  * v2 (the same function on v2's blocks): at an eligible layer three
    3x3 convs run on B5: the small branch (lrelu), then the pooled
    branch's ``conv_a`` -> ``conv_b`` (relu, chained int8 through their
    own scale); its linear
    1x1 head stays in the working type (rpst never quantizes it), so
    ``conv_a``'s input takes a scale of its own; the pool, the trailing
    pad and the nearest resize run on ``conv_b``'s float output. At the
    yaml's hidden 8: layer 4 and decoder conv 0, 4 scales and 4 B5
    launches a stylize.

Calibration is the same code on a recording ``_ScaleStream`` (bfloat16,
the batch capped at 2 images, as rpst's), so the two scale orders cannot
drift apart. Tensors are NHWC, weights OIHW for ``F.conv2d`` and HWIO
int8 for B5.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.folded_conv_q8 import quantize_activations
from ..ops.stats import adaptive_instance_normalization as adain
from .fast_path_q8 import Q8Layer
from .fast_path_q8_std import (Convs, _calib_cap, _deq, _maxpool2x_any,
                               _reflect_conv, _scales_from, _ScaleStream,
                               make_conv_q, quantize_convs)
from .ld_adain import LDAdaINRP, resize_nearest


def ld_eligible(w: torch.Tensor) -> bool:
    """An OIHW 3x3 or 7x7 weight whose two widths are multiples of 128."""
    return (w.shape[2] in (3, 7) and w.shape[0] % 128 == 0
            and w.shape[1] % 128 == 0)


def _pair(conv: torch.nn.Conv2d, dtype):
    return conv.weight.detach().to(dtype), conv.bias.detach().to(dtype)


def ld_blocks(model: LDAdaINRP, dtype: torch.dtype):
    """(encoder, decoder) of an LD v1 or v2 model in ``dtype``, detached:
    per encoder layer v1's (small, big) and v2's (small, conv1x1, conv_a,
    conv_b) (weight, bias) pairs; the decoder's pairs."""
    enc = []
    for small, big in zip(model.smalls(), model.bigs()):
        convs = [_pair(small.PadConv_0.Conv_0, dtype)]
        if model.variant == 1:
            convs.append(_pair(big.PadConv_0.Conv_0, dtype))
        else:
            convs += [_pair(big.conv1x1, dtype),
                      _pair(big.conv_a.Conv_0, dtype),
                      _pair(big.conv_b.Conv_0, dtype)]
        enc.append(tuple(convs))
    return enc, [_pair(d.PadConv_0.Conv_0, dtype) for d in model.decs()]


def _int8_convs(layer) -> Convs:
    """The convs of an encoder layer that run int8 when the layer is
    eligible: v1's two branches; v2's small branch, conv_a and conv_b."""
    return list(layer) if len(layer) == 2 else [layer[0], layer[2], layer[3]]


def _layer_eligible(layer) -> bool:
    return all(ld_eligible(w) for w, _ in _int8_convs(layer))


def quantize_ld(blocks) -> Tuple[List[Optional[Tuple[Q8Layer, ...]]],
                                 List[Optional[Q8Layer]]]:
    """(encoder, decoder) int8 layers from the float32 ``ld_blocks``: per
    eligible encoder layer a tuple of ``Q8Layer`` (its ``_int8_convs``),
    None for the others; per decoder conv a ``Q8Layer`` or None."""
    enc, dec = blocks
    enc_q = [tuple(quantize_convs(_int8_convs(layer), ld_eligible))
             if _layer_eligible(layer) else None for layer in enc]
    return enc_q, quantize_convs(dec, ld_eligible)


def ld_q8_plan(blocks) -> Dict[str, int]:
    """What one ``stylize_ld_q8`` of v1's (two-conv layers) or v2's blocks
    runs: the act scales it consumes, its B5 launches and, among them,
    those of the 7x7 form."""
    enc, dec = blocks
    elig = [_layer_eligible(layer) for layer in enc]
    scales = b5 = b7 = 0
    for i, (ok, layer) in enumerate(zip(elig, enc)):
        if not ok:
            continue
        convs = _int8_convs(layer)
        b5 += len(convs)
        b7 += sum(w.shape[2] == 7 for w, _ in convs)
        if len(layer) == 2:  # v1: an input scale unless chained in, a
            chain_in = i > 0 and elig[i - 1]  # shared output scale if out
            scales += int(not chain_in) + int(i + 1 < len(enc)
                                              and elig[i + 1])
        else:  # v2: x, conv_a's input, the conv_a -> conv_b chain
            scales += 3
    d = sum(ld_eligible(w) for w, _ in dec)
    return {"scales": scales + d, "B5": b5 + d, "B5_7x7": b7}


def _lrelu_conv(x, w, b):
    """Reflect pad K // 2, conv, bias, lrelu 0.2 (the Conv2dBlock default
    the family is built from), NHWC, in w's type."""
    p = w.shape[2] // 2
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect"),
                 w, b)
    return F.leaky_relu(y.permute(0, 2, 3, 1), 0.2)


def _conv1x1(x, w, b):
    """The pooled branch's linear 1x1 head, NHWC, in w's type."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, b).permute(0, 2, 3, 1)


def _reflect_pad1(x):
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                 mode="reflect").permute(0, 2, 3, 1)


def _decode(dec, dec_q, feats, n, st, dtype, conv_q, stylized_layers):
    """The v1 / v2 decoder (rpst ``models/ld_adain.py:228-255``): AdaIN at
    the deepest feature, then the running fusion ``stylized +
    adain(stylized, style_feat)`` (reference ``adain_rp.py:550``) before
    each shallower conv while ``stylized_layers`` says so; an eligible conv
    quantizes its own input."""
    def fsplit(i):
        t, s = feats[i]
        f = t if s is None else _deq(t, s, dtype)
        return f[:n], f[n:]

    def apply(x, i):
        w, b = dec[i]
        if ld_eligible(w):
            s = st.take(x)
            if not st.recording:
                return conv_q(quantize_activations(x, s), s, dec_q[i])
        return _lrelu_conv(x, w, b)

    L = len(feats)
    cf, sf = fsplit(L - 1)
    stylized = apply(adain(cf, sf).to(dtype), 0)
    for i in range(L - 1):
        _, sfi = fsplit(L - 2 - i)
        if i < stylized_layers - 1:
            stylized = stylized + adain(stylized, sfi).to(dtype)
        stylized = apply(stylized, i + 1)
    return stylized


def _ld_q8_pass(blocks, qblocks, content, style, st: _ScaleStream, dtype,
                stylized_layers: int):
    """LD v1 (rpst ``_ld_q8_pass``); ``qblocks`` None when recording."""
    enc, dec = blocks
    enc_q, dec_q = qblocks if qblocks is not None else (None, None)
    conv_q = make_conv_q(dtype, "reflect", alpha=0.2)
    elig = [_layer_eligible(layer) for layer in enc]
    n, L = content.shape[0], len(enc)
    x = torch.cat([content, style], dim=0).to(dtype)
    x_q8, x_s = False, None  # x is (really or, recording, virtually) int8
    feats = []  # (tensor, its int8 scale or None) per layer
    for i, ((ws, bs), (wg, bg)) in enumerate(enc):
        if not elig[i]:
            if x_s is not None:
                x = _deq(x, x_s, dtype)
            x_q8, x_s = False, None
            x = torch.cat([_lrelu_conv(x, ws, bs), _lrelu_conv(x, wg, bg)],
                          dim=-1)
            feats.append((x, None))
            continue
        if not x_q8:
            s = st.take(x)
            if not st.recording:
                x, x_s = quantize_activations(x, s), s
        chain = i + 1 < L and elig[i + 1]
        if st.recording:
            x = torch.cat([_lrelu_conv(x, ws, bs), _lrelu_conv(x, wg, bg)],
                          dim=-1)
            if chain:
                st.take(x)  # the branches' shared output scale
            x_q8, x_s = chain, None
        else:
            out_s = st.take(None) if chain else None
            small, big = enc_q[i]
            x = torch.cat([conv_q(x, x_s, small, out_s),
                           conv_q(x, x_s, big, out_s)], dim=-1)
            x_q8, x_s = chain, out_s
        feats.append((x, x_s))
    return _decode(dec, dec_q, feats, n, st, dtype, conv_q, stylized_layers)


def _ld2_q8_pass(blocks, qblocks, content, style, st: _ScaleStream, dtype,
                 stylized_layers: int):
    """LD v2 (rpst ``_ld2_q8_pass``); ``qblocks`` None when recording."""
    enc, dec = blocks
    enc_q, dec_q = qblocks if qblocks is not None else (None, None)
    conv_lrelu = make_conv_q(dtype, "reflect", alpha=0.2)
    conv_relu = make_conv_q(dtype, "reflect", alpha=0.0)
    n = content.shape[0]
    x = torch.cat([content, style], dim=0).to(dtype)
    feats = []
    for i, layer in enumerate(enc):
        (ws, bs), (w1, b1), (wa, ba), (wb, bb) = layer
        h, w = x.shape[1], x.shape[2]
        t = _conv1x1(x, w1, b1)
        if _layer_eligible(layer):
            s_x, s_t = st.take(x), st.take(t)
            if st.recording:
                sm = _lrelu_conv(x, ws, bs)
                a = _reflect_conv(t, wa, ba)
                st.take(a)  # the conv_a -> conv_b chain scale
                bg = _reflect_conv(a, wb, bb)
            else:
                q_small, q_a, q_b = enc_q[i]
                sm = conv_lrelu(quantize_activations(x, s_x), s_x, q_small)
                s_ab = st.take(None)
                a = conv_relu(quantize_activations(t, s_t), s_t, q_a, s_ab)
                bg = conv_relu(a, s_ab, q_b)
        else:
            sm = _lrelu_conv(x, ws, bs)
            bg = _reflect_conv(_reflect_conv(t, wa, ba), wb, bb)
        bg = resize_nearest(_reflect_pad1(_maxpool2x_any(bg)), h, w)
        x = torch.cat([sm, bg.to(sm.dtype)], dim=-1)
        feats.append((x, None))
    return _decode(dec, dec_q, feats, n, st, dtype, conv_lrelu,
                   stylized_layers)


_PASSES = {1: _ld_q8_pass, 2: _ld2_q8_pass}


def _variant(blocks) -> int:
    return 1 if len(blocks[0][0]) == 2 else 2


def calibrate_ld_q8(blocks, content, style,
                    stylized_layers: int = 5) -> Dict[str, np.ndarray]:
    """One recording pass -> {'act_scales'} for ``stylize_ld_q8``, v1 or v2
    by ``blocks``, the bfloat16 ``ld_blocks`` (rpst calibrates in
    bfloat16), on at most 2 images."""
    content, style = _calib_cap(content, style)
    with torch.inference_mode():
        st = _ScaleStream()
        _PASSES[_variant(blocks)](blocks, None, content, style, st,
                                  blocks[1][0][0].dtype, stylized_layers)
        return _scales_from(st.absmax)


def stylize_ld_q8(blocks, qblocks, scales, content, style,
                  stylized_layers: int = 5,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Int8 LD v1 or v2 serving (by ``blocks``): ``blocks`` the
    ``ld_blocks`` in ``dtype``, ``qblocks`` ``quantize_ld`` of the float32
    ones, ``scales`` from ``calibrate_ld_q8``; content, style (N, H, W, 3)
    (v2: H, W even, the int8 path's exact 2x2 pool) -> (N, H, W, 3) in
    content's type."""
    want = ld_q8_plan(blocks)["scales"]
    if len(scales["act_scales"]) != want:
        raise ValueError(f"{len(scales['act_scales'])} act scales for a model "
                         f"that consumes {want}: calibrate this model")
    st = _ScaleStream(scales["act_scales"])
    out = _PASSES[_variant(blocks)](blocks, qblocks, content, style, st,
                                    dtype, stylized_layers)
    return out.to(content.dtype)
