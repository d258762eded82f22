"""Int8 serving on the standard (unfolded) layout, and the int8 VGG chain
of the training loss's targets; port of the standard-layout sections of
``rpst.models.fast_path_q8`` (:620-862 adain and wct, :1105-1286 the VGG
chain). It lives beside ``fast_path_q8`` (the folded flagship path) so that
each file reads as one path.

The adain and wct families run full-resolution zero-padded convs whose
widths double up to 512 channels. Their layers with both widths a multiple
of 128 (``q8_eligible``: at hidden_dim 32 the encoder's 128->256 and
256->512 on the 2N batch and the decoder's 512->256 and 256->128) run int8
on B5 (``ops.conv2d_q8``, zero pad, relu), chained int8 -> int8; the narrow
layers stay ``F.conv2d`` in the working type, as rpst leaves them to its
compiler. AdaIN statistics reduce over the int8 deepest features and
rescale; the WCT eigendecomposition stays float32. The 128 gate was a TPU
tiling rule in rpst, but it decides which layers are quantized and so what
the function computes: it is kept as is.

The VGG chain (``vgg_target_taps_q8``) runs the frozen encoder's aligned
reflect + relu convs on B5: conv_4 (128->128) at img/2, conv_5 (128->256)
and conv_6..8 (256->256) at img/4, conv_9 (256->512) at img/8, six launches
on the 2N style + content batch. rpst can send these layers to its
compiler's own int8 conv instead (``conv_impl='xla'``); PyTorch has no int8
conv on CUDA, so here every eligible layer goes to B5.

Static SANet (``stylize_sanet_q8``, rpst's :1289-1360) chains the same VGG
program through all five stages on the 2N batch (conv_4 .. conv_13: 10 B5
launches), runs the attention transform in the working type (the softmax
attention is the style signal; it goes to B6, two launches), and decodes
through the VGG-mirror decoder, whose conv0 .. conv5 run on B5 (6 launches,
nearest upsamples in int8, which commute with the symmetric quantizer): 16
B5 launches and 16 activation scales per stylize.

Tensors are NHWC throughout (B5's layout); weights are the modules' OIHW
tensors for ``F.conv2d`` and HWIO int8 for B5. Scale arithmetic follows
rpst: Python float64, then float32; divisions by Python scalars go through
``div_f32`` (a true division on CUDA too).

Usage::

    convs = std_blocks(model, torch.bfloat16)
    scales = calibrate_adain_q8(convs, c, s)
    img = stylize_adain_q8(convs, quantize_std(std_blocks(model,
                           torch.float32)), scales, c, s)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.decoder import MIRROR_UP_BEFORE
from ..nn.decoder import upsample_nearest_2x_nhwc as _upsample2x_any
from ..nn.vgg import _STAGES, VGG19Encoder
from ..ops.conv2d_q8 import fused_conv2d_q8
from ..ops.flash_attention import sanet_attention
from ..ops.folded_conv_q8 import (div_f32, quantize_activations,
                                  quantize_weights)
from ..ops.stats import adaptive_instance_normalization as adain
from ..ops.wct import wct_fuse
from .fast_path_q8 import Q8Layer, _scale_rows
from .sanet import Attention, SAModel, sanet_attention_block

# [(weight OIHW, bias)] of one conv stack, in the working type
Convs = List[Tuple[torch.Tensor, torch.Tensor]]
QConvs = List[Optional[Q8Layer]]
CALIB_CAP = 2


def q8_eligible(w: torch.Tensor) -> bool:
    """An OIHW 3x3 weight whose two widths are multiples of 128."""
    return (w.shape[2] == 3 and w.shape[0] % 128 == 0
            and w.shape[1] % 128 == 0)


def std_blocks(model, dtype: torch.dtype) -> Tuple[Convs, Convs]:
    """(encoder, decoder) conv lists of an ``AdaINRP`` / ``WCTRP`` in
    ``dtype``, detached from the parameters."""
    def stack(seq):
        return [(c.Conv_0.weight.detach().to(dtype),
                 c.Conv_0.bias.detach().to(dtype)) for c in seq.convs]
    return stack(model.encoder), stack(model.decoder)


def quantize_convs(convs: Convs) -> QConvs:
    """``Q8Layer`` (HWIO int8 weights per output channel, their scales, the
    float32 bias) for the eligible layers, None for the others; from the
    float32 weights, as rpst quantizes ``k.astype(float32)``."""
    out: QConvs = []
    for w, b in convs:
        if not q8_eligible(w):
            out.append(None)
            continue
        w_q, w_scale = quantize_weights(w.float().permute(2, 3, 1, 0))
        out.append(Q8Layer(w_q.contiguous(), w_scale, b.float()))
    return out


def quantize_std(blocks: Tuple[Convs, Convs]) -> Tuple[QConvs, QConvs]:
    return quantize_convs(blocks[0]), quantize_convs(blocks[1])


def std_q8_plan(enc: Convs, dec: Convs) -> Dict[str, int]:
    """What one adain / wct q8 stylize runs, derived as ``_encode_std_q8``
    and ``_decode_std_q8`` decide it: the act scales it consumes and its B5
    launches (the 2N encode is one pass)."""
    e = [q8_eligible(w) for w, _ in enc]
    d = [q8_eligible(w) for w, _ in dec]
    scales = 0
    for li, ok in enumerate(e):
        nxt = li + 1 < len(e) and e[li + 1]
        if ok:
            scales += int(nxt or li == len(e) - 1)
        else:
            scales += int(nxt)
    prev_q = False
    for li, ok in enumerate(d):
        if ok:
            scales += int(not prev_q)
            prev_q = li + 1 < len(d) and d[li + 1]
            scales += int(prev_q)
        else:
            prev_q = False
    return {"scales": scales, "B5": sum(e) + sum(d)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _conv_nhwc(x, w, b, pad_mode: str, act: bool = True):
    """pad + conv + bias (+ relu) of an NHWC tensor through ``F.conv2d``,
    in w's type; a 1x1 kernel takes no pad."""
    xc = x.permute(0, 3, 1, 2)
    if w.shape[2] == 1:
        y = F.conv2d(xc, w, b)
    elif pad_mode == "zero":
        y = F.conv2d(xc, w, b, padding=1)
    else:
        y = F.conv2d(F.pad(xc, (1, 1, 1, 1), mode="reflect"), w, b)
    y = y.permute(0, 2, 3, 1)
    return F.relu(y) if act else y


def _same_conv_relu(x, w, b):
    return _conv_nhwc(x, w, b, "zero")


def _reflect_conv(x, w, b, act: bool = True):
    return _conv_nhwc(x, w, b, "reflect", act)


def make_conv_q(dtype: torch.dtype, pad_mode: str = "zero") -> Callable:
    """The B5 layer closure, with relu (alpha = 0): ``pad_mode='zero'`` is
    the RPSequence block, ``'reflect'`` the VGG block. ``conv_q(x_q,
    x_scale, layer, out_scale)`` returns int8 with ``out_scale``, else B5's
    bfloat16 output cast to ``dtype`` (rounded to bfloat16 first even when
    ``dtype`` is float32, as rpst's is)."""
    def conv_q(x_q, x_scale: float, layer: Q8Layer, out_scale=None):
        y = fused_conv2d_q8(x_q.contiguous(), layer.w_q,
                            _scale_rows(x_scale, layer, out_scale),
                            out_int8=out_scale is not None, alpha=0.0,
                            pad_mode=pad_mode)
        return y if out_scale is not None else y.to(dtype)
    return conv_q


def _stats_q8(q: torch.Tensor, scale: float, eps: float = 1e-5):
    """Instance mean / std of an NHWC int8 tensor with a per-tensor scale:
    both are linear in the scale, so they reduce over the int8 values and
    rescale once. The sums of up to 512 * 512 values and squares pass 2^24,
    where float32 summation order shows; they are exact here (int64), then
    float32, so they agree with rpst's float32 sums to its rounding only."""
    n, h, w, c = q.shape
    m = h * w
    v = q.to(torch.int32)
    s1 = v.sum(dim=(1, 2)).float()
    s2 = (v * v).sum(dim=(1, 2)).float()
    m1 = float(max(m - 1, 1))
    mean = div_f32(s1, float(m)) * scale
    var = (div_f32(s2, m1) - div_f32(s1 * s1, float(m) * m1)) * scale * scale
    std = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    return mean[:, None, None, :], std[:, None, None, :]


def _deq(q, scale: float, dtype):
    return (q.float() * scale).to(dtype)


def _absmax(x) -> torch.Tensor:
    return x.float().abs().amax()


def _scales_from(absmax: Sequence[torch.Tensor]) -> Dict[str, np.ndarray]:
    """0-dim absmax tensors -> {'act_scales': absmax / 127 (at least 1e-6 /
    127)}, in Python float64 then float32 as rpst; one device sync."""
    values = torch.stack(list(absmax)).cpu().tolist() if absmax else []
    return {"act_scales": np.asarray([max(float(a), 1e-6) / 127.0
                                      for a in values], np.float32)}


# ---------------------------------------------------------------------------
# adain / wct
# ---------------------------------------------------------------------------

def _collect_rp_sequence(enc: Convs, dec: Convs, x, fuse):
    """The forward in the convs' type recording the calibration absmaxes in
    exactly the order ``_encode_std_q8`` / ``_decode_std_q8`` consume them:
    encoder (2N pass) outputs that feed or leave eligible layers, then each
    quantized decoder input and chained output. ``fuse`` maps the 2N
    deepest feature to the decoder input."""
    absmax: List[torch.Tensor] = []
    for li, (w, b) in enumerate(enc):
        x = _same_conv_relu(x, w, b)
        nxt = li + 1 < len(enc) and q8_eligible(enc[li + 1][0])
        if nxt or (li == len(enc) - 1 and q8_eligible(w)):
            absmax.append(_absmax(x))
    x = fuse(x)
    for w, b in dec:
        x = x.to(w.dtype)
        if q8_eligible(w):
            absmax.append(_absmax(x))
        x = _same_conv_relu(x, w, b)
    return x, absmax


def _encode_std_q8(enc: Convs, enc_q: QConvs, act_scales, it, x, conv_q):
    """The chained int8 encoder; returns the deepest feature as (tensor,
    scale or None): int8 when the last layer is eligible."""
    x_s = None
    for li, (w, b) in enumerate(enc):
        nxt = li + 1 < len(enc) and enc_q[li + 1] is not None
        if enc_q[li] is not None:
            if nxt or li == len(enc) - 1:
                out_s = float(act_scales[next(it)])
                x, x_s = conv_q(x, x_s, enc_q[li], out_s), out_s
            else:
                # the next layer is a float conv: hand it dequantized values
                # (the calibration records no scale at this point)
                x, x_s = conv_q(x, x_s, enc_q[li]), None
        else:
            x = _same_conv_relu(x, w, b)
            if nxt:
                s = float(act_scales[next(it)])
                x, x_s = quantize_activations(x, s), s
            else:
                x_s = None
    return x, x_s


def _decode_std_q8(dec: Convs, dec_q: QConvs, act_scales, it, x, conv_q):
    """The decoder on a float input: eligible layers on B5 (chained int8
    while consecutive), the rest ``F.conv2d``."""
    x_s = None
    for li, (w, b) in enumerate(dec):
        if dec_q[li] is not None:
            if x_s is None:
                s = float(act_scales[next(it)])
                x, x_s = quantize_activations(x, s), s
            if li + 1 < len(dec) and dec_q[li + 1] is not None:
                out_s = float(act_scales[next(it)])
                x, x_s = conv_q(x, x_s, dec_q[li], out_s), out_s
            else:
                x, x_s = conv_q(x, x_s, dec_q[li]), None
        else:
            x = _same_conv_relu(x, w, b)
            x_s = None
    return x


def _calib_cap(content, style, cap: int = CALIB_CAP):
    """Cap the calibration batch of the full-resolution wide-channel
    families: per-tensor absmax scales need no more samples, and an
    uncapped pass holds every 512-channel full-resolution activation of a
    large batch at once. Calibration's peak memory must not exceed
    serving's."""
    return content[:cap], style[:cap]


def _calibrate(blocks, content, style, fuse):
    content, style = _calib_cap(content, style)
    enc, dec = blocks
    with torch.inference_mode():
        x = torch.cat([content, style], dim=0).to(enc[0][0].dtype)
        _, absmax = _collect_rp_sequence(enc, dec, x, fuse(content.shape[0]))
        return _scales_from(absmax)


def calibrate_adain_q8(blocks, content, style) -> Dict[str, np.ndarray]:
    """One calibration pass -> {'act_scales'} for ``stylize_adain_q8``;
    ``blocks`` are the bfloat16 ``std_blocks`` (rpst calibrates in bf16)."""
    return _calibrate(blocks, content, style,
                      lambda n: lambda f: adain(f[:n], f[n:]))


def calibrate_wct_q8(blocks, content, style, method: str = "closed-form",
                     wct_dtype: torch.dtype = torch.float32):
    """Calibration absmaxes for ``stylize_wct_q8``."""
    return _calibrate(blocks, content, style, lambda n: lambda f: wct_fuse(
        f[:n].float(), f[n:].float(), method=method, dtype=wct_dtype))


def _stylize_std_q8(blocks, qblocks, scales, content, style, dtype, fuse):
    enc, dec = blocks
    enc_q, dec_q = qblocks
    act_scales = np.asarray(scales["act_scales"], np.float32)
    want = std_q8_plan(enc, dec)["scales"]
    if len(act_scales) != want:
        raise ValueError(f"{len(act_scales)} act scales for a stack that "
                         f"consumes {want}: calibrate this model's weights")
    it = iter(range(len(act_scales)))
    conv_q = make_conv_q(dtype)
    n = content.shape[0]
    x2 = torch.cat([content, style], dim=0).to(dtype)
    x, x_s = _encode_std_q8(enc, enc_q, act_scales, it, x2, conv_q)
    fused = fuse(x[:n], x[n:], x_s)
    out = _decode_std_q8(dec, dec_q, act_scales, it, fused.to(dtype), conv_q)
    return out.to(content.dtype)


def stylize_adain_q8(blocks, qblocks, scales, content, style,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Int8 AdaINRP serving (encode both images in one 2N pass, one AdaIN
    fusion at the deepest feature, decode). ``blocks``: ``std_blocks`` in
    ``dtype``; ``qblocks``: ``quantize_std`` of the float32 blocks;
    content, style (N, H, W, 3)."""
    def fuse(cq, sq, x_s):
        if x_s is None:
            return adain(cq, sq).float()
        cm, cstd = _stats_q8(cq, x_s)
        sm, sstd = _stats_q8(sq, x_s)
        return (cq.float() * x_s - cm) / cstd * sstd + sm
    return _stylize_std_q8(blocks, qblocks, scales, content, style, dtype,
                           fuse)


def stylize_wct_q8(blocks, qblocks, scales, content, style,
                   method: str = "closed-form",
                   wct_dtype: torch.dtype = torch.float32,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Int8 WCTRP serving: adain's stacks with the whiten-color fuse at the
    deepest feature, on dequantized float32 features (the style covariance
    is the signal; only conv inputs and outputs are quantized)."""
    def fuse(cq, sq, x_s):
        cf = cq.float() * x_s if x_s is not None else cq.float()
        sf = sq.float() * x_s if x_s is not None else sq.float()
        return wct_fuse(cf, sf, method=method, dtype=wct_dtype)
    return _stylize_std_q8(blocks, qblocks, scales, content, style, dtype,
                           fuse)


# ---------------------------------------------------------------------------
# the int8 VGG chain (loss targets)
# ---------------------------------------------------------------------------

class _ScaleStream:
    """One ordered stream of activation scales, shared by the calibration
    pass (``recording``: runs float, appends absmaxes) and the q8 pass
    (replays the calibrated scales in the same order). Both passes walk the
    same code, so the two orders cannot drift apart."""

    def __init__(self, scales=None):
        self.scales = None if scales is None else np.asarray(scales,
                                                             np.float32)
        self.absmax: List[torch.Tensor] = []
        self._i = 0

    @property
    def recording(self) -> bool:
        return self.scales is None

    def take(self, ref):
        """The next scale; when recording, note absmax(ref) and return
        None."""
        if self.recording:
            self.absmax.append(_absmax(ref))
            return None
        s = float(self.scales[self._i])
        self._i += 1
        return s


def _maxpool2x_any(x):
    """2x2/2 max pool of an NHWC tensor with even H, W, in any type (int8
    pools exactly: max commutes with the monotone symmetric quantizer)."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"_maxpool2x_any needs even H, W; got {(h, w)}")
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _conv_chain_q8(convs: Convs, qconvs: QConvs, program, x, dtype, conv_q,
                   st: _ScaleStream, taps=()):
    """Drive a reflect + relu conv chain through B5.

    ``program[i]`` = (pre, act): pre "pool", "up" or None applied before
    conv i, act False only for a conv without activation. Eligible convs
    (``qconvs`` entry set, act True) run int8, chained int8 while the next
    conv is also eligible (pools and upsamples are transparent to the
    chain); the rest run
    ``F.conv2d``. ``taps``: indices whose post-activation output is returned
    dequantized. Returns (x, {i: tap}). When ``st.recording`` everything runs
    float and the stream records absmaxes at exactly the points the replay
    consumes scales."""
    out_taps = {}
    x = x.to(dtype)
    x_s = None      # replay: the scale of the current int8 tensor
    virt = False    # recording: the replay would be int8 here

    def eligible(i):
        return (i < len(convs) and qconvs[i] is not None and program[i][1])

    for li, (w, b) in enumerate(convs):
        pre, act = program[li]
        if pre == "pool":
            x = _maxpool2x_any(x)
        elif pre == "up":
            x = _upsample2x_any(x)
        if eligible(li):
            is_q = virt if st.recording else x_s is not None
            if not is_q:
                s = st.take(x)
                if not st.recording:
                    x, x_s = quantize_activations(x, s), s
            chain = eligible(li + 1)
            if st.recording:
                x = _reflect_conv(x, w, b)
                if chain:
                    st.take(x)
                virt = chain
            elif chain:
                out_s = st.take(None)
                x, x_s = conv_q(x, x_s, qconvs[li], out_s), out_s
            else:
                x, x_s = conv_q(x, x_s, qconvs[li]), None
        else:
            if x_s is not None:
                x, x_s = _deq(x, x_s, dtype), None
            virt = False
            x = _reflect_conv(x, w, b, act=act)
        if li in taps:
            out_taps[li] = _deq(x, x_s, dtype) if x_s is not None else x
    if x_s is not None:
        x = _deq(x, x_s, dtype)
    return x, out_taps


def _vgg_q8_layers(vgg: VGG19Encoder, num_stages: int, dtype):
    """(convs, qconvs, program, tap indices) of the encoder: the 1x1 head,
    reflect 3x3 relu convs, a pool before the last conv of stages 2+, taps
    at relu{k}_1. The float weights are cast per call; the int8 weights are
    quantized once (``vgg.cached``: the encoder is frozen)."""
    n_convs = 2 + sum(len(_STAGES[s]) for s in range(1, num_stages))
    convs = [(vgg.conv(i).weight.to(dtype), vgg.conv(i).bias.to(dtype))
             for i in range(n_convs)]
    qconvs = vgg.cached(
        ("q8", num_stages, convs[0][0].device),
        lambda: quantize_convs([(vgg.conv(i).weight, vgg.conv(i).bias)
                                for i in range(n_convs)]))
    program = [(None, False), (None, True)]  # 1x1 head; conv -> relu1_1
    tap_idx = [1]
    i = 2
    for stage in range(2, num_stages + 1):
        specs = _STAGES[stage - 1]
        for j in range(len(specs)):
            program.append(("pool" if j == len(specs) - 1 else None, True))
            i += 1
        tap_idx.append(i - 1)
    return convs, qconvs, program, tap_idx


def _vgg_encode_q8(vgg, x, num_stages, dtype, conv_q, st):
    """[relu1_1 .. relu{num_stages}_1] with the eligible VGG convs int8."""
    convs, qconvs, program, tap_idx = _vgg_q8_layers(vgg, num_stages, dtype)
    _, taps = _conv_chain_q8(convs, qconvs, program, x, dtype, conv_q, st,
                             taps=tap_idx)
    return [taps[i] for i in tap_idx]


def _chain_plan(qconvs: QConvs, program) -> Dict[str, int]:
    """The scales one ``_conv_chain_q8`` replay consumes (one where a run of
    eligible convs starts, one per chained output) and its B5 launches."""
    elig = [q is not None and program[i][1] for i, q in enumerate(qconvs)]
    scales = sum(int(e and not (i and elig[i - 1]))
                 + int(e and i + 1 < len(elig) and elig[i + 1])
                 for i, e in enumerate(elig))
    return {"scales": scales, "B5": sum(elig)}


def vgg_q8_plan(vgg: VGG19Encoder, num_stages: int = 4) -> Dict[str, int]:
    """The scales and B5 launches of one ``vgg_target_taps_q8`` call (or of
    the ``num_stages`` encode of a SANet stylize)."""
    _, qconvs, program, _ = _vgg_q8_layers(vgg, num_stages, torch.float32)
    return _chain_plan(qconvs, program)


def calibrate_vgg_targets_q8(vgg: VGG19Encoder, content,
                             style) -> Dict[str, np.ndarray]:
    """Activation scales of the no-grad VGG loss-target encode of
    ``train_q8_targets``: the encoder is frozen, so one bfloat16 absmax pass
    over a representative batch fixes them for the whole run."""
    with torch.inference_mode():
        st = _ScaleStream()
        _vgg_encode_q8(vgg, torch.cat([style, content], dim=0), 4,
                       torch.bfloat16, None, st)
        return _scales_from(st.absmax)


def vgg_target_taps_q8(vgg: VGG19Encoder, scales, imgs,
                       dtype: torch.dtype = torch.bfloat16):
    """[relu1_1 .. relu4_1] of ``imgs`` (N, H, W, 3), H and W multiples of
    8, through the chained-int8 encoder: the training loss's style and
    content targets. They carry no gradient, so int8 perturbs target values
    only, never the backward path. Every eligible layer runs on B5."""
    st = _ScaleStream(scales["act_scales"])
    with torch.no_grad():
        return _vgg_encode_q8(vgg, imgs.detach(), 4, dtype,
                              make_conv_q(dtype, "reflect"), st)


# ---------------------------------------------------------------------------
# static SANet: int8 VGG encode, attention in the working type, int8 decode
# ---------------------------------------------------------------------------

# the VGG-mirror decoder's program (nn/decoder.py): (pre, act) per conv
_MIRROR_PROGRAM = [("up" if i in MIRROR_UP_BEFORE else None, i != 8)
                   for i in range(9)]


def sanet_blocks(model: SAModel, dtype: torch.dtype) -> Dict[str, object]:
    """The trained weights of a static SANet in ``dtype``, detached:
    ``sanet4_1`` / ``sanet5_1`` (the f, g, h, out_conv (weight, bias)
    pairs), ``merge`` and the ``decoder`` conv list."""
    def pair(conv):
        return (conv.weight.detach().to(dtype), conv.bias.detach().to(dtype))
    t = model.transform
    return {"sanet4_1": [pair(m) for m in (t.sanet4_1.f, t.sanet4_1.g,
                                           t.sanet4_1.h, t.sanet4_1.out_conv)],
            "sanet5_1": [pair(m) for m in (t.sanet5_1.f, t.sanet5_1.g,
                                           t.sanet5_1.h, t.sanet5_1.out_conv)],
            "merge": pair(t.merge_conv.Conv_0),
            "decoder": [pair(c) for c in model.decoder.convs()]}


def sanet_q8_plan(vgg: VGG19Encoder, qdec: QConvs) -> Dict[str, int]:
    """What one ``stylize_sanet_q8`` runs: the act scales it consumes, its
    B5 launches (the 5-stage encode of the 2N batch, then the decoder) and
    its two B6 launches (the relu4_1 and relu5_1 attention modules)."""
    enc, dec = vgg_q8_plan(vgg, 5), _chain_plan(qdec, _MIRROR_PROGRAM)
    return {"scales": enc["scales"] + dec["scales"],
            "B5": enc["B5"] + dec["B5"], "B6": 2}


def _mirror_decode_q8(dec: Convs, qdec: QConvs, x, dtype, conv_q, st):
    """The VGG-mirror decoder with its eligible convs int8; the last conv
    has no activation and stays float."""
    out, _ = _conv_chain_q8(dec, qdec, _MIRROR_PROGRAM, x, dtype, conv_q, st)
    return out


def _sanet_transform(blocks, feats, n: int, attention: Attention):
    """The attention transform on the 2N-batched relu4_1 / relu5_1 taps, in
    their (the working) type: the port's ``Transform`` on detached weights,
    attention on B6. NHWC in and out."""
    c4, s4 = feats[3][:n], feats[3][n:]
    c5, s5 = feats[4][:n], feats[4][n:]
    a4 = sanet_attention_block(c4, s4, *blocks["sanet4_1"],
                               attention=attention)
    a5 = sanet_attention_block(c5, s5, *blocks["sanet5_1"],
                               attention=attention)
    return _reflect_conv(a4 + _upsample2x_any(a5), *blocks["merge"],
                         act=False)


def _sanet_q8_pass(vgg, blocks, qdec, content, style, st, dtype, conv_q,
                   attention: Attention = sanet_attention):
    n = content.shape[0]
    feats = _vgg_encode_q8(vgg, torch.cat([content, style], dim=0), 5, dtype,
                           conv_q, st)
    fusion = _sanet_transform(blocks, feats, n, attention)
    return _mirror_decode_q8(blocks["decoder"], qdec, fusion.to(dtype), dtype,
                             conv_q, st)


def calibrate_sanet_q8(vgg: VGG19Encoder, blocks, qdec: QConvs, content,
                       style) -> Dict[str, np.ndarray]:
    """One calibration pass -> {'act_scales'} for ``stylize_sanet_q8``: the
    same code path with a recording stream, in the type of ``blocks`` (rpst
    calibrates in bfloat16). It launches none of the int8 kernels; its two
    attention modules run on B6."""
    with torch.inference_mode():
        st = _ScaleStream()
        _sanet_q8_pass(vgg, blocks, qdec, content, style, st,
                       blocks["merge"][0].dtype, None)
        return _scales_from(st.absmax)


def stylize_sanet_q8(vgg: VGG19Encoder, blocks, qdec: QConvs, scales, content,
                     style, dtype: torch.dtype = torch.bfloat16,
                     attention: Attention = sanet_attention) -> torch.Tensor:
    """Int8 static-SANet serving: the chained-int8 5-stage VGG encode of
    both images (one 2N batch), the attention transform in ``dtype``, the
    int8 VGG-mirror decode. ``blocks``: ``sanet_blocks`` in ``dtype``;
    ``qdec``: ``quantize_convs`` of the float32 decoder; content, style (N,
    H, W, 3) with H, W multiples of 16 (four exact 2x2 pools).
    ``attention`` replaces B6's public function (a benchmark times the plain
    version or a library call in its place)."""
    want = sanet_q8_plan(vgg, qdec)["scales"]
    if len(scales["act_scales"]) != want:
        raise ValueError(f"{len(scales['act_scales'])} act scales for a model "
                         f"that consumes {want}: calibrate this model")
    st = _ScaleStream(scales["act_scales"])
    out = _sanet_q8_pass(vgg, blocks, qdec, content, style, st, dtype,
                         make_conv_q(dtype, "reflect"), attention)
    return out.to(content.dtype)
