"""Plain PyTorch pieces the configurations' references share: padded convs,
the feature statistics, the frozen VGG-19 encoder, the perceptual losses
and Adam with the reference lr schedule.

Written from the published descriptions (AdaIN, Huang & Belongie 2017;
SANet, Park & Lee 2019; the RP-Style-Transfer training loop), in float32,
NCHW inside, NHWC at the edges. Nothing here imports the program under
test (``rpst_torch``), JAX or the JAX package; weights come in as the state
dicts the benchmark made, by their key names.

``Precision`` says where a lower precision rounds, as a pipeline that
stores its tensors in that type would: both operands and the output of
every convolution and matrix product, and the per-channel statistics
(mean, std) with the normalizations built on them. "bf16" rounds to
bfloat16; "tf32" to TF32's 10-bit mantissa (round to nearest even);
"fp8" to float8 e4m3 with one scale per tensor (its absolute maximum at
448, the type's largest value). A configuration names the one whose error
on the same inputs is the unit of its checks (``own_precision``: the
stated compute type, or for float32 the TF32 that its convolutions may
run in) and its training control (``control.train``). The rounding is
straight-through under autograd. "f32" rounds nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
E4M3_MAX = 448.0
# (in, out) of each 3x3 conv of VGG-19 up to relu5_1, per stage; a 2x2
# ceil-mode max pool precedes the last conv of stages 2-5
VGG_STAGES = [
    [(3, 64)],
    [(64, 64), (64, 128)],
    [(128, 128), (128, 256)],
    [(256, 256), (256, 256), (256, 256), (256, 512)],
    [(512, 512), (512, 512), (512, 512), (512, 512)],
]


MODES = ("f32", "tf32", "bf16", "fp8")


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """A float32 tensor rounded to ``bits`` mantissa bits, to nearest
    even (the exponent range kept)."""
    drop = 23 - bits
    i = t.float().contiguous().view(torch.int32)
    half = (1 << (drop - 1)) - 1
    i = (i + half + ((i >> drop) & 1)) & ~((1 << drop) - 1)
    return i.view(torch.float32).to(t.dtype)


class Precision:
    """The arithmetic of a reference: "f32" (float32, TF32 off: the caller
    sets ``torch.backends`` so), or one of ``MODES`` rounded where the
    module docstring says."""

    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return t
        if self.mode == "bf16":
            q = t.to(torch.bfloat16).to(t.dtype)
        elif self.mode == "tf32":
            q = round_mantissa(t.detach(), 10)
        else:
            scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
            q = (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (q - t).detach()


F32 = Precision()


def conv(x, w, b, pad: int, prec: Precision, mode: str = "reflect"):
    """A stride-1 conv of an NCHW tensor after ``pad`` rows and columns of
    ``mode`` padding."""
    if pad:
        x = F.pad(x, (pad, pad, pad, pad), mode=mode)
    return prec(F.conv2d(prec(x), prec(w), b))


def matmul(a, b, prec: Precision):
    return prec(torch.matmul(prec(a), prec(b)))


def mean_std(feat: torch.Tensor, prec: Precision = F32, eps: float = 1e-5):
    """Per (N, C) mean and std over H, W of an NCHW tensor: the unbiased
    variance, eps inside the root."""
    n, c = feat.shape[:2]
    flat = feat.reshape(n, c, -1)
    mean = flat.mean(dim=2)
    var = flat.var(dim=2, unbiased=True)
    return (prec(mean[:, :, None, None]),
            prec((var + eps).sqrt()[:, :, None, None]))


def adain(content: torch.Tensor, style: torch.Tensor,
          prec: Precision = F32) -> torch.Tensor:
    cm, cs = mean_std(content, prec)
    sm, ss = mean_std(style, prec)
    return prec((content - cm) / cs * ss + sm)


def mean_variance_norm(feat: torch.Tensor,
                       prec: Precision = F32) -> torch.Tensor:
    m, s = mean_std(feat, prec)
    return prec((feat - m) / s)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def style_stat_loss(a: torch.Tensor, b: torch.Tensor,
                    prec: Precision = F32) -> torch.Tensor:
    am, asd = mean_std(a, prec)
    bm, bsd = mean_std(b, prec)
    return mse(am, bm) + mse(asd, bsd)


def vgg_features(vgg: Weights, x_nhwc: torch.Tensor, stages: int,
                 prec: Precision) -> List[torch.Tensor]:
    """[relu1_1 .. relu{stages}_1], NCHW: the 1x1 normalization head (no
    activation), then reflect-padded 3x3 convs with ReLU."""
    def w(i):
        return vgg[f"conv_{i}.Conv_0.weight"], vgg[f"conv_{i}.Conv_0.bias"]
    x = conv(x_nhwc.permute(0, 3, 1, 2), *w(0), 0, prec)
    idx, feats = 1, []
    for stage in range(stages):
        convs = VGG_STAGES[stage]
        for j in range(len(convs)):
            if stage > 0 and j == len(convs) - 1:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            x = F.relu(conv(x, *w(idx), 1, prec))
            idx += 1
        feats.append(x)
    return feats


def lr_at(lr: float, lr_decay: float, count: int) -> float:
    """The reference schedule: lr / (1 + lr_decay (count + 1)), ``count``
    the updates applied so far."""
    return lr / (1.0 + lr_decay * (count + 1.0))


def adam_steps(params: Weights, loss_fn: Callable, batches: Sequence,
               lr: float, lr_decay: float, betas=(0.9, 0.999),
               eps: float = 1e-8):
    """Adam (bias-corrected, default betas and eps) over ``batches`` from
    ``params``: (each step's loss, the first step's gradients, the
    parameters after the last step, the first step's loss parts).
    ``loss_fn(params, content, style)`` returns the loss parts, the
    weighted sum under ``total_loss``."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first, parts1 = [], None, None
    for t, (content, style) in enumerate(batches, start=1):
        parts = loss_fn(p, content, style)
        loss = parts["total_loss"]
        if parts1 is None:
            parts1 = {k: float(v.detach()) for k, v in parts.items()}
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(p, grads)}
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        step = lr_at(lr, lr_decay, t - 1)
        with torch.no_grad():
            for k in p:
                m[k].mul_(betas[0]).add_(grads[k], alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(grads[k], grads[k],
                                              value=1 - betas[1])
                mhat = m[k] / (1 - betas[0] ** t)
                vhat = v2[k] / (1 - betas[1] ** t)
                p[k].sub_(step * mhat / (vhat.sqrt() + eps))
        del loss, parts, grads
    return losses, first, {k: t.detach() for k, t in p.items()}, parts1


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def pair(weights: Weights, prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return weights[prefix + ".weight"], weights[prefix + ".bias"]
