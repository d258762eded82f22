"""Inputs and weights made from ``--seed``: the same seed gives the same
image pools, request styles, training batches and weights.

Images are drawn on the device in a few large calls: noise at four scales
(4, 16, 64 and full resolution), upsampled bilinearly, summed, given a
contrast (x 0.1 .. 3) and a brightness (-2.5 .. 2.5 before the squash) of
their own, from flat and dark to contrasty and bright, as photographs
differ, and squashed
into [0, 1], so each image has structure at several scales (edges, blobs,
texture) and not only pixel noise. They come back to the host as (n, H, W,
3) float32, the layout ``rpst_torch.data.load_image`` yields, and are not
decoded per request.

Weights are one uniform draw of every leaf at once, on the device, scaled
per leaf by the configuration's rule:

  * "he_3x3": the model's spatial convs He-uniform U(+-sqrt(6 / fan_in)),
    so that a deep ReLU stack keeps its scale as a trained one does and
    each image's output depends on its input; 1x1 convs and linears (the
    attention's projections) at PyTorch's default U(+-1/sqrt(fan_in)), so
    that the softmax's logits keep a trained network's temperature; conv
    biases U(+-1/sqrt(fan_in)), linear biases zero;
  * "he": every kernel He-uniform, biases U(+-0.01): the frozen VGG, whose
    deep taps keep their scale as a trained VGG's do.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# stream ids: one generator per purpose, so that adding a draw to one
# purpose moves no other
CONTENT, STYLE, MODEL, VGG, ORDER = 1, 2, 3, 4, 5
_SCALES = (4, 16, 64)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 8 + stream) % (2 ** 63))
    return g


def rng(seed: int, stream: int) -> np.random.Generator:
    """The host generator of one purpose (orders and draws of indices)."""
    return np.random.default_rng([int(seed) % (2 ** 64), stream])


def image_pool(n: int, size: int, seed: int, stream: int,
               device) -> np.ndarray:
    """(n, size, size, 3) float32 in [0, 1] on the host."""
    g = _generator(seed, stream, device)
    x = torch.randn((n, 3, size, size), generator=g, device=device) * 0.5
    for s in _SCALES:
        if s < size:
            low = torch.randn((n, 3, s, s), generator=g, device=device)
            x = x + F.interpolate(low, size=(size, size), mode="bilinear",
                                  align_corners=False)
    gain = torch.rand((n, 1, 1, 1), generator=g, device=device) * 2.9 + 0.1
    shift = torch.rand((n, 1, 1, 1), generator=g, device=device) * 5 - 2.5
    x = torch.sigmoid(x * gain + shift)
    return x.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def pools(traffic: dict, size: int, seed: int,
          device) -> Tuple[np.ndarray, np.ndarray]:
    """The mix's content and style pools."""
    return (image_pool(traffic["content_pool"], size, seed, CONTENT, device),
            image_pool(traffic["style_pool"], size, seed, STYLE, device))


def style_draws(seed: int, count: int, pool: int) -> np.ndarray:
    """Request (or row) i's style index, uniform over the pool."""
    return rng(seed, ORDER).integers(0, pool, size=count)


def _bounds(shapes: Dict[str, torch.Size], rule: str) -> Dict[str, float]:
    """Each leaf's half-width under ``rule`` ("he_3x3" or "he")."""
    if rule not in ("he", "he_3x3"):
        raise ValueError(f"unknown weight rule {rule!r}")
    out = {}
    for name, shape in shapes.items():
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            spatial = int(np.prod(shape[2:])) > 1
            out[name] = ((6.0 / fan_in) ** 0.5
                         if rule == "he" or spatial else fan_in ** -0.5)
    for name, shape in shapes.items():
        if len(shape) >= 2:
            continue
        weight = shapes[name.rsplit(".", 1)[0] + ".weight"]
        if rule == "he":
            out[name] = 0.01
        elif len(weight) == 2:
            out[name] = 0.0   # a Linear's bias starts at zero
        else:
            out[name] = int(np.prod(weight[1:])) ** -0.5
    return out


def seeded_weights(shapes: Iterable[Tuple[str, torch.Size]], rule: str,
                   seed: int, stream: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} from one uniform draw."""
    shapes = {k: torch.Size(v) for k, v in shapes}
    total = sum(int(np.prod(s)) for s in shapes.values())
    g = _generator(seed, stream, device)
    flat = torch.rand((total,), generator=g, device=device) * 2.0 - 1.0
    bounds = _bounds(shapes, rule)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        out[name] = (flat[at:at + n] * bounds[name]).reshape(shape)
        at += n
    return out
