"""The frozen VGG-19 perceptual encoder (``vgg_normalised`` layout); port of
``rpst.nn.vgg.VGG19Encoder`` (reference ``network/base.py:57-111``).

  * a leading 1x1 conv (3 -> 3, no activation) that bakes the RGB
    normalization into its weights;
  * reflection padding before every 3x3 conv;
  * ceil-mode 2x2/2 max pools;
  * taps at relu1_1 .. relu{num_stages}_1.

Module and parameter names follow the flax tree (``conv_{i}.Conv_0.weight``
and ``.bias``), so ``rpst_torch.bridge`` maps rpst's ``vgg_vars`` one to
one. Every parameter is frozen (``requires_grad`` False), as the reference
freezes it (``base.py:576-578``). Takes and returns NHWC tensors; NCHW
inside.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.folded import fold_bias, fold_conv_kernel
from .blocks import PadConv

# (in_ch, out_ch) of each 3x3 conv, grouped per stage; the 1x1 head is
# separate. A pool precedes the last conv of stages 2..5.
_STAGES = [
    [(3, 64)],
    [(64, 64), (64, 128)],
    [(128, 128), (128, 256)],
    [(256, 256), (256, 256), (256, 256), (256, 512)],
    [(512, 512), (512, 512), (512, 512), (512, 512)],
]

# torch nn.Sequential indices of the conv layers in vgg_normalised.pth
# (base.py:57-111), in the order [head] + the flattened _STAGES
_TORCH_CONV_INDICES = [0, 2, 5, 9, 12, 16, 19, 22, 25, 29, 32, 35, 38, 42]


def num_convs(num_stages: int) -> int:
    """The head plus the 3x3 convs up to relu{num_stages}_1."""
    return 1 + sum(len(_STAGES[s]) for s in range(num_stages))


def maxpool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool of an NCHW tensor with ceil_mode semantics."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class VGG19Encoder(nn.Module):
    """``forward(x)`` (N, H, W, 3) in [0, 1] -> [relu1_1, ...,
    relu{num_stages}_1], each NHWC (the reference's
    ``encode_with_intermediate``)."""

    def __init__(self, num_stages: int = 4, device=None, dtype=None):
        super().__init__()
        self.num_stages = num_stages
        specs = [(3, 3, 1, 0)] + [(i, o, 3, 1) for stage in
                                  _STAGES[:num_stages] for i, o in stage]
        for idx, (cin, cout, k, pad) in enumerate(specs):
            self.add_module(f"conv_{idx}", PadConv(
                cin, cout, k, pad, "reflect", device=device, dtype=dtype))
        self.requires_grad_(False)
        # (dtype, device) -> folded stage-1/2 weights (vgg_folded)
        self._folded: Dict[Tuple[torch.dtype, torch.device], list] = {}

    def conv(self, idx: int) -> nn.Conv2d:
        return getattr(self, f"conv_{idx}").Conv_0

    def load_state_dict(self, state_dict, strict: bool = True):
        self._folded.clear()
        return super().load_state_dict(state_dict, strict)

    def folded_weights(self, dtype: torch.dtype) -> List:
        """[(folded_kernel, folded_bias)] of conv_1..conv_4 in ``dtype``,
        for the folded stages 1-2; folded once per dtype and device (the
        encoder is frozen)."""
        key = (dtype, self.conv(1).weight.device)
        if key not in self._folded:
            # normal tensors even when first asked for under inference_mode:
            # the training step saves them for backward
            with torch.inference_mode(False):
                self._folded[key] = [
                    (fold_conv_kernel(self.conv(i).weight.permute(2, 3, 1, 0))
                     .to(dtype).contiguous(),
                     fold_bias(self.conv(i).bias).to(dtype).contiguous())
                    for i in range(1, 5)]
        return self._folded[key]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        idx = 0

        def conv(x):
            nonlocal idx
            y = getattr(self, f"conv_{idx}")(x)
            idx += 1
            return y

        feats = []
        x = conv(x)                 # normalization head, no activation
        x = F.relu(conv(x))         # relu1_1
        feats.append(x)
        for stage in range(2, self.num_stages + 1):
            specs = _STAGES[stage - 1]
            for j in range(len(specs)):
                if j == len(specs) - 1:
                    x = maxpool_ceil(x)
                x = F.relu(conv(x))
            feats.append(x)
        return [f.permute(0, 2, 3, 1) for f in feats]
