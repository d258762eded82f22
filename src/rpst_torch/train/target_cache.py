"""Device-resident cache of the perceptual loss targets; port of
``rpst.train.target_cache``.

The folded families' loss re-encodes both target images through the frozen
VGG on every step: the style image only for its relu1..4_1 (mean, std)
pairs, the content image only for its relu4_1 map. Neither depends on a
trainable parameter, and every image comes back once an epoch with the same
preprocessing (resize only), so the cache keeps each image's targets on the
device, keyed by its dataset index:

  * a style entry: four (mean, std) pairs, (64 + 128 + 256 + 512) x 2
    float32 values, 7.7 KB an image;
  * a content entry: relu4_1 (H/8, W/8, 512) in the folded type, 4.2 MB an
    image at 512px in bfloat16 (``content_slots`` is the memory knob).

A step whose style keys and content keys all hit gathers its targets by
slot index and runs one VGG sweep, the stylized pass that carries the
gradient. A step with any miss recomputes the targets of the whole batch,
exactly as the uncached step does, and writes them into their slots (rpst's
whole-batch rule). Slots are reused least recently used first. The stored
values are those the loss consumes, in its types (float32 statistics,
relu4_1 in the folded type), so a cached step computes what a recomputed
one does up to float reassociation.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..nn.vgg import VGG19Encoder
from ..nn.vgg_folded import ConvAct, vgg_perceptual_stats
from ..ops.folded_conv import folded_conv_act

STAGE_CHANNELS = (64, 128, 256, 512)
Targets = Tuple[List[Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]


def _gather(cache, idx: torch.Tensor):
    """The rows ``idx`` of every tensor of ``cache`` (a tensor, or a dict of
    tensor lists)."""
    if isinstance(cache, torch.Tensor):
        return cache.index_select(0, idx)
    return {k: [a.index_select(0, idx) for a in v] for k, v in cache.items()}


def _scatter(cache, idx: torch.Tensor, vals) -> None:
    """Write ``vals`` into the rows ``idx`` of ``cache``, in place."""
    if isinstance(cache, torch.Tensor):
        cache.index_copy_(0, idx, vals.to(cache.dtype))
        return
    for k, arrays in cache.items():
        for a, v in zip(arrays, vals[k]):
            a.index_copy_(0, idx, v.to(a.dtype))


class DeviceTargetCache:
    """LRU slot cache of the folded families' perceptual loss targets."""

    def __init__(self, img_size: int, dtype: torch.dtype = torch.bfloat16,
                 content_slots: int = 256, style_slots: int = 8192,
                 device: Any = "cpu"):
        if img_size % 8:
            raise ValueError("folded targets need img_size % 8 == 0")
        h8 = img_size // 8
        self.dtype = dtype
        self.device = torch.device(device)
        self.content_slots = int(content_slots)
        self.style_slots = int(style_slots)
        self._c_cache = torch.zeros((self.content_slots, h8, h8, 512),
                                    dtype=dtype, device=self.device)
        self._s_cache = {
            key: [torch.zeros((self.style_slots, c), dtype=torch.float32,
                              device=self.device) for c in STAGE_CHANNELS]
            for key in ("m", "s")}
        self._c_map: "OrderedDict[Any, int]" = OrderedDict()
        self._s_map: "OrderedDict[Any, int]" = OrderedDict()
        self.hit_steps = 0
        self.miss_steps = 0

    def nbytes(self) -> int:
        """Device bytes the slots hold."""
        tensors = [self._c_cache] + [a for v in self._s_cache.values()
                                     for a in v]
        return sum(t.numel() * t.element_size() for t in tensors)

    # -- host-side slot bookkeeping ------------------------------------
    @staticmethod
    def _touch(lru: OrderedDict, key) -> int:
        lru.move_to_end(key)
        return lru[key]

    @staticmethod
    def _assign(lru: OrderedDict, key, capacity: int) -> int:
        if key in lru:
            lru.move_to_end(key)
            return lru[key]
        if len(lru) < capacity:
            slot = len(lru)
        else:
            _, slot = lru.popitem(last=False)  # evict the LRU key, reuse its slot
        lru[key] = slot
        return slot

    def _index(self, slots: List[int]) -> torch.Tensor:
        return torch.tensor(slots, dtype=torch.long, device=self.device)

    # ------------------------------------------------------------------
    def targets_for_batch(self, vgg: VGG19Encoder, style: torch.Tensor,
                          content: torch.Tensor, s_keys: Sequence,
                          c_keys: Sequence,
                          conv_act: ConvAct = folded_conv_act) -> Targets:
        """(t_stats, t_relu4) of this batch for
        ``perceptual_rp_losses_folded_pretargets``: gathered from the slots
        when every style key and every content key hits, else recomputed for
        the whole batch (one 2N (style, content) pass of
        ``vgg_perceptual_stats``, the uncached step's) and written into the
        keys' slots."""
        if (all(k in self._s_map for k in s_keys)
                and all(k in self._c_map for k in c_keys)):
            self.hit_steps += 1
            sv = _gather(self._s_cache, self._index(
                [self._touch(self._s_map, k) for k in s_keys]))
            t_relu4 = _gather(self._c_cache, self._index(
                [self._touch(self._c_map, k) for k in c_keys]))
            return list(zip(sv["m"], sv["s"])), t_relu4

        self.miss_steps += 1
        n = style.shape[0]
        with torch.no_grad():
            stats, relu4 = vgg_perceptual_stats(
                vgg, torch.cat([style, content], dim=0), self.dtype,
                conv_act)
        t_stats = [(m[:n], s[:n]) for m, s in stats]
        t_relu4 = relu4[n:]
        s_idx = self._index([self._assign(self._s_map, k, self.style_slots)
                             for k in s_keys])
        c_idx = self._index([self._assign(self._c_map, k,
                                          self.content_slots)
                             for k in c_keys])
        _scatter(self._s_cache, s_idx, {"m": [m for m, _ in t_stats],
                                        "s": [s for _, s in t_stats]})
        _scatter(self._c_cache, c_idx, t_relu4)
        return t_stats, t_relu4

    def stats(self) -> Dict[str, int]:
        return {"hit_steps": self.hit_steps, "miss_steps": self.miss_steps,
                "content_cached": len(self._c_map),
                "style_cached": len(self._s_map)}
