#!/usr/bin/env python
"""Write a synthetic photoreal test set, the layout of rpst's
``PhotorealisticPairedDataset`` (``test_dataset: photoreal``), made from a
seed with numpy and PIL:

  <root>/content/in{k}.png, <root>/style/tar{k}.png: RGB noise, tinted per
      label region so that a masked AdaIN differs from a plain one;
  <root>/labelme_segmentation/in{k}.png and tar{k}.png: 8-bit label maps.

Every pair's label maps exercise the four cases of the masked AdaIN's
filter (``rpst_torch.ops.segment``), with ``max_labels`` the config's
``max_seg_labels``:
  * labels 0 and 1 hold large regions on both sides: they pass;
  * label 2 holds 9 content pixels (at most 10): it fails;
  * label 3 holds the content's bottom half and 12 style pixels (more than
    100x apart from 64px up): it fails;
  * ``max_labels + 1`` marks a 4 x 4 square on both sides: out of range,
    left untouched.

    python tools/make_photoreal_set.py <root> [--n 2] [--size 512]
                                              [--seed 0] [--max-labels 64]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from PIL import Image

_TINTS = np.array([(0.9, 0.3, 0.2), (0.2, 0.8, 0.3), (0.3, 0.3, 0.9),
                   (0.8, 0.8, 0.2)], np.float32)


def label_maps(size: int, rng, max_labels: int = 64):
    """(content, style) uint8 label maps of one pair (see the module doc)."""
    h = size // 2
    o = int(rng.integers(0, max(1, size // 16)))  # a per-pair shift
    content = np.full((size, size), 3, np.uint8)   # bottom half: label 3
    content[:h, :h + o] = 0
    content[:h, h + o:] = 1
    content[2:5, 2:5] = 2                          # 9 px: too small
    style = np.zeros((size, size), np.uint8)
    style[:, h - o:] = 1
    style[h:, h - o:] = 2
    style[h:h + 3, 2:6] = 3                        # 12 px against h * size
    for m in (content, style):
        m[size - 6:size - 2, size - 6:size - 2] = max_labels + 1
    return content, style


def _image(labels: np.ndarray, rng) -> np.ndarray:
    noise = rng.random(labels.shape + (3,), dtype=np.float32)
    tint = _TINTS[np.minimum(labels, len(_TINTS) - 1)]
    return (255 * (0.5 * noise + 0.5 * tint)).astype(np.uint8)


def make_photoreal_set(root, n: int = 2, size: int = 512, seed: int = 0,
                       max_labels: int = 64) -> Path:
    """Write ``n`` pairs under ``root``; returns ``root``."""
    if max_labels + 1 > 255:
        raise ValueError("label maps are 8-bit: max_labels <= 254")
    root = Path(root)
    dirs = {d: root / d for d in ("content", "style",
                                  "labelme_segmentation")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for k in range(n):
        c_lab, s_lab = label_maps(size, rng, max_labels)
        Image.fromarray(_image(c_lab, rng), "RGB").save(
            dirs["content"] / f"in{k}.png")
        Image.fromarray(_image(s_lab, rng), "RGB").save(
            dirs["style"] / f"tar{k}.png")
        Image.fromarray(c_lab, "L").save(
            dirs["labelme_segmentation"] / f"in{k}.png")
        Image.fromarray(s_lab, "L").save(
            dirs["labelme_segmentation"] / f"tar{k}.png")
    return root


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-labels", type=int, default=64)
    args = ap.parse_args()
    make_photoreal_set(args.root, args.n, args.size, args.seed,
                       args.max_labels)
    print(f"wrote {args.n} pairs under {args.root}")


if __name__ == "__main__":
    main()
