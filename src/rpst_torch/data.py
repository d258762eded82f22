"""Host-side image IO of the port; counterpart of ``rpst.data.transforms``.

The reference transform is a bilinear squash to ``img_size`` x ``img_size``
and a [0, 1] float, with no mean/std normalization. rpst decodes with a
native libjpeg/libpng path that is bit-exact with PIL; here PIL alone does
it, so the bytes are the same.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image, ImageFile

Image.MAX_IMAGE_PIXELS = None
ImageFile.LOAD_TRUNCATED_IMAGES = True


def load_image(path, img_size: int) -> np.ndarray:
    """Load -> RGB -> (img_size, img_size) bilinear squash -> f32 HWC in
    [0, 1]; ``img_size`` 0 keeps the image's size."""
    img = Image.open(str(path)).convert("RGB")
    if img_size:
        img = img.resize((img_size, img_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def image_paths(path) -> list:
    """The files of a folder, sorted by name, or ``[path]`` for a file."""
    path = Path(path)
    return sorted(p for p in path.glob("*") if p.is_file()) \
        if path.is_dir() else [path]


def to_u8(arr) -> np.ndarray:
    """f32 [0, 1] -> uint8 with the save-side rounding (clip*255+0.5,
    floored); exact round trip for ``load_image`` outputs."""
    a = np.asarray(arr, np.float32)
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def to_image(array) -> Image.Image:
    """NHWC/HWC float in [0, 1] (clipped) or uint8 -> PIL RGB image."""
    arr = np.asarray(array)
    if arr.ndim == 4:
        arr = arr[0]
    return Image.fromarray(arr if arr.dtype == np.uint8 else to_u8(arr),
                           "RGB")
