"""Host-side image IO of the port; counterpart of ``rpst.data.transforms``
and, for training, of ``rpst.data``'s ``ImageFolderDataset``,
``InfiniteSampler`` and ``InfiniteLoader``.

The reference transform is a bilinear squash to ``img_size`` x ``img_size``
and a [0, 1] float, with no mean/std normalization. rpst decodes with a
native libjpeg/libpng path that is bit-exact with PIL; here PIL alone does
it, so the bytes are the same.
"""

from __future__ import annotations

import threading
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


# ---------------------------------------------------------------- training

class ImageFolderDataset:
    """The images matching ``fmt`` under ``root``, sorted, each loaded with
    ``load_image`` (rpst's ``ImageFolderDataset``; the reference's ``*`` for
    content folders and ``*/*`` for wikiart-style subfolders)."""

    def __init__(self, root, img_size: int, fmt: str = "*"):
        self.root = root
        self.paths = sorted(Path(root).glob(fmt))
        self.img_size = img_size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        return load_image(self.paths[index], self.img_size)


def InfiniteSampler(n: int, seed=None):
    """Endless stream of indices, a fresh permutation each epoch, the same
    stream as rpst's ``InfiniteSampler`` for the same seed. The reference
    starts at ``i = n - 1`` of the first permutation, so the first epoch
    yields one element before reshuffling: kept."""
    rng = np.random.default_rng(seed)
    i = n - 1
    order = rng.permutation(n)
    while True:
        yield int(order[i])
        i += 1
        if i >= n:
            order = rng.permutation(n)
            i = 0


class InfiniteLoader:
    """Endless stream of stacked (B, H, W, 3) float32 batches from a
    map-style dataset, decoded by ``num_workers`` threads (PIL releases the
    GIL) at most ``prefetch`` batches ahead.

    Unlike rpst's loader, batches come out in sampler order whatever the
    number of workers, so a seed fixes the stream; ``skip`` drops that many
    batches' indices first (no decoding), so a resumed run continues the
    stream where it stopped. A worker's error is raised by ``next``."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 seed=None, prefetch: int = 4, skip: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = max(1, prefetch)
        self._sampler = InfiniteSampler(len(dataset), seed)
        for _ in range(skip * batch_size):
            next(self._sampler)
        self._cond = threading.Condition()
        self._next_seq = 0   # the next batch handed to a worker
        self._out_seq = 0    # the next batch ``next`` returns
        self._ready: dict = {}
        self._stop = False
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, num_workers))]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            with self._cond:
                while (not self._stop and self._next_seq - self._out_seq
                       >= self.prefetch):
                    self._cond.wait()
                if self._stop:
                    return
                seq = self._next_seq
                self._next_seq += 1
                idx = [next(self._sampler) for _ in range(self.batch_size)]
            try:
                batch = np.stack([self.dataset[i] for i in idx])
            except Exception as e:  # handed to the consumer, raised there
                batch = e
            with self._cond:
                self._ready[seq] = batch
                self._cond.notify_all()

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        with self._cond:
            while self._out_seq not in self._ready:
                self._cond.wait()
            batch = self._ready.pop(self._out_seq)
            self._out_seq += 1
            self._cond.notify_all()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def close(self, timeout: float = 30.0):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout)
