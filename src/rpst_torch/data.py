"""Host-side image IO of the port; counterpart of ``rpst.data.transforms``
(``load_image``, ``load_mask``), for training of ``rpst.data``'s
``ImageFolderDataset``, ``FlatFolderDataset``, ``CityscapesDataset`` (with
``convert_label``), ``InfiniteSampler`` and ``InfiniteLoader``, and for
the test dumps of its test datasets (``PairedDataset``,
``PhotorealisticPairedDataset`` with its ``labelme_segmentation/`` masks,
``IdentityDataset``, ``FmtDataset``, ``build_test_dataset``) and
``iter_batches``.

The reference transform is a bilinear squash to ``img_size`` x ``img_size``
and a [0, 1] float, with no mean/std normalization. ``load_image`` decodes
through the native libjpeg / libpng decoder (``native_io``, bit-exact with
PIL) and through PIL where that declines the file or did not build, as
rpst's does: the bytes are the same either way.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import numpy as np
from PIL import Image, ImageFile

from . import native_io

Image.MAX_IMAGE_PIXELS = None
ImageFile.LOAD_TRUNCATED_IMAGES = True


def load_image(path, img_size: int) -> np.ndarray:
    """Load -> RGB -> (img_size, img_size) bilinear squash -> f32 HWC in
    [0, 1]; ``img_size`` 0 keeps the image's size. The native decoder
    first, PIL for what it declines."""
    arr = native_io.load_image_native(path, img_size)
    if arr is not None:
        return arr
    img = Image.open(str(path)).convert("RGB")
    if img_size:
        img = img.resize((img_size, img_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def load_mask(path, img_size: int) -> np.ndarray:
    """Segmentation mask -> (img_size, img_size) int32 label map: a
    nearest resize (labels are not interpolated), the first channel of a
    multi-channel file."""
    img = Image.open(str(path))
    if img_size:
        img = img.resize((img_size, img_size), Image.NEAREST)
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.int32)


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


class FlatFolderDataset(ImageFolderDataset):
    """The reference's ``FlatFolderDataset`` (``datasets/base.py:7-28``):
    the images matching ``fmt`` (default ``*/P*``), then ``root2``'s files,
    each set sorted."""

    def __init__(self, root, img_size: int, fmt: str = "*/P*", root2=None):
        super().__init__(root, img_size, fmt)
        if root2 is not None:
            self.paths.extend(sorted(Path(root2).glob("*")))


class FmtDataset(ImageFolderDataset):
    """The reference's ``FmtDataset`` (``datasets/base.py:168-185``): the
    images matching ``fmt``."""


# ---------------------------------------------------------------- test sets
# Each item is the reference's 6-tuple (content, style, content name, style
# name, content mask, style mask); the masks are decoded label maps (or
# None) where the reference passed their paths into the model.

class PairedDataset:
    """``content/`` and ``style/`` subfolders matched by file name
    (``datasets/base.py:51-86``)."""

    def __init__(self, root, img_size: int):
        self.root = root
        self.content_dir = os.path.join(root, "content")
        self.style_dir = os.path.join(root, "style")
        self.content_names = sorted(os.listdir(self.content_dir))
        self.img_size = img_size

    def __len__(self):
        return len(self.content_names)

    def _names(self, index):
        cname = self.content_names[index]
        return cname, cname

    def __getitem__(self, index):
        cname, sname = self._names(index)
        content = load_image(os.path.join(self.content_dir, cname),
                             self.img_size)
        style = load_image(os.path.join(self.style_dir, sname), self.img_size)
        return (content, style, os.path.splitext(cname)[0],
                os.path.splitext(sname)[0], None, None)


class PhotorealisticPairedDataset(PairedDataset):
    """``in{k}`` contents paired with ``tar{k}`` styles, their masks
    ``labelme_segmentation/<name>.png`` where present
    (``datasets/base.py:89-131``)."""

    def __init__(self, root, img_size: int, max_labels: int = 64):
        super().__init__(root, img_size)
        self.seg_dir = os.path.join(root, "labelme_segmentation")
        self.max_labels = max_labels

    def _names(self, index):
        cname = self.content_names[index]
        return cname, "tar{}".format(cname.replace("in", ""))

    def _mask(self, name: str):
        path = os.path.join(self.seg_dir, f"{os.path.splitext(name)[0]}.png")
        if not os.path.exists(path):
            return None
        return load_mask(path, self.img_size)

    def __getitem__(self, index):
        cname, sname = self._names(index)
        content = load_image(os.path.join(self.content_dir, cname),
                             self.img_size)
        style = load_image(os.path.join(self.style_dir, sname), self.img_size)
        return (content, style, os.path.splitext(cname)[0],
                os.path.splitext(sname)[0], self._mask(cname),
                self._mask(sname))


class IdentityDataset(PhotorealisticPairedDataset):
    """The reconstruction check: the style is the content
    (``datasets/base.py:134-165``)."""

    def __getitem__(self, index):
        cname, sname = self._names(index)
        content = load_image(os.path.join(self.content_dir, cname),
                             self.img_size)
        mask = self._mask(cname)
        return (content, content, os.path.splitext(cname)[0],
                os.path.splitext(sname)[0], mask, mask)


def build_test_dataset(cfg):
    """The test set of ``cfg.test_dataset`` under ``cfg.test_dir``
    (rpst's dispatch, reference ``train.py:150-157``)."""
    kind = cfg.test_dataset
    if kind == "photoreal":
        return PhotorealisticPairedDataset(cfg.test_dir, cfg.img_size,
                                           cfg.max_seg_labels)
    if kind == "iden_photoreal":
        return IdentityDataset(cfg.test_dir, cfg.img_size, cfg.max_seg_labels)
    if kind == "fmt":
        return FmtDataset(cfg.test_dir, cfg.img_size)
    if kind == "paired":
        return PairedDataset(cfg.test_dir, cfg.img_size)
    raise ValueError(f"unknown test_dataset {kind!r}")


def iter_batches(dataset, batch_size: int):
    """A test set in order, ``batch_size`` items at a time: (content,
    style) NHWC float32 arrays, the two name lists, and the (N, H, W)
    int32 masks of both sides, or None when the set has none."""
    n = len(dataset)
    for start in range(0, n, batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, n))]
        content = np.stack([it[0] for it in items])
        style = np.stack([it[1] for it in items])
        c_names = [it[2] for it in items]
        s_names = [it[3] for it in items]
        if items[0][4] is not None:
            c_masks = np.stack([it[4] for it in items])
            s_masks = np.stack([it[5] for it in items])
        else:
            c_masks = s_masks = None
        yield content, style, c_names, s_names, c_masks, s_masks


_IGNORE = -1
# the 34 raw Cityscapes ids -> the 19 train ids, -1 ignored
# (datasets/cityspaces.py:36-49)
CITYSCAPES_LABEL_MAPPING = {
    -1: _IGNORE, 0: _IGNORE, 1: _IGNORE, 2: _IGNORE, 3: _IGNORE, 4: _IGNORE,
    5: _IGNORE, 6: _IGNORE, 7: 0, 8: 1, 9: _IGNORE, 10: _IGNORE, 11: 2,
    12: 3, 13: 4, 14: _IGNORE, 15: _IGNORE, 16: _IGNORE, 17: 5, 18: _IGNORE,
    19: 6, 20: 7, 21: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14,
    28: 15, 29: _IGNORE, 30: _IGNORE, 31: 16, 32: 17, 33: 18,
}
# ids 0..255 -> train ids; an id outside the mapping keeps its value, as
# the reference's in-place remap touches only mapped keys
_LUT = np.arange(256, dtype=np.int32)
for _k, _v in CITYSCAPES_LABEL_MAPPING.items():
    if _k >= 0:
        _LUT[_k] = _v


def convert_label(label: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Raw ids -> train ids (``inverse``: train ids -> raw ids)."""
    if not inverse:
        return _LUT[label.astype(np.int32).clip(0, 255)]
    out = label.copy()
    for k, v in CITYSCAPES_LABEL_MAPPING.items():
        out[label == v] = k
    return out


class CityscapesDataset:
    """(content, label) pairs from side-by-side images, the sorted files of
    ``img_dir`` (rpst's ``CityscapesDataset``, reference
    ``datasets/cityspaces.py:28-84``): columns [0, s) are the content,
    squashed to (s, s) float32 in [0, 1]; columns [s, 2s) are the label,
    kept at the file's height, its ITU-R 601 luma rounded to an id and
    mapped by ``convert_label`` (int32, -1 ignored)."""

    def __init__(self, img_dir, img_size: int = 256):
        self.img_dir = img_dir
        self.img_names = sorted(os.listdir(img_dir))
        self.img_size = img_size

    def __len__(self):
        return len(self.img_names)

    def __getitem__(self, index):
        path = os.path.join(self.img_dir, self.img_names[index])
        img = np.asarray(Image.open(path).convert("RGB"))
        s = self.img_size
        label_rgb = img[:, s:2 * s, :]
        label = np.round(label_rgb[..., 0] * 0.299 + label_rgb[..., 1] * 0.587
                         + label_rgb[..., 2] * 0.114).astype(np.int32)
        content = Image.fromarray(img[:, :s, :]).resize((s, s),
                                                        Image.BILINEAR)
        return (np.asarray(content, np.float32) / 255.0,
                convert_label(label))


def collate(items):
    """Stack a batch of samples: arrays, or tuples of arrays field by
    field."""
    if isinstance(items[0], tuple):
        return tuple(np.stack(field) for field in zip(*items))
    return np.stack(items)


def InfiniteSampler(n: int, seed=None, shard_index: int = 0,
                    shard_count: int = 1):
    """Endless stream of indices, a fresh permutation each epoch, the same
    stream as rpst's ``InfiniteSampler`` for the same seed. The reference
    starts at ``i = n - 1`` of the first permutation, so the first epoch
    yields one element before reshuffling: kept.

    ``shard_index`` / ``shard_count`` (rpst ``sampler.py:8-27``): the
    stream positions congruent to ``shard_index`` modulo ``shard_count``
    of the same stream (the seed must match across ranks), so the ranks of
    a data-parallel run in lockstep draw the one-process stream between
    them, each a disjoint share."""
    if not 0 <= shard_index < shard_count:
        raise ValueError(f"shard_index {shard_index} outside [0, "
                         f"{shard_count})")
    rng = np.random.default_rng(seed)
    i = n - 1
    pos = 0  # the position in the whole stream
    order = rng.permutation(n)
    while True:
        if pos % shard_count == shard_index:
            yield int(order[i])
        pos += 1
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
    stream where it stopped. A worker's error is raised by ``next``. With
    ``with_indices`` it yields (dataset indices, batch), the keys of the
    target cache (``train.target_cache``), as rpst's loader does. A dataset
    of (content, label) pairs (``CityscapesDataset``) yields a tuple of two
    stacked batches. ``shard_index`` / ``shard_count`` pass to the sampler
    (a data-parallel rank's share of the stream, ``batch_size`` its share of
    the batch)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 seed=None, prefetch: int = 4, skip: int = 0,
                 with_indices: bool = False, shard_index: int = 0,
                 shard_count: int = 1):
        self.dataset = dataset
        self.with_indices = with_indices
        self.batch_size = batch_size
        self.prefetch = max(1, prefetch)
        self._sampler = InfiniteSampler(len(dataset), seed, shard_index,
                                        shard_count)
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
                batch = collate([self.dataset[i] for i in idx])
                if self.with_indices:
                    batch = (tuple(idx), batch)
            except Exception as e:  # handed to the consumer, raised there
                batch = e
            with self._cond:
                self._ready[seq] = batch
                self._cond.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
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
