"""The port's own config loader, image IO and training data pipeline
(rpst_torch.config, rpst_torch.data) against rpst.config and rpst.data."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rpst.config import load_config as j_load_config
from rpst.data.datasets import ImageFolderDataset as JImageFolderDataset
from rpst.data.sampler import InfiniteSampler as JInfiniteSampler
from rpst.data.transforms import load_image as j_load_image
from rpst.data.transforms import to_image as j_to_image
from rpst.data.transforms import to_u8 as j_to_u8
from rpst_torch.config import DEFAULTS, load_config
from rpst_torch.data import (ImageFolderDataset, InfiniteLoader,
                             InfiniteSampler, image_paths, load_image,
                             to_image, to_u8)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_matches_rpst(path):
    """Every rpst config loads here to the same values of the keys the port
    reads, and keeps the keys it does not read."""
    ours, ref = load_config(path), j_load_config(path)
    for key in DEFAULTS:
        assert ours[key] == ref[key], key
    user = set(ref.as_dict()) - set(j_load_config({}).as_dict())
    assert user <= set(ours.as_dict())


def test_config_overrides_and_validation():
    cfg = load_config({"rp_blocks": 3, "attention": None, "seed": None},
                      {"exec_strategy": "folded"})
    ref = j_load_config({"rp_blocks": 3, "attention": None, "seed": None},
                        {"exec_strategy": "folded"})
    for key in DEFAULTS:
        assert cfg[key] == ref[key], key
    assert cfg.replace(hidden_dim=8).hidden_dim == 8 and cfg.hidden_dim == 32
    for bad in ({"network": "nope"}, {"rp_blocks": 1},
                {"enc_stack_way": "x"}, {"attention": "cbam"}):
        with pytest.raises(ValueError):
            load_config(bad)
        with pytest.raises(ValueError):
            j_load_config(bad)


@pytest.mark.parametrize("size,img_size", [((40, 24), 32), ((32, 32), 0),
                                           ((17, 50), 16)])
def test_load_image_matches_rpst(tmp_path, size, img_size):
    rng = np.random.default_rng(sum(size) + img_size)
    path = tmp_path / "x.png"
    Image.fromarray(rng.integers(0, 256, (*size, 3), np.uint8),
                    "RGB").save(path)
    got, ref = load_image(path, img_size), j_load_image(path, img_size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_u8_and_image_conversion_match_rpst():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_u8(x), j_to_u8(x))
    for a in (x, x[0], to_u8(x[0])):
        np.testing.assert_array_equal(np.asarray(to_image(a)),
                                      np.asarray(j_to_image(a)))


def test_image_paths(tmp_path):
    for name in ("b.png", "a.jpg"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "sub").mkdir()
    assert [p.name for p in image_paths(tmp_path)] == ["a.jpg", "b.png"]
    assert image_paths(tmp_path / "b.png") == [tmp_path / "b.png"]


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("n,seed", [(5, 0), (1, 3), (8, 11)])
def test_sampler_stream_matches_rpst(n, seed):
    """Three epochs (and the reference's one-element first epoch)."""
    ours, ref = InfiniteSampler(n, seed), JInfiniteSampler(n, seed)
    assert [next(ours) for _ in range(3 * n + 1)] == \
        [next(ref) for _ in range(3 * n + 1)]


@pytest.fixture
def folder(tmp_path):
    rng = np.random.default_rng(1)
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (20, 24, 3), np.uint8),
                            "RGB").save(tmp_path / sub / f"{i}.png")
    return tmp_path


@pytest.mark.parametrize("fmt,root", [("*/*", ""), ("*", "a")])
def test_image_folder_dataset_matches_rpst(folder, fmt, root):
    ours = ImageFolderDataset(folder / root, 16, fmt)
    ref = JImageFolderDataset(folder / root, 16, fmt)
    assert ours.paths == ref.paths and len(ours) == len(ref) > 0
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours[i], ref[i])


def test_loader_keeps_sampler_order_and_skips(folder):
    """Batches come out in sampler order whatever the worker count, and
    ``skip`` continues the stream of an earlier loader."""
    ds = ImageFolderDataset(folder, 8, "*/*")
    sampler = InfiniteSampler(len(ds), 5)
    want = [np.stack([ds[next(sampler)] for _ in range(2)])
            for _ in range(6)]
    loader = InfiniteLoader(ds, 2, num_workers=4, seed=5, prefetch=2)
    skipped = InfiniteLoader(ds, 2, num_workers=2, seed=5, skip=3)
    try:
        for w in want:
            np.testing.assert_array_equal(next(loader), w)
        for w in want[3:]:
            np.testing.assert_array_equal(next(skipped), w)
    finally:
        loader.close()
        skipped.close()
    assert not any(t.is_alive() for t in loader._threads + skipped._threads)


def test_loader_raises_a_worker_error(folder):
    class Broken(ImageFolderDataset):
        def __getitem__(self, index):
            raise OSError("truncated file")

    loader = InfiniteLoader(Broken(folder, 8, "*/*"), 2, num_workers=1,
                            seed=0)
    try:
        with pytest.raises(OSError, match="truncated"):
            next(loader)
    finally:
        loader.close()
