"""The port's own config loader and image IO (rpst_torch.config,
rpst_torch.data) against rpst.config and rpst.data.transforms."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rpst.config import load_config as j_load_config
from rpst.data.transforms import load_image as j_load_image
from rpst.data.transforms import to_image as j_to_image
from rpst.data.transforms import to_u8 as j_to_u8
from rpst_torch.config import DEFAULTS, load_config
from rpst_torch.data import image_paths, load_image, to_image, to_u8

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
