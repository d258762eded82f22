"""The port's native image decoder (``rpst_torch.native_io``, built from
``src/rpst_torch/csrc/host/imageio.cpp``) against PIL and against rpst's
(``rpst.data.native_io``) byte for byte, on the cases of
tests/test_native_io.py with its parametrisation; ``rpst_torch.data.
load_image`` takes the native route, a declined file comes back through
PIL, ``RPST_NATIVE_IO=0`` switches it off, and the module imports neither
jax nor rpst."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rpst.data import native_io as rpst_native_io
from rpst_torch import data, native_io

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(not native_io.available(),
                                reason="native imageio lib unavailable")


def _pil_expected(path, img_size):
    img = Image.open(str(path)).convert("RGB")
    if img_size:
        img = img.resize((img_size, img_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def _check(path, img_size):
    """The port's decode equals PIL's and rpst's byte for byte."""
    got = native_io.load_image_native(path, img_size)
    assert got is not None
    np.testing.assert_array_equal(got, _pil_expected(path, img_size))
    np.testing.assert_array_equal(
        got, rpst_native_io.load_image_native(path, img_size))
    return got


def _structured(rng, h, w):
    """Random + gradients + sharp edges (stress the resample rounding)."""
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    arr[: h // 3] = np.linspace(0, 255, w, dtype=np.uint8)[None, :, None]
    arr[h // 3: h // 2, : w // 2] = 255
    arr[h // 3: h // 2, w // 2:] = 0
    return arr


@pytest.mark.parametrize("size", [(96, 64), (64, 96), (128, 128), (31, 57)])
@pytest.mark.parametrize("target", [64, 48, 200, 0])
def test_png_decode_resize_matches_pil_and_rpst(tmp_path, size, target):
    rng = np.random.default_rng(size[0] * 1000 + target)
    p = tmp_path / "img.png"
    Image.fromarray(_structured(rng, *size), "RGB").save(p)
    _check(p, target)


@pytest.mark.parametrize("quality", [95, 60])
def test_jpeg_decode_resize_matches_pil_and_rpst(tmp_path, quality):
    rng = np.random.default_rng(quality)
    p = tmp_path / "img.jpg"
    Image.fromarray(_structured(rng, 80, 120), "RGB").save(p, quality=quality)
    _check(p, 64)


def test_grayscale_and_palette_png(tmp_path):
    rng = np.random.default_rng(7)
    pg = tmp_path / "gray.png"
    Image.fromarray(rng.integers(0, 256, (40, 52), dtype=np.uint8),
                    "L").save(pg)
    _check(pg, 32)
    pp = tmp_path / "pal.png"
    Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8),
                    "RGB").convert("P", palette=Image.ADAPTIVE).save(pp)
    _check(pp, 32)


def test_rgba_png_drops_alpha_like_pil_convert(tmp_path):
    rng = np.random.default_rng(9)
    p = tmp_path / "rgba.png"
    Image.fromarray(rng.integers(0, 256, (33, 47, 4), dtype=np.uint8),
                    "RGBA").save(p)
    _check(p, 24)


def test_load_image_routes_through_native(tmp_path, monkeypatch):
    """data.load_image returns the native decode (PIL is not called) and
    equals PIL's bytes."""
    rng = np.random.default_rng(3)
    p = tmp_path / "x.png"
    Image.fromarray(rng.integers(0, 256, (50, 70, 3), np.uint8), "RGB").save(p)
    expected = _pil_expected(p, 48)

    def no_pil(*a, **k):
        raise AssertionError("PIL decoded a file the native path takes")
    monkeypatch.setattr(data.Image, "open", no_pil)
    np.testing.assert_array_equal(data.load_image(p, 48), expected)


def test_unsupported_falls_back(tmp_path):
    """A non-JPEG/PNG file: the native path declines, as rpst's does, and
    load_image returns PIL's bytes."""
    rng = np.random.default_rng(4)
    p = tmp_path / "x.bmp"
    Image.fromarray(rng.integers(0, 256, (20, 20, 3), np.uint8), "RGB").save(p)
    assert native_io.load_image_native(p, 16) is None
    assert rpst_native_io.load_image_native(p, 16) is None
    np.testing.assert_array_equal(data.load_image(p, 16), _pil_expected(p, 16))


def test_cmyk_jpeg_comes_back_through_pil(tmp_path):
    """A CMYK JPEG, which the library declines, comes back through PIL with
    PIL's bytes."""
    rng = np.random.default_rng(8)
    p = tmp_path / "cmyk.jpg"
    Image.fromarray(rng.integers(0, 256, (20, 24, 3), np.uint8),
                    "RGB").convert("CMYK").save(p)
    assert Image.open(p).mode == "CMYK"
    assert native_io.load_image_native(p, 16) is None
    np.testing.assert_array_equal(data.load_image(p, 16), _pil_expected(p, 16))


def test_image_size_probe(tmp_path):
    rng = np.random.default_rng(5)
    p = tmp_path / "x.png"
    Image.fromarray(rng.integers(0, 256, (21, 37, 3), np.uint8), "RGB").save(p)
    assert _check(p, 0).shape == (21, 37, 3)


def _fresh(code, flag, tmp_path):
    """``code`` in a fresh interpreter with ``RPST_NATIVE_IO=flag``, after
    loading a seeded 30x20 PNG ``a`` through rpst_torch.data.load_image."""
    p = tmp_path / "x.png"
    Image.fromarray(np.random.default_rng(6).integers(
        0, 256, (30, 20, 3), np.uint8), "RGB").save(p)
    head = ("import sys; sys.path.insert(0, 'src')\n"
            "import rpst_torch.metrics  # the port logger's handler\n"
            "from rpst_torch import data, native_io\n"
            f"a = data.load_image({str(p)!r}, 16)\n")
    proc = subprocess.run([sys.executable, "-c", head + code],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(REPO), env={**os.environ,
                                              "RPST_NATIVE_IO": flag})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc, _pil_expected(p, 16)


def test_switch_off_is_honoured(tmp_path):
    """``RPST_NATIVE_IO=0`` leaves PIL to decode: ``available()`` is False,
    ``reason()`` and the log say so, and the bytes are PIL's."""
    proc, expected = _fresh(
        "assert not native_io.available()\n"
        "print(native_io.reason()); print(a.tobytes().hex())\n", "0",
        tmp_path)
    why, got = proc.stdout.split()
    assert why == "RPST_NATIVE_IO=0"
    assert "image decoder: PIL (RPST_NATIVE_IO=0)" in proc.stderr
    assert bytes.fromhex(got) == expected.tobytes()


def test_module_imports_no_jax_or_rpst(tmp_path):
    """rpst_torch.native_io and rpst_torch.data, used, leave jax and rpst
    out of sys.modules (a fresh interpreter), and log the native decoder."""
    proc, _ = _fresh(
        "assert native_io.available(), native_io.reason()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'rpst')]\n"
        "assert not bad, bad\n", "1", tmp_path)
    assert "image decoder: native libjpeg / libpng" in proc.stderr
