"""The port's test sets, image panels, visualizations and test-dump
drivers on the CPU against rpst's:

  * ``rpst_torch.data``'s ``load_mask``, ``PairedDataset``,
    ``PhotorealisticPairedDataset``, ``IdentityDataset``, ``FmtDataset``,
    ``build_test_dataset`` and ``iter_batches`` return what rpst's
    ``rpst.data`` returns on the same files (a synthetic photoreal set from
    ``tools/make_photoreal_set.py``);
  * ``metrics.save_image_row`` and ``viz``'s four writers write PNGs
    pixel-equal to rpst's (matplotlib's route where matplotlib is
    installed; the PIL route the GPU machine takes writes the same file
    names);
  * ``test_torch.py --device cpu`` and ``train_torch.py --device cpu`` with
    ``test_dir`` write the file names rpst's ``test.py`` and ``train.py``
    write on the same config (both run here), and dynamic_sanet's claim
    maps; ``test_torch.py --device cuda`` without a card exits non-zero.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

from rpst import viz as jviz
from rpst.config import load_config as j_load_config
from rpst.data import datasets as jds
from rpst.data import loader as jloader
from rpst.data import transforms as jtf
from rpst.train import metrics as jmetrics
from rpst_torch import data, viz
from rpst_torch.config import load_config
from rpst_torch.metrics import save_image_row

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from make_photoreal_set import make_photoreal_set  # noqa: E402


def _script(name):
    spec = importlib.util.spec_from_file_location(name.replace(".py", ""),
                                                  REPO / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    return make_photoreal_set(tmp_path_factory.mktemp("photo"), n=3, size=40)


def _same_item(got, ref):
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        if r is None or isinstance(r, str):
            assert g == r
        else:
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("size", [40, 32, 0])
def test_load_mask_matches_rpst(photo, tmp_path, size):
    """A label PNG (mode L), an RGB one (its first channel), resized by
    nearest or kept (size 0): rpst's int32 label map."""
    rgb = tmp_path / "rgb.png"
    lab = np.asarray(Image.open(photo / "labelme_segmentation" / "in0.png"))
    Image.fromarray(np.stack([lab, 255 - lab, lab // 2], -1), "RGB").save(rgb)
    for path in (photo / "labelme_segmentation" / "tar1.png", rgb):
        got, ref = data.load_mask(path, size), jtf.load_mask(path, size)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["photoreal", "iden_photoreal", "paired",
                                  "fmt"])
def test_test_datasets_match_rpst(photo, kind):
    """build_test_dataset of each kind against rpst's on the same folder:
    every item (images, names, masks), and iter_batches' batches."""
    over = dict(test_dir=str(photo), test_dataset=kind, img_size=32)
    if kind == "fmt":
        over["test_dir"] = str(photo / "content")
    if kind == "paired":  # content/ and style/ with the same names
        paired = photo.parent / "paired"
        for sub in ("content", "style"):
            (paired / sub).mkdir(parents=True, exist_ok=True)
            for k in range(3):
                Image.open(photo / sub / f"{'in' if sub == 'content' else 'tar'}"
                           f"{k}.png").save(paired / sub / f"p{k}.png")
        over["test_dir"] = str(paired)
    got = data.build_test_dataset(load_config(over))
    ref = jds.build_test_dataset(j_load_config(over))
    assert type(got).__name__ == type(ref).__name__
    assert len(got) == len(ref) == 3
    for i in range(3):
        if kind == "fmt":
            np.testing.assert_array_equal(got[i], ref[i])
        else:
            _same_item(got[i], ref[i])
    if kind == "fmt":
        return
    for g, r in zip(data.iter_batches(got, 2), jloader.iter_batches(ref, 2)):
        for a, b in zip(g, r):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    if kind != "paired":  # masks present; the identity set's are the same
        _, _, _, _, cm, sm = next(data.iter_batches(got, 2))
        assert cm.shape == (2, 32, 32) and cm.dtype == np.int32
        assert (kind == "iden_photoreal") == np.array_equal(cm, sm)


def test_save_image_row_is_pixel_equal(tmp_path):
    rng = np.random.default_rng(0)
    imgs = [rng.normal(0.5, 0.4, (24, 20, 3)).astype(np.float32)
            for _ in range(3)]
    save_image_row(imgs, tmp_path / "port.png")
    jmetrics.save_image_row(imgs, tmp_path / "rpst.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "rpst.png")))


def _claim_aux(rng, hw=16):
    return {"claim_value": rng.random((1, hw, 1), dtype=np.float32),
            "claim_before": rng.random((1, hw, hw), dtype=np.float32),
            "claim_after": rng.random((1, hw, hw), dtype=np.float32)}


@pytest.mark.parametrize("writer", ["claim_maps", "channel_attention",
                                    "feature_maps", "make_grid"])
def test_viz_is_pixel_equal(tmp_path, writer):
    """Each writer against rpst's on the same arrays: the same relative
    path, the same pixels (matplotlib draws both heatmap writers here)."""
    rng = np.random.default_rng(1)
    outs = {}
    for name, mod in (("port", viz), ("rpst", jviz)):
        root = tmp_path / name
        if writer == "claim_maps":
            path = mod.save_claim_maps(_claim_aux(np.random.default_rng(2)),
                                       root, iterations=3, bid=1, index=2)
        elif writer == "channel_attention":
            maps = [rng.random((2, 1, 1, 8), dtype=np.float32), None,
                    rng.random((2, 1, 1, 8), dtype=np.float32)]
            rng = np.random.default_rng(1)
            path = mod.save_channel_attention(maps, root, iterations=4)
        elif writer == "feature_maps":
            feats = [np.random.default_rng(3).normal(size=(1, 6, 5, c))
                     .astype(np.float32) for c in (3, 10)]
            path = mod.save_feature_maps(
                np.random.default_rng(4).random((9, 9, 3)), feats, root,
                iterations=5, channels=4, unit_size=16)
        else:
            tiles = [Image.new("RGB", (5, 7), (20 * i, 40, 9))
                     for i in range(5)]
            root.mkdir()
            path = root / "grid.png"
            mod.make_grid(Image.new("RGB", (8, 8), (1, 2, 3)), tiles, 2,
                          span=3, unit_size=12).save(path)
        outs[name] = Path(path)
    assert outs["port"].relative_to(tmp_path / "port") == \
        outs["rpst"].relative_to(tmp_path / "rpst")
    np.testing.assert_array_equal(np.asarray(Image.open(outs["port"])),
                                  np.asarray(Image.open(outs["rpst"])))


def test_viz_without_matplotlib_writes_the_same_files(tmp_path, monkeypatch):
    """Where matplotlib is missing (the GPU machine), the heatmap writers
    draw with PIL under the same file names: RGB sheets of the panels."""
    monkeypatch.setattr(viz, "_pyplot", lambda: None)
    rng = np.random.default_rng(5)
    path = Path(viz.save_claim_maps(_claim_aux(rng), tmp_path, 7, 2))
    assert path == tmp_path / "claim_map" / "it_7_bid_2.png"
    img = np.asarray(Image.open(path))
    assert img.shape == (2 * (viz._PANEL + viz._TITLE), 2 * viz._PANEL, 3)
    path = Path(viz.save_channel_attention(
        [rng.random((1, 1, 1, 8), dtype=np.float32)] * 3, tmp_path, 8))
    assert path.name == "it_8_bid_0.png" and Image.open(path).mode == "RGB"
    assert viz.save_channel_attention([None], tmp_path) is None


def _cfg(tmp_path, photo, out, **over):
    cfg = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=2,
               hidden_dim=8, inception_num=0, attention="none", img_size=32,
               batch_size=2, max_iter=3, test_iter=2, snapshot_save_iter=2,
               log_iter=1, num_workers=0, lr=1e-4, lr_decay=0.0,
               use_mask=True, test_dataset="photoreal",
               content_dir=str(photo / "content"),
               style_dir=str(photo / "style"), test_dir=str(photo),
               output=str(out), vgg="")
    cfg.update(over)
    path = tmp_path / f"{out.name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _names(out):
    return sorted(str(p.relative_to(out)) for p in (out / "test").rglob("*")
                  if p.is_file())


def test_drivers_write_rpsts_file_names(tmp_path, photo):
    """train.py then test.py (rpst's drivers, as subprocesses) and
    train_torch.py then test_torch.py (the port's, --device cpu) on the
    same config (masks on, a photoreal set of 3 pairs, batch 2, a dump at
    step 2): the same files under <output>/test."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    rpst_out = tmp_path / "rpst"
    cfg = _cfg(tmp_path, photo, rpst_out)
    for script in ("train.py", "test.py"):
        proc = subprocess.run([sys.executable, str(REPO / script),
                               "--config", str(cfg)], capture_output=True,
                              text=True, env=env, cwd=str(REPO), timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
    port_out = tmp_path / "port"
    cfg = _cfg(tmp_path, photo, port_out)
    _script("train_torch.py").main(["--config", str(cfg), "--device", "cpu"])
    _script("test_torch.py").main(["--config", str(cfg), "--device", "cpu"])
    names = _names(port_out)
    assert names == _names(rpst_out)
    assert "test/test_output/in2-tar2-cat.png" in names
    assert "test/2/in0-tar0.png" in names


def test_test_torch_writes_claim_maps(tmp_path):
    """dynamic_sanet through test_torch.py --device cpu on a paired set:
    the stylized PNGs and rpst's claim-map sheet, one a batch, under
    <output>/claim_map, named by the restored step (none: 0)."""
    rng = np.random.default_rng(6)
    test = tmp_path / "paired"
    for sub in ("content", "style"):
        (test / sub).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8),
                            "RGB").save(test / sub / f"p{i}.png")
    out = tmp_path / "out"
    _script("test_torch.py").main([
        "--config", str(REPO / "configs" / "train_dynamic_sanet.yaml"),
        "--device", "cpu", "--set", "img_size=32", "vgg=", "batch_size=2",
        f"test_dir={test}", "test_dataset=paired", f"output={out}"])
    assert sorted(p.name for p in (out / "claim_map").iterdir()) == \
        ["it_0_bid_0.png", "it_0_bid_1.png"]
    assert len(list((out / "test" / "test_output").glob("*-cat.png"))) == 3


def test_test_torch_cuda_without_a_card_exits_nonzero(tmp_path, photo):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "out"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO / "test_torch.py"), "--config",
         str(_cfg(tmp_path, photo, out))], capture_output=True, text=True,
        timeout=120, env=env, cwd=str(REPO))
    assert proc.returncode != 0
    assert "is_available() is False" in proc.stderr
    assert not out.exists()
