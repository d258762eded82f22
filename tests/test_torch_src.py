"""SourceNet of the port (``src``: ``rpst_torch.models.src_adain``, the src
sections of ``models``, ``fast_path_q8_std``, ``bridge`` and the two
drivers) on the CPU, against ``tests/fixtures/torch_port_src.npz`` (rpst's
stylize, int8 stylize in interpret mode, loss parts and gradients at 64px,
batch 2, the decoder's fixed width of 512).

Tolerances: the stylize 1e-4 (rtol = atol); loss parts rtol 1e-4; gradients
rtol 5e-3 with atol 1e-4 x the tensor's max (the flagship's,
tests/test_folded.py:133-138); q8 with rpst's scales PSNR >= 40 dB in
float32 around the int8 layers and >= 30 dB in bfloat16; calibration scales
2e-2 (the pass runs in bfloat16).
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rpst_torch.bridge import (from_flax_params, from_reference_checkpoint,
                               src_weights_from_seed, vgg_from_flax,
                               vgg_weights_from_seed)
from rpst_torch.config import load_config
from rpst_torch.models import build_model, build_vgg
from rpst_torch.models.fast_path_q8_std import src_blocks, src_q8_plan
from rpst_torch.models.src_adain import SourceNet
from rpst_torch.nn.vgg import VGG19Encoder
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_port_src.npz"
YAML = REPO / "configs" / "train_source_adain.yaml"
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_KEYS = ("content_loss", "style_loss", "total_loss")


def _psnr(got, ref):
    mse = float(np.mean((got.astype(np.float64) - ref) ** 2))
    span = float(ref.max() - ref.min())
    return 10 * np.log10(span * span / max(mse, 1e-30))


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module")
def bundle(fx):
    cfg = load_config(dict(network="src", img_size=fx["content"].shape[1],
                           content_weight=1.0, style_weight=2.0))
    b = build_model(cfg)
    b.load_state_dict(from_flax_params(src_weights_from_seed(
        int(fx["weights_seed"]))))
    vgg = VGG19Encoder(4)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]), 4)))
    b.vgg = vgg
    return b


def test_stylize_matches_rpst(bundle, fx):
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    out = bundle.stylize(c, s)
    assert out.shape == fx["out_f32"].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), fx["out_f32"], **TOL)
    assert bundle.stylize_with_aux(c, s)[1] == {}


def test_stylize_needs_the_four_stage_vgg(bundle, fx):
    c = torch.from_numpy(fx["content"])
    lone = build_model(bundle.cfg)
    assert lone.from_features and lone.vgg_stages == 4
    with pytest.raises(ValueError, match="bundle.vgg"):
        lone.stylize(c, c)
    lone.vgg = VGG19Encoder(5)
    with pytest.raises(ValueError, match="4-stage"):
        lone.stylize(c, c)
    vgg, source = build_vgg(bundle.cfg)
    assert vgg.num_stages == 4 and "random" in source


def test_loss_parts_and_gradients_match_rpst(bundle, fx):
    """The content loss is taken against the AdaIN target t; the mixed
    total uses the config's weights (1 and 2)."""
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    bundle.model.zero_grad(set_to_none=True)
    total, parts = bundle.loss(bundle.vgg, c, s)
    total.backward()
    assert sorted(parts) == sorted(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(parts[k].detach()), float(fx[k]),
                                   rtol=1e-4, err_msg=k)
    params = dict(bundle.model.named_parameters())
    checked = 0
    for key, ref in fx.items():
        kind, _, path = key.partition("/")
        if kind not in ("grads", "gradpatch", "gradnorm"):
            continue
        grad = params[path.replace("/", ".").replace("kernel", "weight")].grad
        if kind == "gradnorm":
            np.testing.assert_allclose(float(grad.norm()), float(ref),
                                       rtol=1e-3, err_msg=path)
            continue
        got = grad if kind == "grads" else grad.permute(2, 3, 1, 0)[...,
                                                                    :8, :8]
        np.testing.assert_allclose(got.numpy(), ref, rtol=5e-3,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=path)
        checked += 1
    assert checked == 2 * 9  # the decoder's 9 convs, bias and kernel
    bundle.model.zero_grad(set_to_none=True)


def test_q8_plan_calibration_and_stylize_match_rpst(bundle, fx):
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    assert bundle.q8_infer()
    plan = src_q8_plan(bundle.vgg, bundle.q8_weights())
    # rpst's tests/test_q8.py:276-296: conv_4 input + conv_4..conv_8 chained
    # = 6 encoder scales, 6 decoder scales
    assert plan == {"scales": 12, "B5": 12, "B6": 0}
    assert len(fx["act_scales"]) == plan["scales"]
    assert src_blocks(bundle.model, torch.bfloat16)["decoder"][0][0].dtype \
        == torch.bfloat16
    own = bundle.calibrate_q8(c, s)["act_scales"]
    np.testing.assert_allclose(own, fx["act_scales"], rtol=2e-2)
    scales = {"act_scales": fx["act_scales"]}
    for dt, key, min_psnr in ((torch.float32, "out_q8_f32", 40.0),
                              (torch.bfloat16, "out_q8_bf16", 30.0)):
        got = bundle.stylize_q8(c, s, scales, dtype=dt)
        assert got.dtype == torch.float32
        assert _psnr(got.numpy(), fx[key]) >= min_psnr, key
    with pytest.raises(ValueError, match="act scales"):
        bundle.stylize_q8(c, s, {"act_scales": fx["act_scales"][:5]})


def test_labels_raise_naming_slice_7(bundle, fx):
    """Labels, which raised until slice 7 (the name kept), fuse at relu4_1
    by the masked AdaIN with ``use_mask`` in test mode, on label maps
    resized by rpst's integer nearest index: against rpst's
    ``SourceNet.stylize_from_feats`` on the fixture's weights, f32 1e-4;
    without ``use_mask`` or test mode the fusion stays plain AdaIN.
    ``resize_labels`` is rpst's ``_resize_labels`` at sizes where a float
    scale would pick other rows."""
    import jax.numpy as jnp

    from rpst.models import src_adain as jsrc
    from rpst_torch.models.src_adain import resize_labels
    rng = np.random.default_rng(8)
    for h_in, h in ((64, 8), (600, 77), (37, 11), (5, 13)):
        lab = rng.integers(0, 9, (2, h_in, h_in + 3)).astype(np.int32)
        np.testing.assert_array_equal(
            resize_labels(torch.from_numpy(lab), h, h + 1).numpy(),
            np.asarray(jsrc._resize_labels(jnp.asarray(lab), h, h + 1)))
    sys.path.insert(0, str(REPO / "tools"))
    from make_photoreal_set import label_maps
    maps = [label_maps(64, rng) for _ in range(2)]
    cl, sl = (torch.from_numpy(np.stack([m[i] for m in maps])
                               .astype(np.int64)) for i in (0, 1))
    feats = [f.detach() for f in bundle.vgg(torch.from_numpy(fx["content"]))]
    sfeats = [f.detach() for f in bundle.vgg(torch.from_numpy(fx["style"]))]
    plain = bundle.model(feats, sfeats, cl, sl, test_mode=True)
    torch.testing.assert_close(plain, bundle.model(feats, sfeats))
    masked_model = SourceNet(use_mask=True)
    masked_model.load_state_dict(bundle.model.state_dict())
    got = masked_model(feats, sfeats, cl, sl, test_mode=True)
    torch.testing.assert_close(masked_model(feats, sfeats, cl, sl), plain)
    jm = jsrc.SourceNet(use_mask=True)
    params = src_weights_from_seed(int(fx["weights_seed"]))
    ref = jm.apply({"params": params}, [jnp.asarray(f.numpy()) for f in feats],
                   [jnp.asarray(f.numpy()) for f in sfeats],
                   jnp.asarray(cl.numpy()), jnp.asarray(sl.numpy()), True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    assert not torch.allclose(got, plain, atol=1e-3)


def test_q8_gates_and_the_mask_flag():
    """``use_mask`` (the repository's yaml) turns the int8 path off, as
    rpst's gate does, and changes nothing else; three exact pools need
    img_size % 8 == 0."""
    masked = build_model(load_config(str(YAML), dict(img_size=64)))
    assert masked.model.use_mask and not masked.q8_infer()
    assert not masked.q8_recommended(1) and not masked.folded_infer()
    plain = build_model(load_config(dict(network="src", img_size=64)))
    assert plain.q8_infer()
    assert not build_model(load_config(dict(network="src",
                                            img_size=60))).q8_infer()
    assert sorted(masked.model.state_dict()) == sorted(
        plain.model.state_dict())
    with pytest.raises(ValueError, match="int8 path needs"):
        masked.calibrate_q8(torch.zeros(1, 64, 64, 3),
                            torch.zeros(1, 64, 64, 3))


def test_reference_checkpoint_layout_loads():
    """The reference SourceNet checkpoint, ``{'decoder': sd}`` with the
    VGG-mirror Sequential's conv indices, loads into the port's names."""
    tree = src_weights_from_seed(5)
    want = from_flax_params(tree)
    idxs = (1, 5, 8, 11, 14, 18, 21, 25, 28)
    ckpt = {"decoder": {}}
    for i, idx in enumerate(idxs):
        p = tree["decoder"][f"conv{i}"]["Conv_0"]
        ckpt["decoder"][f"{idx}.weight"] = p["kernel"].transpose(3, 2, 0, 1)
        ckpt["decoder"][f"{idx}.bias"] = p["bias"]
    got = from_reference_checkpoint(ckpt)
    assert sorted(got) == sorted(want) == sorted(SourceNet().state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


def test_fixture_matches_fresh_jax_run(fx):
    """tests/fixtures/torch_port_src.npz is what
    tools/make_torch_port_fixture.py --src computes now with rpst."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixture",
        REPO / "tools" / "make_torch_port_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    fresh = tool.make_src_fixture()
    assert sorted(fx) == sorted(fresh)
    for k, v in fresh.items():
        np.testing.assert_allclose(
            fx[k], v, rtol=1e-5,
            atol=1e-6 * max(float(np.abs(v).max()), 1.0), err_msg=k)


# ------------------------------------------------------------- the drivers

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("src_corpus")
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (root / sub).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8),
                            "RGB").save(root / sub / f"{i:02d}.png")
    return root


@pytest.mark.parametrize("mode", ["standard", "q8"])
def test_serve_torch_cli_src_on_cpu(corpus, tmp_path, mode):
    """The repository's yaml sets use_mask: q8 needs it off."""
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, str(REPO / "serve_torch.py"), "--config", str(YAML),
         "--set", "img_size=32", "vgg=", "use_mask=false", "--content",
         str(corpus / "content"), "--style", str(corpus / "style" / "00.png"),
         "--out", str(out), "--mode", mode, "--batch", "2", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, env=_env(),
        cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(list(out.glob("*.png"))) == 4
    assert ("Calibrated 12 layer scales" in proc.stderr) == (mode == "q8")
    assert "B5 fused_conv2d_q8 launches: 0" in proc.stderr


def test_train_torch_cli_src_on_cpu(corpus, tmp_path):
    out = tmp_path / "run"
    args = [sys.executable, str(REPO / "train_torch.py"), "--config",
            str(YAML), "--device", "cpu", "--set", "img_size=32",
            "batch_size=2", "log_iter=1", "num_workers=0", "vgg=",
            "test_dir=", "snapshot_save_iter=2",
            f"content_dir={corpus / 'content'}",
            f"style_dir={corpus / 'style'}", f"output={out}"]
    proc = subprocess.run([*args, "max_iter=3"], capture_output=True,
                          text=True, timeout=600, env=_env(), cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Training src (standard, float32)" in proc.stderr
    proc = subprocess.run([*args, "max_iter=3", "resume=true"],
                          capture_output=True, text=True, timeout=600,
                          env=_env(), cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in
             (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2, 3, 4]
    for ln in lines:
        assert not ln["skipped"]
        assert all(np.isfinite(ln[k]) for k in LOSS_KEYS)
