"""The static SANet of the port (``rpst_torch.models.sanet``, ``nn.decoder``,
the sanet sections of ``models`` / ``fast_path_q8_std`` / ``bridge`` and the
two drivers) on the CPU, against rpst's flax modules with bridged weights and
against ``tests/fixtures/torch_port_sanet.npz`` (rpst's stylize, int8
stylize in interpret mode, loss parts and gradients at 64px, batch 2, the
model's fixed width of 512; the image is kept small, not the model).

Tolerances: float32 modules 1e-4 (rtol = atol; the whole model rtol 1e-4 at
outputs of order 10); loss parts rtol 1e-4; gradients rtol 5e-3 with atol
1e-4 x the tensor's max (the flagship's, tests/test_folded.py:133-138),
except the leaves behind the softmax (the f and g convs), whose logits of
standard deviation ~8 amplify float32 rounding: 2e-3 x max; q8 with rpst's
scales PSNR >= 40 dB in float32 around the int8 layers and >= 30 dB in
bfloat16 (the two frameworks round bf16 at other places); calibration scales
2e-2 (the pass runs in bfloat16: one or two bf16 steps of an absmax).
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rpst.models.base import normalized_content_loss as jax_ncl
from rpst.models.sanet import SANetAttention as JaxSANetAttention
from rpst.models.sanet import Transform as JaxTransform
from rpst.nn.decoder import VGGMirrorDecoder as JaxDecoder
from rpst.nn.decoder import upsample_nearest_2x as jax_upsample
from rpst_torch.bridge import (from_flax_params, from_reference_checkpoint,
                               sanet_weights_from_seed, vgg_from_flax,
                               vgg_weights_from_seed)
from rpst_torch.config import load_config
from rpst_torch.models import build_model, build_vgg, vgg_stages
from rpst_torch.models.base import normalized_content_loss
from rpst_torch.models.fast_path_q8_std import (_MIRROR_PROGRAM,
                                                _upsample2x_any,
                                                sanet_q8_plan)
from rpst_torch.models.sanet import SANetAttention, Transform
from rpst_torch.nn.decoder import VGGMirrorDecoder, upsample_nearest_2x
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_port_sanet.npz"
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_KEYS = ("content_loss", "style_loss", "l_identity1_loss",
             "l_identity2_loss", "total_loss")


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


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
    cfg = load_config(dict(network="sanet", img_size=fx["content"].shape[1],
                           content_weight=1.0, style_weight=3.0))
    b = build_model(cfg)
    b.load_state_dict(from_flax_params(sanet_weights_from_seed(
        int(fx["weights_seed"]))))
    vgg = VGG19Encoder(5)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]), 5)))
    b.vgg = vgg
    return b


def test_upsample_and_normalized_content_loss_match_rpst():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    ref = np.asarray(jax_upsample(jnp.asarray(x)))
    got = upsample_nearest_2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    np.testing.assert_array_equal(_upsample2x_any(torch.from_numpy(x)).numpy(),
                                  ref)
    q = torch.from_numpy(rng.integers(-127, 128, (1, 2, 3, 4), dtype=np.int8))
    assert _upsample2x_any(q).dtype == torch.int8
    y = rng.normal(size=x.shape).astype(np.float32)
    np.testing.assert_allclose(
        float(normalized_content_loss(torch.from_numpy(x),
                                      torch.from_numpy(y))),
        float(jax_ncl(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)


def test_mirror_decoder_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 4, 6, 512)).astype(np.float32)
    mod = JaxDecoder()
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    dec = VGGMirrorDecoder()
    dec.load_state_dict(from_flax_params(_np_tree(params)))
    got = dec(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    assert [p for p, _ in _MIRROR_PROGRAM] == [
        None, "up", None, None, None, "up", None, "up", None]
    assert [a for _, a in _MIRROR_PROGRAM] == [True] * 8 + [False]


@pytest.mark.parametrize("hw_c,hw_s", [((8, 8), (8, 8)), ((6, 4), (3, 5))])
def test_sanet_attention_matches_flax(hw_c, hw_s):
    rng = np.random.default_rng(2)
    c = rng.normal(size=(2, *hw_c, 64)).astype(np.float32)
    s = rng.normal(size=(2, *hw_s, 64)).astype(np.float32)
    mod = JaxSANetAttention(64)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(c),
                      jnp.asarray(s))["params"]
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(c),
                               jnp.asarray(s)))
    att = SANetAttention(64)
    att.load_state_dict(from_flax_params(_np_tree(params)))
    # NHWC views of NCHW tensors, as the VGG hands its features over
    tc, ts = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
              .permute(0, 2, 3, 1) for a in (c, s))
    got = att(tc, ts)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    np.testing.assert_allclose(
        att(torch.from_numpy(c), torch.from_numpy(s)).detach().numpy(), ref,
        **TOL)


def test_transform_matches_flax_and_reaches_b6_contiguous():
    rng = np.random.default_rng(3)
    c4, s4 = (rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
              for _ in range(2))
    c5, s5 = (rng.normal(size=(2, 4, 4, 64)).astype(np.float32)
              for _ in range(2))
    mod = JaxTransform(64)
    args = [jnp.asarray(a) for a in (c4, s4, c5, s5)]
    params = mod.init(jax.random.PRNGKey(2), *args)["params"]
    ref = np.asarray(mod.apply({"params": params}, *args))
    tr = Transform(64)
    tr.load_state_dict(from_flax_params(_np_tree(params)))
    seen = []

    def spy(f, g, h):
        seen.append([t.is_contiguous() and t.ndim == 3 for t in (f, g, h)])
        return fa.sanet_attention(f, g, h)

    got = tr(*(torch.from_numpy(a) for a in (c4, s4, c5, s5)), attention=spy)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), ref,
                               **TOL)
    assert seen == [[True] * 3] * 2


def test_transform_in_bfloat16_computes_float32_as_rpst():
    """rpst's flax ``Transform`` builds its 1x1 and merge convs without a
    dtype, so on bfloat16 features (its bf16 stylize and q8 paths) it
    promotes to its float32 parameters: the port's transform under bfloat16
    autocast computes the same float32 function."""
    rng = np.random.default_rng(4)
    c4, s4 = (rng.normal(size=(2, 8, 8, 512)) for _ in range(2))
    c5, s5 = (rng.normal(size=(2, 4, 4, 512)) for _ in range(2))
    args = [jnp.asarray(a, jnp.bfloat16) for a in (c4, s4, c5, s5)]
    mod = JaxTransform(512, dtype=jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(2), *args)["params"]
    ref = mod.apply({"params": params}, *args)
    assert ref.dtype == jnp.float32
    tr = Transform(512)
    tr.load_state_dict(from_flax_params(_np_tree(params)))
    feats = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
             for a in args]
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = tr(*feats)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_reference_checkpoint_layout_loads(bundle):
    """tools/export_reference_checkpoint.py's {'transform', 'decoder'} file
    layout gives the same state_dict as the flax tree."""
    spec = importlib.util.spec_from_file_location(
        "export_reference_checkpoint",
        REPO / "tools" / "export_reference_checkpoint.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tree = sanet_weights_from_seed(3)
    want = from_flax_params(tree)
    got = from_reference_checkpoint(tool.export_tree(tree))
    assert sorted(got) == sorted(want) == sorted(bundle.model.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    # the adaptive modules' threshold MLPs load under the port's own names
    adaptive = from_reference_checkpoint({"decoder": {}, "transform": {
        "sanet4_1.attention_layer.f_psi.0.weight": np.zeros((2, 32))}})
    assert adaptive["transform.sanet4_1.attention_layer.f_psi.0.weight"] \
        .shape == (2, 32)


def test_stylize_matches_rpst(bundle, fx):
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    out = bundle.stylize(c, s)
    assert out.shape == fx["out_f32"].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), fx["out_f32"], **TOL)


def test_stylize_needs_the_five_stage_vgg(bundle, fx):
    c = torch.from_numpy(fx["content"])
    lone = build_model(bundle.cfg)
    with pytest.raises(ValueError, match="bundle.vgg"):
        lone.stylize(c, c)
    lone.vgg = VGG19Encoder(4)
    with pytest.raises(ValueError, match="5-stage"):
        lone.stylize(c, c)
    assert vgg_stages("sanet") == 5 and vgg_stages("multi_adain") == 4
    vgg, source = build_vgg(bundle.cfg)
    assert vgg.num_stages == 5 and "random" in source


def test_loss_parts_and_gradients_match_rpst(bundle, fx):
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    bundle.model.zero_grad(set_to_none=True)
    total, parts = bundle.loss(bundle.vgg, c, s)
    total.backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(parts[k].detach()), float(fx[k]),
                                   rtol=1e-4, err_msg=k)
    params = dict(bundle.model.named_parameters())
    checked = 0
    for key, ref in fx.items():
        kind, _, path = key.partition("/")
        if kind not in ("grads", "gradpatch", "gradnorm"):
            continue
        name = path.replace("/", ".").replace("kernel", "weight")
        grad = params[name].grad
        if name.endswith(".g.bias"):
            # a bias on the keys shifts all of a query's logits alike: the
            # gradient is zero up to rounding in both frameworks
            f_grad = params[name.replace(".g.", ".f.")].grad
            assert float(grad.abs().max()) <= 1e-3 * float(f_grad.abs().max())
            continue
        if kind == "gradnorm":
            np.testing.assert_allclose(float(grad.norm()), float(ref),
                                       rtol=1e-3, err_msg=name)
            continue
        got = (grad if kind == "grads" else
               grad.permute(2, 3, 1, 0)[..., :8, :8]).numpy()
        softmax = ".f." in name or ".g." in name
        np.testing.assert_allclose(
            got, ref, rtol=5e-3,
            atol=(2e-3 if softmax else 1e-4) * np.abs(ref).max(),
            err_msg=name)
        checked += 1
    assert checked == 2 * 18 - 2  # 18 convs: bias and kernel, less 2 g biases
    bundle.model.zero_grad(set_to_none=True)


def test_q8_plan_calibration_and_stylize_match_rpst(bundle, fx):
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    assert bundle.q8_infer()
    plan = sanet_q8_plan(bundle.vgg, bundle.q8_weights())
    assert plan == {"scales": 16, "B5": 16, "B6": 2}
    assert len(fx["act_scales"]) == plan["scales"]
    own = bundle.calibrate_q8(c, s)["act_scales"]
    np.testing.assert_allclose(own, fx["act_scales"], rtol=2e-2)
    scales = {"act_scales": fx["act_scales"]}
    for dt, key, min_psnr in ((torch.float32, "out_q8_f32", 40.0),
                              (torch.bfloat16, "out_q8_bf16", 38.0)):
        got = bundle.stylize_q8(c, s, scales, dtype=dt)
        assert got.dtype == torch.float32
        assert _psnr(got.numpy(), fx[key]) >= min_psnr, key
    with pytest.raises(ValueError, match="act scales"):
        bundle.stylize_q8(c, s, {"act_scales": fx["act_scales"][:5]})


def test_q8_needs_four_exact_pools():
    ok = build_model(load_config(dict(network="sanet", img_size=48)))
    odd = build_model(load_config(dict(network="sanet", img_size=40)))
    assert ok.q8_infer() and not odd.q8_infer()
    assert not ok.q8_recommended(1) and not ok.folded_infer()


def test_fixture_matches_fresh_jax_run(fx):
    """tests/fixtures/torch_port_sanet.npz is what
    tools/make_torch_port_fixture.py --sanet computes now with rpst."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixture",
        REPO / "tools" / "make_torch_port_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    fresh = tool.make_sanet_fixture()
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
    root = tmp_path_factory.mktemp("sanet_corpus")
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (root / sub).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8),
                            "RGB").save(root / sub / f"{i:02d}.png")
    return root


@pytest.mark.parametrize("mode", ["standard", "q8"])
def test_serve_torch_cli_sanet_on_cpu(corpus, tmp_path, mode):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, str(REPO / "serve_torch.py"), "--config",
         str(REPO / "configs" / "train_static_sanet.yaml"), "--set",
         "img_size=32", "vgg=", "--content", str(corpus / "content"),
         "--style", str(corpus / "style" / "00.png"), "--out", str(out),
         "--mode", mode, "--batch", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=_env(),
        cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(list(out.glob("*.png"))) == 4
    assert ("Calibrated 16 layer scales" in proc.stderr) == (mode == "q8")
    # CPU tensors take the plain versions: no kernel launch is counted
    assert re.search(r"B6 flash_attention launches: 0", proc.stderr)
    assert re.search(r"B5 fused_conv2d_q8 launches: 0", proc.stderr)


def test_train_torch_cli_sanet_on_cpu(corpus, tmp_path):
    import json
    out = tmp_path / "run"
    args = [sys.executable, str(REPO / "train_torch.py"), "--config",
            str(REPO / "configs" / "train_static_sanet.yaml"), "--device",
            "cpu", "--set", "img_size=32", "batch_size=2", "log_iter=1",
            "num_workers=0", "vgg=", "test_dir=", "snapshot_save_iter=2",
            f"content_dir={corpus / 'content'}",
            f"style_dir={corpus / 'style'}", f"output={out}"]
    proc = subprocess.run([*args, "max_iter=4"], capture_output=True,
                          text=True, timeout=600, env=_env(), cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Training sanet (standard, float32)" in proc.stderr
    assert "B6 fwd/dq/dkv launches: 0/0/0" in proc.stderr
    proc = subprocess.run([*args, "max_iter=3", "resume=true"],
                          capture_output=True, text=True, timeout=600,
                          env=_env(), cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in
             (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2, 3, 4, 5]
    for ln in lines:
        assert not ln["skipped"]
        assert all(np.isfinite(ln[k]) for k in LOSS_KEYS)
    assert lines[-1]["total_loss"] < lines[0]["total_loss"]
    with pytest.raises(subprocess.CalledProcessError):
        subprocess.run([sys.executable, str(REPO / "train_torch.py"),
                        "--config",
                        str(REPO / "configs" / "train_static_sanet.yaml"),
                        "--device", "cpu", "--set", "img_size=32"],
                       capture_output=True, check=True, timeout=300,
                       env=_env(), cwd=str(REPO))
