"""The int8 no-grad VGG loss targets (``train_q8_targets``) of the port
against rpst on the CPU, at the size tests/test_q8_targets.py uses (32px,
batch 4): the calibration, the six taps of the chained-int8 VGG encoder
(rpst's kernel in interpret mode), the loss, its gradient against the
float-target gradient, and the ``ModelBundle.loss`` / ``train_torch.py``
wiring. The same numpy-seeded images and the same VGG (drawn by
``vgg_weights_from_seed``) on both sides.

Tolerances, each with its reason:
  * calibration scales: rtol 2e-2 (both sides calibrate a bfloat16 forward
    and round its convs at different places);
  * taps with rpst's scales at float32: relu1_1 and relu2_1 come from float
    convs, rtol = atol = 1e-4; relu3_1 and relu4_1 pass the int8 chain,
    whose first quantization sees float32 sums that differ in the last bit
    between the two conv libraries, so a few values move one int8 step and
    the next layers spread that: PSNR >= 40 dB, MAE < 1e-3 of the tap's
    range;
  * the loss parts: rtol 5e-3 (the same effect: the style loss read 1.2e-3
    apart, relu4_1 having 16 pixels per channel at this size);
  * gradient cosine against the float-target path > 0.98, rpst's gate
    (tests/test_q8_targets.py:100).
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rpst.models import fast_path_q8 as jq8
from rpst.nn.vgg_folded import \
    perceptual_rp_losses_q8targets as j_losses_q8targets
from rpst_torch import policy
from rpst_torch.bridge import vgg_from_flax, vgg_weights_from_seed
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.models import fast_path_q8_std as q8s
from rpst_torch.nn.blocks import init_torch_default
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.nn.vgg_folded import perceptual_rp_losses_q8targets
from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
IMG, BATCH = 32, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _psnr(got, ref):
    mse = float(np.mean((got - ref) ** 2))
    span = float(ref.max() - ref.min()) or 1.0
    return 10 * np.log10(span * span / max(mse, 1e-30))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    content = rng.random((BATCH, IMG, IMG, 3), dtype=np.float32)
    style = rng.random((BATCH, IMG, IMG, 3), dtype=np.float32)
    stylized = rng.random((BATCH, IMG, IMG, 3), dtype=np.float32)
    tree = vgg_weights_from_seed(1)
    vgg_vars = {"params": {k: {"Conv_0": {n: jnp.asarray(a) for n, a in
                                          v["Conv_0"].items()}}
                           for k, v in tree["params"].items()}}
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(tree))
    j_scales = jq8.calibrate_vgg_targets_q8(vgg_vars, jnp.asarray(content),
                                            jnp.asarray(style))
    return content, style, stylized, vgg_vars, vgg, j_scales


def test_plan_is_six_layers_six_scales(setup):
    vgg = setup[4]
    assert q8s.vgg_q8_plan(vgg) == {"scales": 6, "B5": 6}
    _, qconvs, program, taps = q8s._vgg_q8_layers(vgg, 4, torch.float32)
    assert [i for i, q in enumerate(qconvs) if q is not None] == [4, 5, 6, 7,
                                                                  8, 9]
    assert taps == [1, 3, 5, 9]
    assert [p for p, _ in program].count("pool") == 3
    assert vgg.cached(("q8", 4, torch.device("cpu")), list) is qconvs


def test_calibration_matches_rpst(setup):
    content, style, _, _, vgg, j_scales = setup
    got = q8s.calibrate_vgg_targets_q8(vgg, _t(content), _t(style))
    assert got["act_scales"].dtype == np.float32
    assert len(got["act_scales"]) == len(j_scales["act_scales"]) == 6
    np.testing.assert_allclose(got["act_scales"], j_scales["act_scales"],
                               rtol=2e-2)


def test_target_taps_match_rpst_interpret(setup):
    content, style, _, vgg_vars, vgg, j_scales = setup
    sc = np.concatenate([style, content])
    ref = jq8.vgg_target_taps_q8(vgg_vars, j_scales, jnp.asarray(sc),
                                 jnp.float32, interpret=True,
                                 conv_impl="pallas")
    before = fused_conv2d_q8.launches
    got = q8s.vgg_target_taps_q8(vgg, j_scales, _t(sc), torch.float32)
    assert fused_conv2d_q8.launches == before  # the CPU launches no kernel
    assert [tuple(t.shape) for t in got] == [
        (8, 32, 32, 64), (8, 16, 16, 128), (8, 8, 8, 256), (8, 4, 4, 512)]
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.numpy(), np.asarray(r, np.float32)
        assert not got[i].requires_grad
        if i < 2:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
            continue
        span = float(r.max() - r.min())
        psnr, mae = _psnr(g, r), float(np.abs(g - r).mean())
        print(f"tap {i}: PSNR {psnr:.2f} dB, MAE {mae:.3g} of span {span:.3g}")
        assert psnr >= 40.0 and mae < 1e-3 * span


def test_taps_stay_close_to_the_float_encoder(setup):
    """The int8 taps are the float encoder's taps up to quantization noise:
    PSNR over each tap above 25 dB (7-bit values through up to six chained
    layers)."""
    content, style, _, _, vgg, j_scales = setup
    sc = _t(np.concatenate([style, content]))
    taps_q = q8s.vgg_target_taps_q8(vgg, j_scales, sc, torch.float32)
    with torch.no_grad():
        taps_f = vgg(sc)
    for i, (q, f) in enumerate(zip(taps_q, taps_f)):
        psnr = _psnr(q.numpy(), f.numpy())
        print(f"tap {i} int8 vs float encoder: PSNR {psnr:.2f} dB")
        assert psnr > 25.0


def test_maxpool_any_is_exact_on_int8_and_refuses_odd_sizes():
    q = torch.randint(-127, 128, (2, 6, 8, 4), dtype=torch.int8)
    pooled = q8s._maxpool2x_any(q)
    ref = torch.nn.functional.max_pool2d(q.float().permute(0, 3, 1, 2), 2)
    assert pooled.dtype == torch.int8
    assert torch.equal(pooled.float(), ref.permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="even H, W"):
        q8s._maxpool2x_any(q[:, :5])


def test_loss_matches_rpst_interpret(setup):
    content, style, stylized, vgg_vars, vgg, j_scales = setup
    ref, ref_total = j_losses_q8targets(
        vgg_vars, j_scales, jnp.asarray(stylized), jnp.asarray(style),
        jnp.asarray(content), 1.0, 2.0, dtype=jnp.float32, interpret=True)
    got, total = perceptual_rp_losses_q8targets(
        vgg, j_scales, _t(stylized), _t(style), _t(content), 1.0, 2.0,
        dtype=torch.float32)
    for k in ("style_loss", "content_loss"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=5e-3)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=5e-3)


def _flagship(**extra):
    cfg = load_config({**dict(
        network="multi_adain", enc_stack_way="constant", rp_blocks=3,
        hidden_dim=16, img_size=IMG, exec_strategy="folded",
        train_q8_targets=True, content_weight=1.0, style_weight=2.0), **extra})
    bundle = build_model(cfg)
    init_torch_default(bundle.model, 0)
    return bundle


def _grad(bundle, vgg, content, style):
    bundle.model.zero_grad(set_to_none=True)
    total, parts = bundle.loss(vgg, _t(content), _t(style))
    total.backward()
    return float(total.detach()), torch.cat([p.grad.flatten()
                                    for p in bundle.model.parameters()])


def test_gradient_cosine_vs_float_targets(setup, monkeypatch):
    content, style, _, _, vgg, j_scales = setup
    monkeypatch.setattr(policy, "TRAIN_Q8_TARGETS_MIN_BATCH", 1)
    bundle = _flagship()
    l_ref, g_ref = _grad(bundle, vgg, content, style)  # no scales yet: float
    bundle.q8_target_scales = j_scales
    assert bundle.q8_targets_active(BATCH)
    l_q8, g_q8 = _grad(bundle, vgg, content, style)
    cos = float(torch.dot(g_ref, g_q8) / (g_ref.norm() * g_q8.norm() + 1e-12))
    print(f"gradient cosine int8 vs float targets: {cos:.6f}; loss {l_q8:.6g} "
          f"vs {l_ref:.6g}")
    assert cos > 0.98
    assert l_q8 != l_ref and abs(l_q8 - l_ref) / abs(l_ref) < 0.05


def test_bundle_loss_gates(setup, monkeypatch):
    """Float targets unless the knob is on, the scales are set, img_size %
    8 == 0 and the batch reaches the policy's minimum."""
    content, style, _, _, vgg, j_scales = setup
    monkeypatch.setattr(policy, "TRAIN_Q8_TARGETS_MIN_BATCH", 1)
    off = _flagship(train_q8_targets=False)
    off.q8_target_scales = j_scales
    l_off, _ = _grad(off, vgg, content, style)
    on = _flagship()
    assert not on.q8_targets_active(BATCH)  # no scales
    assert _grad(on, vgg, content, style)[0] == l_off
    on.q8_target_scales = j_scales
    assert on.q8_targets_active(BATCH) and not off.q8_targets_active(BATCH)
    monkeypatch.setattr(policy, "TRAIN_Q8_TARGETS_MIN_BATCH", BATCH + 1)
    assert not on.q8_targets_active(BATCH)
    assert _grad(on, vgg, content, style)[0] == l_off
    odd = _flagship(img_size=36)
    odd.q8_target_scales = j_scales
    monkeypatch.setattr(policy, "TRAIN_Q8_TARGETS_MIN_BATCH", 1)
    assert not odd.q8_targets_active(BATCH)


def test_only_the_stylized_pass_carries_gradients(setup):
    content, style, stylized, _, vgg, j_scales = setup
    x = _t(stylized).requires_grad_()
    c, s_ = _t(content).requires_grad_(), _t(style).requires_grad_()
    _, total = perceptual_rp_losses_q8targets(vgg, j_scales, x, s_, c, 1.0,
                                              2.0, dtype=torch.float32)
    total.backward()
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().max()) > 0
    assert c.grad is None and s_.grad is None


def test_port_matches_the_q8_targets_fixture():
    """tests/fixtures/torch_port_q8_targets.npz (64px b4) holds rpst's int8
    taps and loss; chip_smoke.py holds the card to it, and here the CPU."""
    with np.load(REPO / "tests" / "fixtures" /
                 "torch_port_q8_targets.npz") as npz:
        fx = {k: npz[k] for k in npz.files}
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    c, s, x = (_t(fx[k]) for k in ("content", "style", "stylized"))
    scales = {"act_scales": fx["act_scales"]}
    taps = q8s.vgg_target_taps_q8(vgg, scales, torch.cat([s, c]),
                                  torch.float32)
    for i in (2, 3):
        assert taps[i].shape == fx[f"tap_{i}"].shape
        assert _psnr(taps[i].numpy(), fx[f"tap_{i}"]) >= 40.0
    parts, total = perceptual_rp_losses_q8targets(vgg, scales, x, s, c, 1.0,
                                                  2.0, dtype=torch.float32)
    for k, v in (("style_loss", parts["style_loss"]),
                 ("content_loss", parts["content_loss"]),
                 ("total_loss", total)):
        np.testing.assert_allclose(float(v), float(fx[k]), rtol=5e-3)


# ------------------------------------------------ the slice as a whole (CLI)

def _driver():
    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def run_dir(tmp_path):
    rng = np.random.default_rng(0)
    for sub in ("content", "style/painter"):
        (tmp_path / sub).mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 36, 3), np.uint8),
                            "RGB").save(tmp_path / sub / f"{i}.png")
    cfg = dict(network="multi_adain", rp_blocks=3, hidden_dim=8, img_size=32,
               batch_size=2, num_workers=2, exec_strategy="folded",
               max_iter=3, snapshot_save_iter=10,
               content_dir=str(tmp_path / "content"),
               style_dir=str(tmp_path / "style"),
               output=str(tmp_path / "out"))
    (tmp_path / "cfg.yaml").write_text(json.dumps(cfg))
    return tmp_path


def _metrics(run_dir):
    return [json.loads(ln) for ln in (run_dir / "out" / "logs" /
                                      "metrics.jsonl").read_text().splitlines()]


def test_train_torch_cpu_with_q8_targets(run_dir, caplog, monkeypatch):
    """train_torch.py --device cpu with train_q8_targets=true: calibrates 6
    scales once, trains 2 finite steps, launches no kernel; below the
    policy's batch it says so and keeps the float targets."""
    from rpst_torch.metrics import logger
    monkeypatch.setattr(logger, "propagate", True)  # let caplog see it
    monkeypatch.setattr(policy, "TRAIN_Q8_TARGETS_MIN_BATCH", 2)
    main = _driver().main
    with caplog.at_level("INFO"):
        main(["--config", str(run_dir / "cfg.yaml"), "--device", "cpu",
              "--set", "train_q8_targets=true"])
    assert "train_q8_targets: calibrated 6 VGG target scales" in caplog.text
    assert "inactive at this batch size" not in caplog.text
    assert "B5 fused_conv2d_q8 launches: 0" in caplog.text
    lines = _metrics(run_dir)
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln["total_loss"]) and ln["skipped"] == 0.0
               for ln in lines)
    caplog.clear()
    monkeypatch.setattr(policy, "TRAIN_Q8_TARGETS_MIN_BATCH", 4)
    with caplog.at_level("INFO"):
        main(["--config", str(run_dir / "cfg.yaml"), "--device", "cpu",
              "--set", "train_q8_targets=true", "output=" +
              str(run_dir / "out2")])
    assert "inactive at this batch size" in caplog.text


def test_train_torch_cpu_q8_targets_ignored_when_not_folded(run_dir, caplog,
                                                            monkeypatch):
    from rpst_torch.metrics import logger
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level("WARNING"):
        _driver().main(["--config", str(run_dir / "cfg.yaml"), "--device",
                        "cpu", "--set", "train_q8_targets=true",
                        "exec_strategy=standard"])
    assert "train_q8_targets ignored" in caplog.text


def test_train_torch_cpu_trains_adain_standard(run_dir):
    """network: adain trains on the standard path (autograd through the
    library convs) and the loss falls over a few steps."""
    _driver().main(["--config", str(run_dir / "cfg.yaml"), "--device", "cpu",
                    "--set", "network=adain", "rp_blocks=3", "hidden_dim=8",
                    "max_iter=6", "lr=0.001"])
    lines = _metrics(run_dir)
    assert [ln["step"] for ln in lines] == [1, 2, 3, 4, 5]
    losses = [ln["total_loss"] for ln in lines]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
