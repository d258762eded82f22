"""The port's adain and wct (the RPSequence families) against rpst on the
CPU: the bridged standard models against flax ``AdaINRP`` / ``WCTRP``, the
WCT op, and the int8 (q8) standard-layout path against rpst's with its
Pallas kernel in interpret mode. Same numpy-seeded inputs, same flax params.

Tolerances, each with its reason:
  * standard float32 forward: adain rtol = atol = 1e-4 (conv sums in another
    order); wct 1e-3 (two eigendecompositions of 512x512 covariances, whose
    float32 error the matrix powers amplify). Fused features are compared,
    never eigenvectors: their signs and the basis of near-equal eigenvalues
    are free.
  * calibration scales: rtol 2e-2, both sides calibrate a bfloat16 forward
    and round its convs at different places; against a float32 calibration
    of the same code 1e-6 relative does hold, and that is checked with
    rpst's collector run in float32.
  * int8 encoder features with rpst's scales at float32: bit-equal from the
    same int8 input, but for exact .5 ties (see the test's docstring).
  * ``_stats_q8``: rtol 1e-5 (the port's sums are exact integers, rpst's
    float32 sums round).
  * the q8 stylize at float32 with rpst's scales: PSNR >= 40 dB and MAE <
    1e-3 (a one-ulp difference in a float statistic can move a decoder
    requantization by one int8 step), and the output is printed by
    chip_smoke.py against the same fixtures on the card.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.config import load_config as j_load_config
from rpst.models import build_model as j_build_model
from rpst.models import fast_path_q8 as jq8
from rpst.ops import wct as j_wct
from rpst_torch.bridge import from_flax_params, from_reference_checkpoint
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.models import fast_path_q8_std as q8s
from rpst_torch.ops import wct
from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8
from rpst_torch.serving import calibrate_scales, make_run_impl, resolve_mode
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WIDE = dict(rp_blocks=5, hidden_dim=32, img_size=32)  # tests/test_q8.py:146


def _t(a):
    return torch.from_numpy(np.array(a))


def _psnr(got, ref):
    mse = float(np.mean((got - ref) ** 2))
    span = float(ref.max() - ref.min()) or 1.0
    return 10 * np.log10(span * span / max(mse, 1e-30))


def _setup(network, n=2, seed=0, **extra):
    """(rpst bundle, flax params, content, style, port bundle bridged)."""
    cfg = dict(WIDE, network=network, **extra)
    rng = np.random.default_rng(seed)
    size = cfg["img_size"]
    content = rng.random((n, size, size, 3), dtype=np.float32)
    style = rng.random((n, size, size, 3), dtype=np.float32)
    jb = j_build_model(j_load_config(cfg))
    params = jb.model.init(jax.random.PRNGKey(0), jnp.asarray(content),
                           jnp.asarray(style))["params"]
    bundle = build_model(load_config(cfg))
    bundle.load_state_dict(from_flax_params(params))
    return jb, params, content, style, bundle


@pytest.fixture(scope="module")
def adain_wide():
    return _setup("adain")


@pytest.fixture(scope="module")
def wct_wide():
    return _setup("wct")


# ---------------------------------------------------------------- standard

@pytest.mark.parametrize("network,n,hidden,tol", [
    ("adain", 2, 32, 1e-4), ("adain", 1, 8, 1e-4),
    ("wct", 2, 16, 1e-3), ("wct", 1, 8, 1e-3)])
def test_standard_model_matches_flax(network, n, hidden, tol):
    """n = 1 takes the two-pass encode, n = 2 the one 2N pass."""
    jb, params, content, style, bundle = _setup(
        network, n, hidden_dim=hidden, rp_blocks=4 if hidden < 32 else 5,
        img_size=16)
    ref = np.asarray(jb.model.apply({"params": params}, jnp.asarray(content),
                                    jnp.asarray(style), train=False))
    got = bundle.stylize(_t(content), _t(style)).numpy()
    assert got.shape == ref.shape == (n, 16, 16, 3)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_state_dict_names_follow_the_flax_tree(adain_wide):
    _, params, _, _, bundle = adain_wide
    names = set(bundle.model.state_dict())
    assert names == {f"{part}.conv_{i}.Conv_0.{leaf}"
                     for part in ("encoder", "decoder") for i in range(5)
                     for leaf in ("weight", "bias")}
    w = bundle.model.state_dict()["encoder.conv_3.Conv_0.weight"]
    assert tuple(w.shape) == (256, 128, 3, 3)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(params["encoder"]["conv_3"]["Conv_0"]
                              ["kernel"]).transpose(3, 2, 0, 1))


def test_reference_checkpoint_rpseq_layout(adain_wide):
    """The reference's conv + ReLU Sequential keys ({2i}.weight) load into
    conv_{i}, as tools/export_reference_checkpoint.py writes them."""
    _, _, _, _, bundle = adain_wide
    sd = bundle.model.state_dict()
    ckpt = {part: {f"{2 * i}.{leaf}": sd[f"{part}.conv_{i}.Conv_0.{leaf}"]
                   .numpy() for i in range(5) for leaf in ("weight", "bias")}
            for part in ("encoder", "decoder")}
    back = from_reference_checkpoint(ckpt)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k])
    with pytest.raises(ValueError, match="only plain Conv2dBlocks"):
        from_reference_checkpoint({"encoder": {"1.weight": np.zeros(1)},
                                   "decoder": {}})


@pytest.mark.parametrize("network,extra,match", [
    ("adain", dict(use_mask=True), "slice 7"),
    ("wct", dict(wct_dtype="float16"), "wct_dtype")])
def test_unported_options_raise(network, extra, match):
    """wct's unknown ``wct_dtype`` raises. adain's ``use_mask``, which the
    refusal pinned until slice 7 (this case keeps its id), builds as rpst
    builds it, without the module's ``use_mask`` (rpst's registry passes
    only the widths): its labels fuse by plain AdaIN, and q8 stays off, as
    rpst's gate says. The module's own option masks as rpst's AdaINRP
    (use_mask=True) does, f32 1e-4."""
    if network == "wct":
        with pytest.raises((NotImplementedError, ValueError), match=match):
            build_model(load_config(dict(network=network, **extra)))
        return
    from rpst.models.adain_rp import AdaINRP as JaxAdaINRP
    from rpst_torch.bridge import rpseq_weights_from_seed
    from rpst_torch.models.adain_rp import AdaINRP
    sys.path.insert(0, str(REPO / "tools"))
    from make_photoreal_set import label_maps
    rng = np.random.default_rng(3)
    c, s = (rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(2))
    maps = [label_maps(32, rng) for _ in range(2)]
    cl, sl = (np.stack([m[i] for m in maps]).astype(np.int32)
              for i in (0, 1))
    tree = rpseq_weights_from_seed(3, rp_blocks=3, hidden_dim=8)
    cfg = load_config(dict(network="adain", rp_blocks=3, hidden_dim=8,
                           img_size=32, **extra))
    bundle = build_model(cfg)
    bundle.load_state_dict(from_flax_params(tree))
    assert not bundle.q8_infer()
    args = [torch.from_numpy(a) for a in (c, s, cl, sl)]
    jb = j_build_model(j_load_config(dict(network="adain", rp_blocks=3,
                                          hidden_dim=8, img_size=32,
                                          **extra)))
    ref = jb.stylize({"params": tree}, None, jnp.asarray(c), jnp.asarray(s),
                     jnp.asarray(cl), jnp.asarray(sl))
    np.testing.assert_allclose(bundle.stylize(*args).numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)
    module = AdaINRP(rp_blocks=3, hidden_dim=8, use_mask=True)
    module.load_state_dict(from_flax_params(tree))
    ref = JaxAdaINRP(rp_blocks=3, hidden_dim=8, use_mask=True).apply(
        {"params": tree}, jnp.asarray(c), jnp.asarray(s),
        c_labels=jnp.asarray(cl), s_labels=jnp.asarray(sl))
    with torch.no_grad():
        got = module(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert not np.allclose(got.numpy(), bundle.stylize(*args[:2]).numpy(),
                           atol=1e-3)


# ---------------------------------------------------------------- wct op

@pytest.mark.parametrize("method", ["closed-form", "original"])
def test_wct_fuse_matches_rpst(method):
    rng = np.random.default_rng(1)
    cf = rng.normal(size=(2, 12, 10, 16)).astype(np.float32)
    sf = (rng.normal(size=(2, 9, 11, 16)) * 1.7 + 0.3).astype(np.float32)
    ref = np.asarray(j_wct.wct_fuse(jnp.asarray(cf), jnp.asarray(sf),
                                    method=method))
    got = wct.wct_fuse(_t(cf), _t(sf), method=method)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)
    got64 = wct.wct_fuse(_t(cf), _t(sf), method=method, dtype=torch.float64)
    assert got64.dtype == torch.float32
    np.testing.assert_allclose(got64.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_matrix_powers_match_rpst_and_invert():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(8, 40)).astype(np.float32)
    cov = a @ a.T / 39
    for fn, jfn in ((wct.matrix_sqrt, j_wct.matrix_sqrt),
                    (wct.matrix_inv_sqrt, j_wct.matrix_inv_sqrt)):
        np.testing.assert_allclose(fn(_t(cov)).numpy(),
                                   np.asarray(jfn(jnp.asarray(cov))),
                                   rtol=1e-3, atol=1e-4)
    eye = (wct.matrix_sqrt(_t(cov)) @ wct.matrix_inv_sqrt(_t(cov))).numpy()
    np.testing.assert_allclose(eye, np.eye(8), atol=2e-3)
    with pytest.raises(ValueError, match="unknown WCT method"):
        wct.whiten_and_color(_t(a), _t(a), "svd")


def test_wct_fuse_keeps_its_type_under_autocast():
    """Under a bfloat16 autocast (compute_dtype: bfloat16) the covariances
    and eigendecompositions stay float32."""
    g = torch.Generator().manual_seed(0)
    cf, sf = torch.randn(2, 1, 6, 6, 8, generator=g)
    ref = wct.wct_fuse(cf, sf)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = wct.wct_fuse(cf, sf)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_wct_fuse_stops_the_gradient():
    cf = torch.randn(1, 4, 4, 8, requires_grad=True)
    sf = torch.randn(1, 4, 4, 8, requires_grad=True)
    assert not wct.wct_fuse(cf, sf).requires_grad


# ---------------------------------------------------------------- q8

def test_plans_count_scales_and_launches(adain_wide):
    _, _, _, _, bundle = adain_wide
    enc, dec = bundle.std_weights(torch.float32)
    assert [q8s.q8_eligible(w) for w, _ in enc] == [False, False, False,
                                                    True, True]
    assert [q8s.q8_eligible(w) for w, _ in dec] == [True, True, False, False,
                                                    False]
    assert q8s.std_q8_plan(enc, dec) == {"scales": 5, "B5": 4}
    narrow = build_model(load_config(dict(WIDE, network="adain",
                                          hidden_dim=16)))
    assert q8s.std_q8_plan(*narrow.std_weights(torch.float32)) == {
        "scales": 3, "B5": 2}
    none = build_model(load_config(dict(WIDE, network="wct", hidden_dim=8,
                                        rp_blocks=3)))
    assert q8s.std_q8_plan(*none.std_weights(torch.float32)) == {
        "scales": 0, "B5": 0}


@pytest.mark.parametrize("network", ["adain", "wct"])
def test_calibration_matches_rpst(network, request):
    jb, params, content, style, bundle = request.getfixturevalue(
        f"{network}_wide")
    jcal = jq8.calibrate_adain_q8 if network == "adain" \
        else jq8.calibrate_wct_q8
    ref = jcal(params, jnp.asarray(content), jnp.asarray(style))
    got = bundle.calibrate_q8(_t(content), _t(style))
    assert got["act_scales"].dtype == np.float32
    assert len(got["act_scales"]) == len(ref["act_scales"]) == 5
    np.testing.assert_allclose(got["act_scales"], ref["act_scales"],
                               rtol=2e-2)


def test_calibration_in_float32_equals_rpst_collector(adain_wide):
    """The same collector in float32 on both sides: the absmax stream, and
    so the scales, agree to 1e-6 relative... up to the conv's float32
    summation order (1e-5), which no requantization amplifies here."""
    from rpst.ops.stats import adaptive_instance_normalization as j_adain
    _, params, content, style, bundle = adain_wide
    n = content.shape[0]
    x = jnp.concatenate([jnp.asarray(content), jnp.asarray(style)], axis=0)
    _, jabs = jq8._collect_rp_sequence(
        jq8._rp_sequence_convs(params, "encoder"),
        jq8._rp_sequence_convs(params, "decoder"), x,
        lambda f: j_adain(f[:n], f[n:]), jnp.float32)
    enc, dec = bundle.std_weights(torch.float32)
    with torch.inference_mode():
        _, tabs = q8s._collect_rp_sequence(
            enc, dec, torch.cat([_t(content), _t(style)]),
            lambda f: q8s.adain(f[:n], f[n:]))
    np.testing.assert_allclose([float(a) for a in tabs],
                               [float(a) for a in jabs], rtol=1e-5)


def test_calibration_caps_the_batch_at_two(adain_wide):
    _, _, content, style, bundle = adain_wide
    c4 = np.concatenate([content, content[::-1] * 0.5])
    s4 = np.concatenate([style, style[::-1] * 0.5])
    a = bundle.calibrate_q8(_t(c4), _t(s4))
    b = bundle.calibrate_q8(_t(content), _t(style))
    np.testing.assert_array_equal(a["act_scales"], b["act_scales"])


def test_stats_q8_matches_rpst():
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (2, 32, 32, 128), dtype=np.int8)
    jm, js = jq8._stats_q8(jnp.asarray(q), 0.0123)
    m, s = q8s._stats_q8(_t(q), 0.0123)
    assert tuple(m.shape) == tuple(s.shape) == (2, 1, 1, 128)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)


def test_int8_encoder_features_bit_equal_to_rpst(adain_wide):
    """With rpst's scales at float32, the chained int8 layers give rpst's
    int8 features (its kernel in interpret mode) from the same first int8
    tensor: bit for bit, except at exact .5 requantization ties where the
    CPU compiler of rpst's interpret mode fuses ``acc * deq + bias`` into
    one rounding and the port keeps the source's two (one int8 step on under
    1e-5 of the elements; tests/test_torch_conv2d_q8.py pins that these are
    the only differences). Through the whole encoder the narrow float32
    layers come first, and their sums differ in the last bit between the
    two conv libraries, which moves a few first-quantization boundaries: at
    most one int8 step on under 0.1% of the elements."""
    _, params, content, style, bundle = adain_wide
    scales = jq8.calibrate_adain_q8(params, jnp.asarray(content),
                                    jnp.asarray(style))
    act = np.asarray(scales["act_scales"], np.float32)
    jenc = jq8._rp_sequence_convs(params, "encoder")
    j_conv_q = jq8._make_conv_q_std(jnp.float32, 16, True)
    x2 = jnp.concatenate([jnp.asarray(content), jnp.asarray(style)], axis=0)
    enc, _ = bundle.std_weights(torch.float32)
    enc_q, _ = bundle.q8_weights()
    conv_q = q8s.make_conv_q(torch.float32)

    # the chain alone, from rpst's own first int8 tensor
    xf = x2
    for k, b in jenc[:3]:
        xf = jq8._same_conv_relu(xf, k, b, jnp.float32)
    s0, s1, s2 = (float(a) for a in act[:3])
    jq = jq8.quantize_activations(xf, s0)
    tq = q8s.quantize_activations(_t(xf), s0)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    for li, (x_s, out_s) in ((3, (s0, s1)), (4, (s1, s2))):
        jq = j_conv_q(jq, x_s, *jenc[li], out_scale=out_s)
        tq = conv_q(tq, x_s, enc_q[li], out_s)
        assert tq.dtype == torch.int8
        diff = np.abs(tq.numpy().astype(np.int16) - np.asarray(jq, np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-5
        tq = _t(np.array(jq))  # go on from rpst's bits

    # the whole encoder
    jx, js = jq8._encode_std_q8(jenc, act, iter(range(len(act))), x2,
                                jnp.float32, j_conv_q)
    with torch.inference_mode():
        x, x_s = q8s._encode_std_q8(
            enc, enc_q, act, iter(range(len(act))),
            torch.cat([_t(content), _t(style)]), conv_q)
    assert x.dtype == torch.int8 and x_s == js
    diff = np.abs(x.numpy().astype(np.int16) - np.asarray(jx, np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("network", ["adain", "wct"])
def test_stylize_q8_matches_rpst_interpret(network, request):
    jb, params, content, style, bundle = request.getfixturevalue(
        f"{network}_wide")
    jc, js = jnp.asarray(content), jnp.asarray(style)
    if network == "adain":
        scales = jq8.calibrate_adain_q8(params, jc, js)
        ref = jq8.stylize_adain_q8(params, scales, jc, js, dtype=jnp.float32,
                                   interpret=True)
    else:
        scales = jq8.calibrate_wct_q8(params, jc, js)
        ref = jq8.stylize_wct_q8(params, scales, jc, js, dtype=jnp.float32,
                                 interpret=True)
    ref = np.asarray(ref)
    before = fused_conv2d_q8.launches
    got = bundle.stylize_q8(_t(content), _t(style), scales,
                            dtype=torch.float32).numpy()
    assert fused_conv2d_q8.launches == before  # the CPU launches no kernel
    psnr, mae = _psnr(got, ref), float(np.abs(got - ref).mean())
    print(f"{network} q8 f32 vs rpst interpret: PSNR {psnr:.2f} dB, MAE "
          f"{mae:.3g}, max {np.abs(got - ref).max():.3g}")
    assert np.isfinite(got).all() and psnr >= 40.0 and mae < 1e-3
    # and the quantized path stays near the float model (rpst's own gate,
    # tests/test_q8.py:171)
    std = bundle.stylize(_t(content), _t(style)).numpy()
    assert _psnr(got, std) > 30.0
    # as served: bfloat16 around the int8 layers
    bf = bundle.stylize_q8(_t(content), _t(style), scales).numpy()
    assert bf.dtype == np.float32 and _psnr(bf, std) > 30.0


def test_stylize_q8_refuses_foreign_scales(adain_wide):
    _, _, content, style, bundle = adain_wide
    with pytest.raises(ValueError, match="calibrate this model"):
        bundle.stylize_q8(_t(content), _t(style),
                          {"act_scales": np.ones(3, np.float32)})


def test_serving_entry_points_for_the_wide_families(adain_wide, wct_wide):
    for _, _, content, style, bundle in (adain_wide, wct_wide):
        assert bundle.q8_infer() and not bundle.folded_infer()
        assert resolve_mode(bundle, "q8", batch=2) == "q8"
        assert resolve_mode(bundle, "auto", batch=2) == "standard"
        assert resolve_mode(bundle, "folded") == "standard"
        c, s = _t(content), _t(style)
        scales = calibrate_scales(bundle, c, s)
        out = make_run_impl(bundle, "q8", scales)(c, s)
        ref = make_run_impl(bundle, "standard")(c, s)
        assert out.shape == ref.shape == (2, 32, 32, 3)
        assert out.dtype == torch.float32
        assert _psnr(out.numpy(), ref.numpy()) > 30.0


def test_load_state_dict_requantizes(adain_wide):
    _, _, content, style, _ = adain_wide
    bundle = build_model(load_config(dict(WIDE, network="adain")))
    from rpst_torch.nn.blocks import init_torch_default
    init_torch_default(bundle.model, 3)
    first = bundle.q8_weights()[0][3].w_scale.clone()
    bundle.load_state_dict({k: v * 0.5 for k, v in
                            bundle.model.state_dict().items()})
    torch.testing.assert_close(bundle.q8_weights()[0][3].w_scale, first * 0.5)


@pytest.mark.parametrize("network", ["adain", "wct"])
def test_port_matches_the_wide_fixture(network):
    """tests/fixtures/torch_port_{adain,wct}.npz (64px, hidden 32, weights
    from ``rpseq_weights_from_seed``) hold rpst's outputs; chip_smoke.py
    holds the card to them, and here the CPU: standard float32 to 1e-4
    (wct 1e-3), q8 float32 with rpst's scales to PSNR >= 40 dB and MAE <
    2e-3 (the output spans 0..1; see chip_smoke.py phase 18 for the
    reason)."""
    from rpst_torch.bridge import rpseq_weights_from_seed
    with np.load(REPO / "tests" / "fixtures" /
                 f"torch_port_{network}.npz") as npz:
        fx = {k: npz[k] for k in npz.files}
    assert fx["content"].shape == (2, 64, 64, 3)
    bundle = build_model(load_config(dict(WIDE, network=network,
                                          img_size=64)))
    bundle.load_state_dict(from_flax_params(rpseq_weights_from_seed(
        int(fx["weights_seed"]))))
    c, s = _t(fx["content"]), _t(fx["style"])
    tol = 1e-4 if network == "adain" else 1e-3
    np.testing.assert_allclose(bundle.stylize(c, s).numpy(), fx["out_f32"],
                               rtol=tol, atol=tol)
    assert fx["out_f32"].max() - fx["out_f32"].min() > 0.3  # a live signal
    got = bundle.stylize_q8(c, s, {"act_scales": fx["act_scales"]},
                            dtype=torch.float32).numpy()
    assert _psnr(got, fx["out_q8_f32"]) >= 40.0
    assert float(np.abs(got - fx["out_q8_f32"]).mean()) < 2e-3


# ------------------------------------------------ the slice as a whole (CLI)

def test_serve_torch_q8_adain_cpu(tmp_path):
    """serve_torch.py --device cpu --mode q8 for adain at full width: one
    PNG per content image, 5 calibrated scales, no kernel launched."""
    from PIL import Image
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8),
                        "RGB").save(tmp_path / "content" / f"{i:02d}.png")
    Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8),
                    "RGB").save(tmp_path / "style" / "s.png")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(json.dumps(dict(WIDE, network="adain")))
    proc = subprocess.run(
        [sys.executable, str(REPO / "serve_torch.py"), "--config", str(cfg),
         "--content", str(tmp_path / "content"), "--style",
         str(tmp_path / "style" / "s.png"), "--out", str(tmp_path / "out"),
         "--device", "cpu", "--mode", "q8", "--batch", "2"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Calibrated 5 layer scales" in proc.stderr
    assert re.search(r"B5 fused_conv2d_q8 launches: 0", proc.stderr)
    pngs = sorted((tmp_path / "out").glob("*.png"))
    assert [p.name for p in pngs] == [f"{i:02d}-s.png" for i in range(3)]
    for p in pngs:
        assert np.asarray(Image.open(p)).shape == (32, 32, 3)
