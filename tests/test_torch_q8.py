"""The port's int8 (q8) serving path against rpst on the CPU: quantizers,
B4's and B7's plain versions against rpst's kernels in interpret mode and
against a numpy integer oracle, the AdaIN statistics helpers, calibration,
and the whole q8 stylize against the JAX fixture and against live rpst.
Same numpy-seeded inputs on both sides.

Tolerances, each with its reason:
  * int8 outputs and quantized weights/activations: bit-equal. The int32
    sums are exact on both sides and the float32 epilogue rounds the same.
  * bf16 outputs of B4: bit-equal (one rounding of the same float32 value).
  * channel sums s1/s2: rtol 1e-4, atol 1e-3, rpst's own gate
    (tests/test_q8.py:213-218): float32 sums taken in another order.
  * statistics from sums: rtol 1e-5 (float32 rounding of the same formula).
  * calibration scales: rtol 2e-2, since rpst and the port both calibrate
    on a bfloat16 forward and round its convs at different places.
  * the whole stylize at float32: PSNR >= 40 dB and MAE < 1e-3 against rpst,
    the gate chip_smoke.py holds the card to: a one-ulp difference in a
    float AdaIN statistic can move a decoder requantization boundary by one
    int8 step at a few elements.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.config import load_config as j_load_config
from rpst.models import build_model as j_build_model
from rpst.models import fast_path_q8 as jq8
from rpst.ops.pallas.folded_conv2_q8 import \
    fused_folded_conv2_q8 as j_conv2_q8
from rpst.ops.pallas.folded_conv_q8 import fused_folded_conv_q8 as j_conv_q8
from rpst.ops.pallas.folded_conv_q8 import (
    quantize_activations as j_quantize_activations)
from rpst.ops.pallas.folded_conv_q8 import quantize_weights as j_quantize_w
from rpst_torch.bridge import from_flax_params, load_weights
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.models import fast_path_q8 as q8
from rpst_torch.ops.folded_conv import fused_folded_conv
from rpst_torch.ops.folded_conv2_q8 import (fused_folded_conv2_q8,
                                            fused_folded_conv2_q8_plain)
from rpst_torch.ops.folded_conv_q8 import (fused_folded_conv_q8,
                                           fused_folded_conv_q8_plain,
                                           quantize_activations,
                                           quantize_weights)
from rpst_torch.serving import calibrate_scales, make_run_impl, resolve_mode
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
Q8_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_q8.npz"
FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=5,
                hidden_dim=32, inception_num=0, attention="none")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layer(rng, n, h, w, c4, c4o, out_scale=0.05):
    """Random int8 input and weights, realistic float32 scale rows."""
    x = rng.integers(-127, 128, (n, h, w, c4), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c4, c4o), dtype=np.int8)
    deq = rng.uniform(2e-6, 6e-6, c4o).astype(np.float32)
    bias = rng.normal(0, 0.2, c4o).astype(np.float32)
    inv = np.full(c4o, np.float32(1.0 / out_scale), np.float32)
    return x, k, np.stack([deq, bias, inv])


def _psnr(got, ref):
    mse = float(np.mean((got - ref) ** 2))
    span = float(ref.max() - ref.min()) or 1.0
    return 10 * np.log10(span * span / max(mse, 1e-30))


# ---------------------------------------------------------------- quantizers

def test_quantize_weights_matches_rpst_with_ties(rng):
    """Per-output-channel absmax 127 gives scale 1, so the .5 entries are
    exact ties: both sides must round half to even (2.5 -> 2, 3.5 -> 4)."""
    w = rng.normal(0, 0.3, (3, 3, 16, 8)).astype(np.float32)
    ties = np.array([0.5, 1.5, 2.5, -2.5, -3.5, 126.5], np.float32)
    w[0, 0, :6, :] = ties[:, None]
    w[2, 2, 15, :] = 127.0  # every column's absmax: scale exactly 1
    q, s = quantize_weights(_t(w))
    jq, js = j_quantize_w(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, :6, 0].tolist() == [0, 2, 2, -2, -4, 126]
    # random float32 kernels of the flagship's folded widths
    w = rng.normal(0, 0.05, (3, 3, 128, 128)).astype(np.float32)
    q, s = quantize_weights(_t(w))
    jq, js = j_quantize_w(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_activations_matches_rpst_with_ties(rng):
    scale = 0.25
    x = np.concatenate([np.arange(-40, 41, dtype=np.float32) * 0.125,
                        rng.normal(0, 20, 500).astype(np.float32)])
    got = quantize_activations(_t(x), scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        j_quantize_activations(jnp.asarray(x), scale)))
    assert got[40 + 1] == 0 and got[40 + 3] == 2  # 0.5 -> 0, 1.5 -> 2
    assert got.min() == -127 and got.max() == 127  # clipped, never -128
    x = rng.normal(0, 1, (2, 8, 8, 32)).astype(np.float32)
    s = float(np.abs(x).max()) / 127.0
    np.testing.assert_array_equal(
        quantize_activations(_t(x), s).numpy(),
        np.asarray(j_quantize_activations(jnp.asarray(x), s)))


# ---------------------------------------------------------------- B4

@pytest.mark.parametrize("out_int8", [True, False])
@pytest.mark.parametrize("with_stats", [False, True])
def test_b4_plain_matches_rpst_interpret(rng, out_int8, with_stats):
    x, k, sc = _layer(rng, 2, 8, 8, 128, 128)
    got = fused_folded_conv_q8(_t(x), _t(k), _t(sc), out_int8, with_stats)
    ref = j_conv_q8(jnp.asarray(x), jnp.asarray(k), jnp.asarray(sc),
                    out_int8=out_int8, with_stats=with_stats,
                    block_rows=4, interpret=True)
    if not with_stats:
        got, ref = (got,), (ref,)
    out, jout = got[0], np.asarray(ref[0])
    assert out.dtype == (torch.int8 if out_int8 else torch.bfloat16)
    if out_int8:
        np.testing.assert_array_equal(out.numpy(), jout)
        assert len(np.unique(jout)) > 50  # a real spread of int8 codes
    else:
        np.testing.assert_array_equal(out.float().numpy(),
                                      jout.astype(np.float32))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-3)


def _np_reflect_folded(x):
    """Independent oracle of the folded reflect ring: unfold to the image,
    np.pad(mode='reflect') by two original pixels on each side (the one
    folded ring), refold."""
    n, hh, ww, c4 = x.shape
    c = c4 // 4
    img = x.reshape(n, hh, ww, 2, 2, c).transpose(0, 1, 3, 2, 4, 5) \
        .reshape(n, 2 * hh, 2 * ww, c)
    p = np.pad(img, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="reflect")
    return p.reshape(n, hh + 2, 2, ww + 2, 2, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(n, hh + 2, ww + 2, c4)


def test_b4_plain_matches_numpy_integer_oracle(rng):
    """int64 sums over np.pad's reflect ring (no code shared with the port
    or rpst), the float32 epilogue in numpy, on a ragged 2x6x5 input."""
    x, k, sc = _layer(rng, 2, 6, 5, 32, 16)
    xp = _np_reflect_folded(x.astype(np.int64))
    h, w = x.shape[1:3]
    acc = sum(np.einsum("nhwi,io->nhwo", xp[:, dr:dr + h, dc:dc + w],
                        k[dr, dc].astype(np.int64))
              for dr in range(3) for dc in range(3))
    y = acc.astype(np.float32) * sc[0] + sc[1]
    y = np.where(y >= 0, y, np.float32(0.2) * y)
    want = np.clip(np.round(y * sc[2]), -127, 127).astype(np.int8)
    got, s1, s2 = fused_folded_conv_q8(_t(x), _t(k), _t(sc), True, True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(s1.numpy(), y.sum(axis=(1, 2)), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(s2.numpy(), (y * y).sum(axis=(1, 2)),
                               rtol=1e-4, atol=1e-3)


def test_b4_contract_and_cpu_count(rng):
    x, k, sc = _layer(rng, 1, 4, 4, 32, 16)
    before = fused_folded_conv_q8.launches
    fused_folded_conv_q8(_t(x), _t(k), _t(sc), True)
    assert fused_folded_conv_q8.launches == before  # CPU: plain, no launch
    with pytest.raises(TypeError, match="int8"):
        fused_folded_conv_q8(_t(x).float(), _t(k), _t(sc), True)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_folded_conv_q8(_t(x[..., :24]), _t(k[:, :, :24]), _t(sc), True)
    with pytest.raises(ValueError, match="scales"):
        fused_folded_conv_q8(_t(x), _t(k), _t(sc[:2]), True)
    with pytest.raises(ValueError, match="contiguous"):
        fused_folded_conv_q8(_t(x).transpose(1, 2), _t(k), _t(sc), True)


# ---------------------------------------------------------------- B7

@pytest.mark.parametrize("out_int8", [True, False])
def test_b7_plain_matches_rpst_and_two_b4(rng, out_int8):
    x, k1, sc1 = _layer(rng, 1, 8, 8, 128, 128)
    _, k2, sc2 = _layer(rng, 1, 8, 8, 128, 128, out_scale=0.02)
    got = fused_folded_conv2_q8(_t(x), _t(k1), _t(sc1), _t(k2), _t(sc2),
                                out_int8=out_int8, with_stats=True)
    ref = j_conv2_q8(jnp.asarray(x), jnp.asarray(k1), jnp.asarray(sc1),
                     jnp.asarray(k2), jnp.asarray(sc2), out_int8=out_int8,
                     block_rows=4, with_stats=True, interpret=True)
    y1, s11, s12 = fused_folded_conv_q8_plain(_t(x), _t(k1), _t(sc1), True,
                                              True)
    y2, s21, s22 = fused_folded_conv_q8_plain(y1, _t(k2), _t(sc2), out_int8,
                                              True)
    for g, r, two in zip(got, ref, (y1, y2, s11, s12, s21, s22)):
        np.testing.assert_array_equal(g.float().numpy(),
                                      two.float().numpy())
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-3)
        else:
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(r).astype(np.float32))
    y1_only, y2_only = fused_folded_conv2_q8_plain(
        _t(x), _t(k1), _t(sc1), _t(k2), _t(sc2), out_int8)
    assert torch.equal(y1_only, got[0]) and torch.equal(y2_only, got[1])


def test_b7_contract(rng):
    x, k1, sc1 = _layer(rng, 1, 4, 4, 32, 16)
    _, k2, sc2 = _layer(rng, 1, 4, 4, 16, 8)
    fused_folded_conv2_q8(_t(x), _t(k1), _t(sc1), _t(k2), _t(sc2))
    with pytest.raises(ValueError, match="3, 3, 16"):
        fused_folded_conv2_q8(_t(x), _t(k1), _t(sc1), _t(k1), _t(sc1))
    x, k1, sc1 = _layer(rng, 1, 4, 4, 32, 256)
    _, k2, sc2 = _layer(rng, 1, 4, 4, 256, 16)
    with pytest.raises(ValueError, match="at most 128"):
        fused_folded_conv2_q8(_t(x), _t(k1), _t(sc1), _t(k2), _t(sc2))


# ---------------------------------------------------------------- statistics

def test_stats_from_sums_matches_rpst(rng):
    s1 = rng.normal(0, 50, (2, 128)).astype(np.float32)
    s2 = (np.abs(rng.normal(0, 200, (2, 128))) + s1 ** 2 / 4096) \
        .astype(np.float32)
    got = q8._stats_from_sums(_t(s1), _t(s2), 4096)
    ref = jq8._stats_from_sums(jnp.asarray(s1), jnp.asarray(s2), 4096)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5)


def test_folded_stats_q8_matches_rpst(rng):
    q = rng.integers(-127, 128, (2, 16, 16, 128), dtype=np.int8)
    got = q8._folded_stats_q8(_t(q), 0.0123)
    ref = jq8._folded_stats_q8(jnp.asarray(q), 0.0123)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5)


# ---------------------------------------------------------------- the model

def _live_pair(rng, size=32, rp_blocks=3, n=1):
    """rpst params and the port bundle with the same weights, hidden 32 (a
    narrower stack has no int8 layer)."""
    cfg = dict(FLAGSHIP, rp_blocks=rp_blocks, img_size=size)
    content = rng.random((n, size, size, 3), dtype=np.float32)
    style = rng.random((n, size, size, 3), dtype=np.float32)
    jb = j_build_model(j_load_config(cfg))
    params = jb.model.init(jax.random.PRNGKey(0), jnp.asarray(content),
                           jnp.asarray(style))["params"]
    bundle = build_model(load_config(dict(cfg, exec_strategy="folded")))
    bundle.load_state_dict(from_flax_params(params))
    return params, content, style, bundle


def test_calibration_matches_rpst(rng):
    params, content, style, bundle = _live_pair(rng, n=2)
    ref = jq8.calibrate_multi_adain_q8(params, jnp.asarray(content),
                                       jnp.asarray(style))["act_scales"]
    got = calibrate_scales(bundle, _t(content), _t(style))["act_scales"]
    assert got.dtype == np.float32 and got.shape == ref.shape == (8,)
    np.testing.assert_allclose(got, ref, rtol=2e-2)


@pytest.mark.parametrize("fuse_pairs", [False, True])
def test_q8_stylize_matches_live_rpst(rng, fuse_pairs):
    """32px, rp_blocks 3, hidden 32 (2 int8 encoder layers per encode, so
    fuse_pairs runs one B7 pair each), float32, rpst's scales fed to both."""
    params, content, style, bundle = _live_pair(rng)
    c, s = jnp.asarray(content), jnp.asarray(style)
    scales = jq8.calibrate_multi_adain_q8(params, c, s)
    ref = np.asarray(jq8.stylize_multi_adain_folded_q8(
        params, scales, c, s, dtype=jnp.float32, interpret=True,
        fuse_pairs=fuse_pairs))
    got = bundle.stylize_q8(_t(content), _t(style), scales,
                            dtype=torch.float32, fuse_pairs=fuse_pairs)
    got = got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _psnr(got, ref) >= 40 and np.abs(got - ref).mean() < 1e-3


def _fixture_bundle():
    fx = np.load(Q8_FIXTURE)
    size = fx["content"].shape[1]
    bundle = build_model(load_config(dict(FLAGSHIP, img_size=size)))
    bundle.load_state_dict(load_weights(Q8_FIXTURE))
    return fx, bundle


@pytest.mark.parametrize("dtype,key", [(torch.float32, "out_f32"),
                                       (torch.bfloat16, "out_bf16")])
def test_q8_stylize_matches_fixture(dtype, key):
    """The full-width flagship (rp5, hidden 32) at 64px against rpst's
    interpret-mode output in the fixture, with its act scales."""
    fx, bundle = _fixture_bundle()
    scales = {"act_scales": fx["act_scales"]}
    got = bundle.stylize_q8(_t(fx["content"]), _t(fx["style"]), scales,
                            dtype=dtype).numpy()
    ref = fx[key]
    assert _psnr(got, ref) >= 40 and np.abs(got - ref).mean() < 1e-3


def test_q8_encoder_features_match_fixture():
    """The content encode's int8 features are bit-equal to rpst's, and the
    statistics from the kernel sums agree to float32 rounding."""
    fx, bundle = _fixture_bundle()
    enc, _ = bundle.folded_weights(torch.float32)
    enc_q, _ = bundle.q8_weights()
    with torch.inference_mode():
        feats, stats = q8._encode_q8(enc, enc_q, fx["act_scales"],
                                     iter(range(len(fx["act_scales"]))),
                                     _t(fx["content"]), torch.float32, False)
    assert [st is None for st in stats] == [True, False, False, False, False]
    for i, ((q, scale), st) in enumerate(zip(feats, stats)):
        np.testing.assert_array_equal(q.numpy(), fx[f"enc_q_{i}"])
        assert np.float32(scale) == fx[f"enc_scale_{i}"]
        if st is not None:
            np.testing.assert_allclose(st[0].numpy(), fx[f"enc_mean_{i}"],
                                       rtol=1e-4, atol=1e-7)
            np.testing.assert_allclose(st[1].numpy(), fx[f"enc_std_{i}"],
                                       rtol=1e-4)


def test_q8_plan_counts_the_flagship():
    """14 act scales; per stylize 3 B1 (12->128 twice, 128->12) and 12 B4,
    or 4 B7 + 4 B4 with fuse_pairs: derived from the layers, not copied."""
    _, bundle = _fixture_bundle()
    enc, dec = bundle.folded_weights(torch.float32)
    ks = [k for k, _ in enc], [k for k, _ in dec]
    assert q8.q8_plan(*ks, False) == {"scales": 14, "B1": 3, "B4": 12,
                                      "B7": 0}
    assert q8.q8_plan(*ks, True) == {"scales": 14, "B1": 3, "B4": 4,
                                     "B7": 4}


def test_q8_serving_path_on_cpu(rng):
    """resolve_mode -> calibrate_scales -> make_run_impl on the CPU:
    fuse_pairs is bit-equal, no kernel launches, weights cached and
    dropped by weights_changed; a wrong scale count raises."""
    bundle = build_model(load_config(dict(FLAGSHIP, rp_blocks=3,
                                          img_size=16)))
    assert resolve_mode(bundle, "q8") == "q8"
    c = _t(rng.random((2, 16, 16, 3), dtype=np.float32))
    s = _t(rng.random((2, 16, 16, 3), dtype=np.float32))
    scales = calibrate_scales(bundle, c, s)
    counts = (fused_folded_conv.launches, fused_folded_conv_q8.launches,
              fused_folded_conv2_q8.launches)
    run = make_run_impl(bundle, "q8", scales)
    y = run(c, s)
    assert y.shape == (2, 16, 16, 3) and torch.isfinite(y).all()
    assert torch.equal(y, bundle.stylize_q8(c, s, scales, fuse_pairs=True))
    assert counts == (fused_folded_conv.launches,
                      fused_folded_conv_q8.launches,
                      fused_folded_conv2_q8.launches)
    first = bundle.q8_weights()
    assert bundle.q8_weights() is first
    bundle.weights_changed()
    assert bundle.q8_weights() is not first
    with pytest.raises(ValueError, match="act scales"):
        bundle.stylize_q8(c, s, {"act_scales": scales["act_scales"][:-1]})
    with pytest.raises(ValueError, match="calibrate_scales"):
        make_run_impl(bundle, "q8")
