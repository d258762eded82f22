"""The adaptive SANet of the port (``dynamic_sanet``: ``rpst_torch.ops.
affinity``, ``ops.adaptive_attention``, the adaptive parts of ``models.
sanet``, ``fast_path_q8_std``, ``bridge`` and the two drivers) on the CPU,
against rpst's op and flax modules with bridged weights, and against
``tests/fixtures/torch_port_dynamic_sanet.npz`` (rpst's stylize on its dense
and streamed routes, the claim maps, the int8 stylize in interpret mode, the
loss parts and gradients at 64px, batch 2, the model's fixed width of 512,
``configs/train_dynamic_sanet.yaml``'s ``ada_module: relu``).

Tolerances: the attention op's O to 1e-4 of max |ref| (its own size: with
``aea`` most weights are ~1e-9, so an absolute 1e-4 would pass a zero
attention), its gradients rpst's 2e-4 (tests/test_adaptive_blockwise.py);
float32 modules 1e-4 (rtol = atol); the model 1e-4, streamed against
dense 1e-3 (rpst's own). Behind the softmax the two frameworks' float32
rounding of the VGG features (~4e-6 of max at relu5_1, amplified by the
mean-variance normalization of low-variance channels) shows: the claim maps
P and w are held to 2e-3 x max |ref|, the aea model's output (sigmoid of
50 (P - c)) to 1e-3, the gradients of the f, g and psi leaves to atol 2e-3
x max (the others rtol 5e-3, atol 1e-4 x max), as tests/test_torch_sanet.py
sets them; loss parts rtol 1e-4. q8 with rpst's scales: the transform and
int8 decode on rpst's own int8 taps PSNR >= 40 dB in float32; end to end 35
dB in float32 (the card's sanet limit) and 30 dB in bfloat16, because the
int8 VGG chain differs from rpst's interpret mode by one-step flips (its
fused multiply-add at .5 ties, tests/test_torch_conv2d_q8.py), which the
adaptive transform amplifies (the static sanet reads 45 dB on the same
chain); calibration scales 2e-2.
"""

import importlib.util
import json
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

from rpst.models.sanet import AdaptiveSANetAttention as JaxAdaptiveAttention
from rpst.models.sanet import AdaptiveTransform as JaxAdaptiveTransform
from rpst.models.sanet import AEALReluModule as JaxAEALRelu
from rpst.models.sanet import AEAModule as JaxAEA
from rpst.ops.adaptive_attention import \
    adaptive_reweighted_attention as jax_attention
from rpst.ops.affinity import cal_affinity_matrix as jax_affinity
from rpst_torch.bridge import (PSI_NAMES, dynamic_sanet_weights_from_seed,
                               from_flax_params, from_reference_checkpoint,
                               vgg_from_flax, vgg_weights_from_seed)
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.models.fast_path_q8_std import (_mirror_decode_q8,
                                                _sanet_transform,
                                                _ScaleStream, make_conv_q,
                                                sanet_blocks, sanet_q8_plan,
                                                vgg_q8_plan)
from rpst_torch.models.sanet import (AdaptiveSANetAttention,
                                     AdaptiveTransform, AEALReluModule,
                                     AEAModule, SAModel)
from rpst_torch.nn.blocks import init_torch_default
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.ops.adaptive_attention import (adaptive_attention_dense,
                                               adaptive_reweighted_attention)
from rpst_torch.ops.affinity import cal_affinity_matrix
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_port_dynamic_sanet.npz"
YAML = REPO / "configs" / "train_dynamic_sanet.yaml"
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_KEYS = ("content_loss", "style_loss", "l_identity1_loss",
             "l_identity2_loss", "total_loss")
MODULES = {"aea": (JaxAEA, AEAModule), "relu": (JaxAEALRelu, AEALReluModule)}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _psnr(got, ref):
    mse = float(np.mean((got.astype(np.float64) - ref) ** 2))
    span = float(ref.max() - ref.min())
    return 10 * np.log10(span * span / max(mse, 1e-30))


def _assert_own_size(got, ref, rel, what):
    """max |got - ref| <= rel x max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    size = np.abs(ref).max()
    assert size > 0, what
    err = np.abs(got - ref).max()
    assert err <= rel * size, f"{what}: max abs err {err} > {rel} x {size}"


def _attention_inputs(seed, n, p, q, c):
    """Random F, G, H and clamps in [0.3, 0.9] (rpst's
    test_adaptive_blockwise.py): logits of standard deviation sqrt(C), so
    the softmax peaks and P crosses the thresholds."""
    rng = np.random.default_rng(seed)
    f, g, h = (rng.normal(size=(n, k, c)).astype(np.float32)
               for k in (p, q, q))
    clamp = rng.uniform(0.3, 0.9, size=(n, p, 1)).astype(np.float32)
    return f, g, h, clamp


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as npz:
        return {k: npz[k] for k in npz.files}


def _bundle(fx, **over):
    size = fx["content"].shape[1]
    cfg = load_config({**dict(network="dynamic_sanet", img_size=size,
                              ada_module="relu", content_weight=1.0,
                              style_weight=3.0), **over})
    b = build_model(cfg)
    b.load_state_dict(from_flax_params(dynamic_sanet_weights_from_seed(
        int(fx["weights_seed"]), size)))
    vgg = VGG19Encoder(5)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]), 5)))
    b.vgg = vgg
    return b


@pytest.fixture(scope="module")
def bundle(fx):
    return _bundle(fx)


# ------------------------------------------------------------- the ops

@pytest.mark.parametrize("hw_c,hw_s", [((5, 7), (6, 4)), ((8, 8), (8, 8))])
def test_cal_affinity_matrix_matches_rpst(hw_c, hw_s):
    rng = np.random.default_rng(0)
    c = rng.normal(size=(2, *hw_c, 16)).astype(np.float32)
    s = rng.normal(size=(2, *hw_s, 16)).astype(np.float32)
    s[0, 0, 0] = 0.0  # a zero row: the 1e-12 clamp, no division by zero
    ref = np.asarray(jax_affinity(jnp.asarray(c), jnp.asarray(s)))
    got = cal_affinity_matrix(torch.from_numpy(c), torch.from_numpy(s))
    assert got.shape == (2, hw_c[0] * hw_c[1], hw_s[0] * hw_s[1])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["aea", "aea_lrelu"])
@pytest.mark.parametrize("block_q", [16, 32])
def test_adaptive_attention_matches_rpst_and_dense(variant, block_q):
    """The streamed op (ragged last block: 90 rows) and the dense form
    against rpst's op and its dense reference, O held to its own size."""
    f, g, h, clamp = _attention_inputs(1, 2, 90, 80, 32)
    ref = np.asarray(jax_attention(*(jnp.asarray(a) for a in (f, g, h,
                                                              clamp)),
                                   variant=variant, block_q=block_q))
    tf, tg, th, tc = (torch.from_numpy(a) for a in (f, g, h, clamp))
    got = adaptive_reweighted_attention(tf, tg, th, tc, variant,
                                        block_q=block_q)
    dense, prob, w = adaptive_attention_dense(tf, tg, th, tc, variant)
    assert got.shape == dense.shape == (2, 90, 32)
    _assert_own_size(got.numpy(), ref, 1e-4, "streamed vs rpst")
    _assert_own_size(dense.numpy(), ref, 1e-4, "dense vs rpst")
    # the thresholds bite: P crosses c in some entries, not in most
    crossed = float((prob > tc).float().mean())
    assert 0.0 < crossed < 0.5
    if variant == "aea":
        assert float(w.max()) > 0.5 and float(w.median()) < 1e-6
    else:
        np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("variant", ["aea", "aea_lrelu"])
@pytest.mark.parametrize("block_q", [16, 32])
def test_adaptive_attention_grads_match_rpst(variant, block_q):
    """dF, dG, dH and dclamp of the streamed op (each block under
    torch.utils.checkpoint) against rpst's op under jax.grad."""
    f, g, h, clamp = _attention_inputs(2, 1, 72, 64, 16)
    d_o = np.random.default_rng(3).normal(size=(1, 72, 16)).astype(
        np.float32)

    def loss(*args):
        return jnp.sum(jax_attention(*args, variant=variant,
                                     block_q=block_q) * d_o)

    refs = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (f, g, h, clamp)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (f, g, h, clamp)]
    out = adaptive_reweighted_attention(*ts, variant, block_q=block_q)
    assert out.grad_fn is not None
    (out * torch.from_numpy(d_o)).sum().backward()
    for name, t, ref in zip("FGHc", ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_adaptive_attention_rejects_unknown_variant():
    f, g, h, clamp = (torch.from_numpy(a)
                      for a in _attention_inputs(0, 1, 4, 4, 2))
    with pytest.raises(ValueError, match="variant"):
        adaptive_reweighted_attention(f, g, h, clamp, "relu")
    with pytest.raises(ValueError, match="variant"):
        adaptive_attention_dense(f, g, h, clamp, "sigmoid")


# ------------------------------------------------------------- the modules

def _port_aea(ada_module, params):
    mod = MODULES[ada_module][1](params["psi0"]["kernel"].shape[0])
    sd = from_flax_params({"aea": _np_tree(params)})
    mod.load_state_dict({k.split("attention_layer.")[1]: v
                         for k, v in sd.items()})
    return mod


@pytest.mark.parametrize("ada_module", ["aea", "relu"])
def test_both_threshold_routes_match_flax(ada_module):
    """thresholds (dense affinity rows) and thresholds_factorized (the
    affinity's factors) against flax, on the same psi0 / psi1."""
    rng = np.random.default_rng(4)
    n, hw_c, hw_s, c = 2, 20, 48, 16
    cn = rng.normal(size=(n, hw_c, c)).astype(np.float32)
    sn = rng.normal(size=(n, hw_s, c)).astype(np.float32)
    cn /= np.linalg.norm(cn, axis=2, keepdims=True)
    sn /= np.linalg.norm(sn, axis=2, keepdims=True)
    aff = np.einsum("npc,nqc->npq", cn, sn)
    f_x = rng.random((n, hw_c, hw_s)).astype(np.float32)
    jmod = MODULES[ada_module][0](hw_s)
    params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(aff),
                       jnp.asarray(f_x))["params"]
    ref_dense = np.asarray(jmod.apply({"params": params}, jnp.asarray(aff),
                                      method=jmod.thresholds))
    ref_fact = np.asarray(jmod.apply({"params": params}, jnp.asarray(cn),
                                     jnp.asarray(sn),
                                     method=jmod.thresholds_factorized))
    mod = _port_aea(ada_module, params)
    with torch.no_grad():
        np.testing.assert_allclose(
            mod.thresholds(torch.from_numpy(aff)).numpy(), ref_dense, **TOL)
        got_fact = mod.thresholds_factorized(torch.from_numpy(cn),
                                             torch.from_numpy(sn)).numpy()
        np.testing.assert_allclose(got_fact, ref_fact, **TOL)
        np.testing.assert_allclose(got_fact, ref_dense, **TOL)
    assert mod.f_psi[0].weight.shape == (hw_s // 16, hw_s)


def _flax_attention(ada_module, c, s, blockwise):
    jmod = JaxAdaptiveAttention(64, s.shape[1] * s.shape[2], ada_module,
                                blockwise)
    params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(c),
                       jnp.asarray(s))["params"]
    return jmod, params


@pytest.mark.parametrize("ada_module", ["aea", "relu"])
def test_adaptive_attention_module_matches_flax(ada_module):
    """AdaptiveSANetAttention on both routes against flax's, one weight
    set; bfloat16 features run in float32, as rpst's modules do."""
    rng = np.random.default_rng(7)
    c = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    s = rng.normal(size=(2, 6, 8, 64)).astype(np.float32)
    jmod, params = _flax_attention(ada_module, c, s, "never")
    att = AdaptiveSANetAttention(64, 48, ada_module)
    att.load_state_dict(from_flax_params(_np_tree(params)))
    for blockwise, streamed in (("never", False), ("always", True)):
        jm = JaxAdaptiveAttention(64, 48, ada_module, blockwise)
        ref, ref_aux = jm.apply({"params": params}, jnp.asarray(c),
                                jnp.asarray(s))
        with torch.no_grad():
            got, aux = att(torch.from_numpy(c), torch.from_numpy(s),
                           streamed)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        assert sorted(aux) == sorted(ref_aux)
        for k in aux:
            np.testing.assert_allclose(aux[k].numpy(),
                                       np.asarray(ref_aux[k]), **TOL)
    with torch.no_grad():
        half, _ = att(torch.from_numpy(c).bfloat16(),
                      torch.from_numpy(s).bfloat16())
    assert half.dtype == torch.float32


@pytest.mark.parametrize("ada_module", ["aea", "relu"])
def test_adaptive_transform_matches_flax(ada_module):
    rng = np.random.default_rng(8)
    c4, s4 = (rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
              for _ in range(2))
    c5, s5 = (rng.normal(size=(2, 4, 4, 64)).astype(np.float32)
              for _ in range(2))
    args = [jnp.asarray(a) for a in (c4, s4, c5, s5)]
    jmod = JaxAdaptiveTransform(64, 64, 16, ada_module, "never")
    params = jmod.init(jax.random.PRNGKey(9), *args)["params"]
    ref, ref_aux = jmod.apply({"params": params}, *args)
    tr = AdaptiveTransform(64, 64, 16, ada_module, "never")
    tr.load_state_dict(from_flax_params(_np_tree(params)))
    with torch.no_grad():
        got, aux = tr(*(torch.from_numpy(a) for a in (c4, s4, c5, s5)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        aux["relu5_1"]["claim_value"].numpy(),
        np.asarray(ref_aux["relu5_1"]["claim_value"]), **TOL)


# ------------------------------------------------------------- the model

def test_stylize_dense_and_streamed_match_rpst(fx):
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    outs = {}
    for blockwise, key in (("never", "out_f32"), ("always", "out_f32_always"),
                           ("auto", "out_f32")):  # auto: dense on the CPU
        b = _bundle(fx, adaptive_blockwise=blockwise)
        outs[blockwise] = b.stylize(c, s)
        assert outs[blockwise].dtype == torch.float32
        np.testing.assert_allclose(outs[blockwise].numpy(), fx[key], **TOL,
                                   err_msg=blockwise)
    np.testing.assert_allclose(outs["always"].numpy(), outs["never"].numpy(),
                               rtol=1e-3, atol=1e-3)
    aea = _bundle(fx, ada_module="aea", adaptive_blockwise="never")
    np.testing.assert_allclose(aea.stylize(c, s).numpy(), fx["out_f32_aea"],
                               rtol=1e-3, atol=1e-3)
    assert not np.allclose(fx["out_f32_aea"], fx["out_f32"], atol=1e-2)


def test_stylize_with_aux_returns_rpst_claim_maps(bundle, fx):
    """The dense route is forced whatever adaptive_blockwise says."""
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    bundle.model.transform.blockwise = "always"
    try:
        out, aux = bundle.stylize_with_aux(c, s)
    finally:
        bundle.model.transform.blockwise = "auto"
    np.testing.assert_allclose(out.numpy(), fx["out_f32"], **TOL)
    keys = sorted(k for k in fx if k.startswith("aux/"))
    assert len(keys) == 6
    for key in keys:
        _, layer, name = key.split("/")
        if name == "claim_value":
            np.testing.assert_allclose(aux[layer][name].numpy(), fx[key],
                                       **TOL, err_msg=key)
        else:
            _assert_own_size(aux[layer][name].numpy(), fx[key], 2e-3, key)
    static = build_model(load_config(dict(network="sanet", img_size=32)))
    static.vgg = VGG19Encoder(5)
    assert static.stylize_with_aux(c[:, :32, :32], s[:, :32, :32])[1] == {}


def _port_grad(params, path):
    """The port's gradient of rpst's leaf ``path`` in rpst's layout."""
    name = "." + path.replace("/", ".")
    for k, v in PSI_NAMES.items():
        name = name.replace(k, v)
    grad = params[name[1:].replace("kernel", "weight")].grad
    return grad.t() if grad.ndim == 2 else grad


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
        grad = _port_grad(params, path)
        if path.endswith("/g/bias"):
            # a bias on the keys shifts all of a query's logits alike
            f_grad = _port_grad(params, path.replace("/g/", "/f/"))
            assert float(grad.abs().max()) <= 1e-3 * float(f_grad.abs().max())
            continue
        if kind == "gradnorm":
            np.testing.assert_allclose(float(grad.norm()), float(ref),
                                       rtol=1e-3, err_msg=path)
            continue
        got = grad if kind == "grads" else (
            grad[:8, :8] if grad.ndim == 2
            else grad.permute(2, 3, 1, 0)[..., :8, :8])
        softmax = any(t in path for t in ("/f/", "/g/", "/aea/"))
        np.testing.assert_allclose(
            got.numpy(), ref, rtol=5e-3,
            atol=(2e-3 if softmax else 1e-4) * np.abs(ref).max(),
            err_msg=path)
        checked += 1
    # 18 convs and 4 Linears, bias and weight each, less the 2 g biases
    assert checked == 2 * 22 - 2
    bundle.model.zero_grad(set_to_none=True)


def test_q8_plan_calibration_and_stylize_match_rpst(bundle, fx):
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    assert bundle.q8_infer()
    plan = sanet_q8_plan(bundle.vgg, bundle.q8_weights(), adaptive=True)
    assert plan == {"scales": 16, "B5": 16, "B6": 0}
    assert len(fx["act_scales"]) == plan["scales"]
    blocks = sanet_blocks(bundle.model, torch.bfloat16)
    assert blocks["ada_module"] == "relu"
    assert blocks["sanet4_1"][4][0].dtype == torch.float32  # psi0, f32
    assert blocks["decoder"][0][0].dtype == torch.bfloat16
    own = bundle.calibrate_q8(c, s)["act_scales"]
    np.testing.assert_allclose(own, fx["act_scales"], rtol=2e-2)
    scales = {"act_scales": fx["act_scales"]}
    # the transform and the int8 decode on rpst's int8 relu4_1 / relu5_1
    st = _ScaleStream(fx["act_scales"])
    st._i = vgg_q8_plan(bundle.vgg, 5)["scales"]  # the decoder's scales
    blocks32 = bundle.std_weights(torch.float32)
    taps = [None] * 3 + [torch.from_numpy(fx[f"q8_tap_{i}"]) for i in (3, 4)]
    with torch.no_grad():
        fusion = _sanet_transform(blocks32, taps, c.shape[0], None)
        got = _mirror_decode_q8(blocks32["decoder"], bundle.q8_weights(),
                                fusion, torch.float32,
                                make_conv_q(torch.float32, "reflect"), st)
    assert _psnr(got.numpy(), fx["out_q8_f32"]) >= 40.0
    for dt, key, min_psnr in ((torch.float32, "out_q8_f32", 35.0),
                              (torch.bfloat16, "out_q8_bf16", 30.0)):
        got = bundle.stylize_q8(c, s, scales, dtype=dt)
        assert got.dtype == torch.float32
        assert _psnr(got.numpy(), fx[key]) >= min_psnr, key
    bundle.model.transform.blockwise = "always"  # the streamed route
    try:
        got = bundle.stylize_q8(c, s, scales, dtype=torch.float32)
    finally:
        bundle.model.transform.blockwise = "auto"
    assert _psnr(got.numpy(), fx["out_q8_f32"]) >= 35.0
    with pytest.raises(ValueError, match="act scales"):
        bundle.stylize_q8(c, s, {"act_scales": fx["act_scales"][:5]})


def test_style_of_another_size_raises(bundle, fx):
    """psi0 reads every style position: a style of another size names both
    sizes (rpst fails inside its Dense)."""
    c = torch.from_numpy(fx["content"])
    small = c[:, :48, :48].contiguous()
    with pytest.raises(ValueError, match=r"read 64 relu4_1 and 16 relu5_1.*"
                       r"6x6 = 36 and 3x3 = 9"):
        bundle.stylize(small, small)
    with pytest.raises(ValueError, match="read 64 relu4_1"):
        bundle.stylize_q8(small, small, {"act_scales": fx["act_scales"]})
    assert SAModel(adaptive=True, img_size=48).transform.dims == (36, 9)


def test_config_and_init_of_the_adaptive_model():
    with pytest.raises(ValueError, match="ada_module"):
        load_config(dict(network="dynamic_sanet", ada_module="sigmoid"))
    with pytest.raises(ValueError, match="adaptive_blockwise"):
        load_config(dict(network="dynamic_sanet", adaptive_blockwise="some"))
    cfg = load_config(str(YAML), dict(img_size=64))
    assert (cfg.ada_module, cfg.adaptive_blockwise) == ("relu", "auto")
    b = build_model(cfg)
    assert isinstance(b.model.transform.sanet4_1.attention_layer,
                      AEALReluModule)
    assert b.vgg_stages == 5 and not b.folded_infer()
    init_torch_default(b.model, 0)
    psi0 = b.model.transform.sanet4_1.attention_layer.f_psi[0]
    assert float(psi0.bias.abs().max()) == 0.0  # rpst's _linear: zero bias
    assert 0 < float(psi0.weight.abs().max()) <= 64 ** -0.5
    assert not build_model(cfg.replace(img_size=40)).q8_infer()


def test_reference_checkpoint_layout_loads():
    """tools/export_reference_checkpoint.py writes the adaptive modules'
    threshold MLPs as attention_layer.f_psi.{0,2} (transposed Dense
    kernels); the port loads that file into the same state_dict as the flax
    tree."""
    spec = importlib.util.spec_from_file_location(
        "export_reference_checkpoint",
        REPO / "tools" / "export_reference_checkpoint.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tree = dynamic_sanet_weights_from_seed(3, 64)
    exported = tool.export_tree(tree)
    assert "sanet5_1.attention_layer.f_psi.2.weight" in exported["transform"]
    want = from_flax_params(tree)
    got = from_reference_checkpoint(exported)
    model = SAModel(adaptive=True, img_size=64)
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    model.load_state_dict(got)
    assert model.transform.sanet4_1.attention_layer.f_psi[0].weight.shape \
        == (4, 64)


def test_fixture_matches_fresh_jax_run(fx):
    """tests/fixtures/torch_port_dynamic_sanet.npz is what
    tools/make_torch_port_fixture.py --dynamic-sanet computes now with
    rpst."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixture",
        REPO / "tools" / "make_torch_port_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    fresh = tool.make_dynamic_sanet_fixture()
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
    root = tmp_path_factory.mktemp("dynamic_sanet_corpus")
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (root / sub).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8),
                            "RGB").save(root / sub / f"{i:02d}.png")
    return root


@pytest.mark.parametrize("mode", ["standard", "q8"])
def test_serve_torch_cli_dynamic_sanet_on_cpu(corpus, tmp_path, mode):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, str(REPO / "serve_torch.py"), "--config", str(YAML),
         "--set", "img_size=32", "vgg=", "--content", str(corpus / "content"),
         "--style", str(corpus / "style" / "00.png"), "--out", str(out),
         "--mode", mode, "--batch", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=_env(),
        cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(list(out.glob("*.png"))) == 4
    assert ("Calibrated 16 layer scales" in proc.stderr) == (mode == "q8")
    assert "VGG weights" in proc.stderr  # the seeded 5-stage VGG
    assert re.search(r"B6 flash_attention launches: 0", proc.stderr)
    assert re.search(r"B5 fused_conv2d_q8 launches: 0", proc.stderr)


def test_train_torch_cli_dynamic_sanet_on_cpu(corpus, tmp_path):
    out = tmp_path / "run"
    args = [sys.executable, str(REPO / "train_torch.py"), "--config",
            str(YAML), "--device", "cpu", "--set", "img_size=32",
            "batch_size=2", "log_iter=1", "num_workers=0", "vgg=",
            "test_dir=", "snapshot_save_iter=2", "adaptive_blockwise=always",
            f"content_dir={corpus / 'content'}",
            f"style_dir={corpus / 'style'}", f"output={out}"]
    proc = subprocess.run([*args, "max_iter=3"], capture_output=True,
                          text=True, timeout=600, env=_env(), cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Training dynamic_sanet (standard, float32)" in proc.stderr
    assert "B6 fwd/dq/dkv launches: 0/0/0" in proc.stderr
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
    ckpt = torch.load(out / "checkpoints" / "4" / "state.pt",
                      weights_only=True)
    assert ckpt["params"][
        "transform.sanet4_1.attention_layer.f_psi.0.weight"].shape == (1, 16)
