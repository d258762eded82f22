"""Slice 4's remainder in the port on the CPU, against rpst: the Conv2dBlock
options (inception 1x1 stacks, norm bn / in, the activations with prelu),
SK attention (``SKLayer`` / ``SKBottleneck``), the deeper multiscale
stacks in multi_adain and its three variants, LD with inception, the
bridge's names for them, and their gates.

Live rpst calls at small sizes (a few channels, 16-32px), where float32
rounding is far below the bounds: outputs f32 1e-4 (rtol = atol, rpst's
``tests/test_folded.py``); moved running statistics 1e-5; gradients rtol
5e-3 with atol 1e-4 x the tensor's max; bf16 MAE < 1e-2 or 3 x rpst's own
bf16 distance from its f32 output (the north star's bf16 rule). The
full-size deeper yaml model is held against
``tests/fixtures/torch_port_slice4r.npz`` by ``chip_smoke.py`` phase 54 on
the card and by ``test_fixture_*`` here.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from rpst.config import load_config as j_config
from rpst.models import build_model as j_build_model
from rpst.nn.attention import SKLayer as JaxSKLayer
from rpst.nn.blocks import Conv2dBlock as JaxConv2dBlock
from rpst.nn.blocks import (rp_decrease_dims, rp_deeper_dims,
                            rp_increase_dims, rp_shallower_dims)
from rpst_torch import bridge
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.nn import blocks
from rpst_torch.nn.attention import SKLayer
from rpst_torch.nn.blocks import Conv2dBlock
from rpst_torch.nn.vgg import VGG19Encoder

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), dict(tree))


def _random_stats(variables, rng):
    """Non-trivial running statistics (eval mode reads them)."""
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree.map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            variables["batch_stats"])
    return variables


def _load(port, variables):
    port.load_state_dict({
        **bridge.from_flax_params(_np_tree(variables["params"])),
        **bridge.from_flax_batch_stats(_np_tree(
            variables.get("batch_stats", {})))})


def _check_grads(port_module, jax_grads, grads_f64=None):
    """The port's .grad of every parameter against rpst's gradient tree. A
    gradient that is zero but for rounding (a conv bias before a batch or
    instance norm, or before an AdaIN) is held to that: rpst's under 1e-5
    of the largest gradient, or the float64 oracle's (``grads_f64``, the
    port's float64 model: rpst's float32 rounding of a zero gradient
    depends on the CPU's kernels), and the port's and rpst's under 1e-4."""
    want = bridge.from_flax_params(_np_tree(jax_grads))
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in port_module.named_parameters()}
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        size = float(g.abs().max())
        g64 = None if grads_f64 is None else grads_f64.get(
            name, torch.zeros(()))
        if size < 1e-5 * top or (g64 is not None
                                 and float(g64.abs().max()) < 1e-5 * top):
            assert float(got[name].abs().max()) < 1e-4 * top, name
            assert size < 1e-4 * top, name
            continue
        torch.testing.assert_close(got[name], g, rtol=5e-3,
                                   atol=1e-4 * size, msg=name)


# ------------------------------------------------------------ the block

BLOCK_OPTIONS = {
    "inception1": dict(inception_num=1), "inception2": dict(inception_num=2),
    "inception3": dict(inception_num=3), "bn": dict(norm="bn"),
    "in": dict(norm="in"), "prelu": dict(activation="prelu"),
    "relu": dict(activation="relu"),
    "sk": dict(attention="sk"), "sk_grouped": dict(attention="sk"),
    "all": dict(inception_num=2, norm="bn", activation="prelu",
                attention="sk"),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("option", list(BLOCK_OPTIONS))
def test_block_option_matches_rpst(option, train):
    """Conv2dBlock with each option against rpst's at op size: the output,
    every parameter's gradient of a weighted sum of it, and in train mode
    the moved running statistics (norm bn, the SK bottleneck's bn1 / bn3).
    ``sk_grouped`` runs at 32 channels, where the SK branches group by 32."""
    opts = BLOCK_OPTIONS[option]
    rng = np.random.default_rng(sorted(BLOCK_OPTIONS).index(option))
    cin, feat = (32, 32) if option == "sk_grouped" else (6, 8)
    x = rng.normal(size=(2, 12, 10, cin)).astype(np.float32)
    w = rng.normal(size=(2, 12, 10, feat)).astype(np.float32)
    mod = JaxConv2dBlock(features=feat, padding=1, **opts)
    variables = _random_stats(jax.tree.map(np.array, dict(mod.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))), rng)
    extra = {k: v for k, v in variables.items() if k != "params"}

    def f(params):
        if train:
            y, muts = mod.apply({"params": params, **extra}, jnp.asarray(x),
                                train=True, mutable=["batch_stats"])
        else:
            y, muts = mod.apply({"params": params, **extra},
                                jnp.asarray(x)), {}
        return jnp.sum(y * w), (y, muts)

    (_, (ref, muts)), grads = jax.value_and_grad(f, has_aux=True)(
        variables["params"])
    port = Conv2dBlock(cin, feat, **opts)
    _load(port, variables)
    port.train(train)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    (got * torch.from_numpy(w)).sum().backward()
    _check_grads(port, grads)
    if train and "batch_stats" in muts:
        moved = bridge.from_flax_batch_stats(_np_tree(muts["batch_stats"]))
        for name, buf in port.named_buffers():
            np.testing.assert_allclose(buf.numpy(), moved[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("cin", [16, 64])
def test_sk_layer_matches_rpst(cin):
    """SKLayer alone: d = max(in // 16, 32) hidden channels, groups 32 where
    the width divides by 32 (64), else 1; the softmax over the M = 2
    dilated branches."""
    rng = np.random.default_rng(cin)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    mod = JaxSKLayer(out_channels=cin)
    variables = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = mod.apply(variables, jnp.asarray(x))
    port = SKLayer(cin, cin)
    assert port.branch_0.groups == (32 if cin % 32 == 0 else 1)
    assert port.fc1.out_channels == max(cin // 16, 32)
    assert port.branch_1.dilation == (2, 2) and port.branch_1.padding == (2, 2)
    _load(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("norm", ["ln", "adain"])
def test_block_refuses_what_rpst_refuses(norm):
    """rpst's Conv2dBlock raises for the norms ``ln`` and ``adain`` (the
    reference never defines them); so does the port's."""
    with pytest.raises(NotImplementedError):
        JaxConv2dBlock(features=4, norm=norm).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4)))
    with pytest.raises(NotImplementedError, match="rpst refuses it too"):
        Conv2dBlock(4, 4, norm=norm)


@pytest.mark.parametrize("block_num", [3, 4, 5])
def test_dim_plans_match_rpst(block_num):
    """The four RP dim plans against rpst's for block_num 3-5."""
    for port_fn, ref_fn, args in (
            (blocks.rp_increase_dims, rp_increase_dims, (3, 16, 256)),
            (blocks.rp_deeper_dims, rp_deeper_dims, (3, 16, 256)),
            (blocks.rp_decrease_dims, rp_decrease_dims, (256, 128, 3)),
            (blocks.rp_shallower_dims, rp_shallower_dims, (256, 128, 3))):
        assert port_fn(block_num, *args) == ref_fn(block_num, *args)


# -------------------------------------------------------------- the models

SMALL = dict(rp_blocks=3, hidden_dim=4, img_size=16, content_weight=1.0,
             style_weight=2.0)
MODELS = {
    "multi_adain_deeper": dict(network="multi_adain",
                               enc_stack_way="deeper", inception_num=2),
    "multi_adain_deeper_se": dict(network="multi_adain",
                                  enc_stack_way="deeper", attention="se"),
    "multi_adain_sk": dict(network="multi_adain", attention="sk",
                           inception_num=1),
    "sel_multi_adain_deeper": dict(network="sel_multi_adain",
                                   enc_stack_way="deeper", inception_num=1),
    "ccam_deeper": dict(network="ccam", enc_stack_way="deeper",
                        inception_num=1, attention="sk"),
    "mst_deeper": dict(network="mst", enc_stack_way="deeper",
                       inception_num=1),
    "ld_adain_inception": dict(network="ld_adain", ld_layer_num=2,
                               inception_num=2),
    "ld_adain4_inception": dict(network="ld_adain4", ld_layer_num=2,
                                inception_num=1),
}


def _pair(cfg, rng, n=2):
    size = cfg["img_size"]
    return tuple(rng.random((n, size, size, 3), dtype=np.float32)
                 for _ in range(2))


def _models(case, **over):
    """(rpst bundle, its variables, port bundle with those weights)."""
    cfg = dict(SMALL, **MODELS[case], **over)
    jb = j_build_model(j_config(cfg))
    rng = np.random.default_rng(11)
    c, s = _pair(cfg, rng)
    v = _random_stats(jax.tree.map(np.array, dict(jb.model.init(
        jax.random.PRNGKey(3), jnp.asarray(c), jnp.asarray(s)))), rng)
    pb = build_model(load_config(cfg))
    _load(pb.model, v)
    return jb, v, pb, c, s


def _grads_f64(case, c, s):
    """The port's float64 gradients of a case's loss (its model, the VGG
    and the images in float64, train mode): which gradients are zero but
    for rounding."""
    _, _, pb, _, _ = _models(case)
    pb.model.double().train()
    vgg = VGG19Encoder().double()
    vgg.load_state_dict(bridge.vgg_from_flax(bridge.vgg_weights_from_seed(1)))
    total, _ = pb.loss(vgg, torch.from_numpy(c).double(),
                       torch.from_numpy(s).double())
    total.backward()
    return {n: p.grad for n, p in pb.model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("case", list(MODELS))
def test_model_stylize_and_gradients_match_rpst(case):
    """Each deeper / inception / SK model: the f32 stylize (eval, running
    statistics) and the bf16 stylize against rpst's, the standard path's
    loss parts and every parameter's gradient (train mode, batch
    statistics) and the moved running statistics; the folded and q8 gates
    stay shut, as rpst's."""
    jb, v, pb, c, s = _models(case)
    assert not pb.folded_infer() and not pb.q8_infer()
    assert jb.folded_infer() is False and jb.q8_infer() is False
    vgg_vars = jax.tree.map(jnp.asarray, bridge.vgg_weights_from_seed(1))
    ref = np.asarray(jb.stylize(v, vgg_vars, jnp.asarray(c), jnp.asarray(s)))
    got = pb.stylize(torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    bf = dict(SMALL, **MODELS[case], compute_dtype="bfloat16")
    jbf = j_build_model(j_config(bf))
    ref_bf = np.asarray(jbf.stylize(v, vgg_vars, jnp.asarray(c),
                                    jnp.asarray(s)), np.float32)
    pbf = build_model(load_config(bf))
    pbf.load_state_dict(pb.model.state_dict())
    got_bf = pbf.stylize(torch.from_numpy(c), torch.from_numpy(s)).numpy()
    own = float(np.abs(ref_bf - ref).mean())
    if MODELS[case]["network"] == "mst":
        # the k-means channel assignment of bfloat16 features flips where
        # the two frameworks' features round apart (the port's bf16 output
        # reads 3.5 x rpst's own distance here): the rule holds the deepest
        # bf16 encoder feature, the MST transform's input
        feats = jbf.model.apply(v, jnp.asarray(c), method=lambda m, x: (
            m.ms.encode_intermediate(x)[0][-1]))
        ref_f = np.asarray(feats, np.float32)
        own = float(np.abs(ref_f - np.asarray(jb.model.apply(
            v, jnp.asarray(c), method=lambda m, x: (
                m.ms.encode_intermediate(x)[0][-1])))).mean())
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got_f = pbf.model.ms.encode(torch.from_numpy(c),
                                        torch.from_numpy(s))[0][-1]
        got_f = got_f.float().permute(0, 2, 3, 1).detach().numpy()
        assert float(np.abs(got_f - ref_f).mean()) < max(
            1e-2 * float(np.abs(ref_f).mean()), 3 * own)
    else:
        assert float(np.abs(got_bf - ref_bf).mean()) < max(1e-2, 3 * own)

    params = v["params"]
    extra = {k: x for k, x in v.items() if k != "params"}

    def loss(p):
        total, (parts, muts) = jb.loss({"params": p, **extra}, vgg_vars,
                                       jnp.asarray(c), jnp.asarray(s),
                                       train=True)
        return total, (parts, muts)

    (_, (parts, muts)), grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    vgg = VGG19Encoder()
    vgg.load_state_dict(bridge.vgg_from_flax(bridge.vgg_weights_from_seed(1)))
    pb.model.train()
    total, got_parts = pb.loss(vgg, torch.from_numpy(c), torch.from_numpy(s))
    total.backward()
    for k in ("content_loss", "style_loss", "total_loss"):
        np.testing.assert_allclose(float(got_parts[k]), float(parts[k]),
                                   rtol=1e-4, err_msg=k)
    _check_grads(pb.model, grads, _grads_f64(case, c, s))
    if "batch_stats" in muts:
        moved = bridge.from_flax_batch_stats(_np_tree(muts["batch_stats"]))
        for name, buf in pb.model.named_buffers():
            np.testing.assert_allclose(buf.numpy(), moved[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_deeper_stack_shapes_and_forced_attention():
    """The deeper yaml's widths: the encoder 3 -> 16 -> ... -> 256 at hidden
    16, the decoder back down (``rp_shallower_dims(256, 128, 3)``), three
    inception convs in every encoder block and none in the decoder; the
    deeper encoder takes no attention even when the config sets one."""
    cfg = load_config(dict(network="multi_adain", enc_stack_way="deeper",
                           rp_blocks=5, hidden_dim=16, inception_num=3,
                           attention="se"))
    model = build_model(cfg).model
    enc, dec = model.rp_shared_encoder, model.rp_decoder
    assert [(b.PadConv_0.Conv_0.in_channels, b.PadConv_0.Conv_0.out_channels)
            for b in enc.blocks] == [(3, 16), (16, 32), (32, 64), (64, 128),
                                     (128, 256)]
    assert [(b.PadConv_0.Conv_0.in_channels, b.PadConv_0.Conv_0.out_channels)
            for b in dec.blocks] == [(256, 128), (128, 64), (64, 32),
                                     (32, 16), (16, 3)]
    assert all(b.inception_num == 3 and not hasattr(b, "SEBottleneck_0")
               for b in enc.blocks)
    assert all(b.inception_num == 0 for b in dec.blocks)


def test_masked_deeper_stylize_matches_rpst():
    """The deeper yaml's model (deeper, inception, use_mask) at small width
    with seeded label maps: every fusion, up to the widest, is the masked
    AdaIN, f32 1e-4."""
    from make_photoreal_set import label_maps
    jb, v, pb, c, s = _models("multi_adain_deeper", use_mask=True,
                              img_size=32)
    rng = np.random.default_rng(5)
    maps = [label_maps(32, rng) for _ in range(2)]
    cl, sl = (np.stack([m[i] for m in maps]).astype(np.int32)
              for i in (0, 1))
    ref = jb.stylize(v, None, jnp.asarray(c), jnp.asarray(s),
                     jnp.asarray(cl), jnp.asarray(sl))
    got = pb.stylize(*(torch.from_numpy(a) for a in (c, s, cl, sl)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = pb.stylize(torch.from_numpy(c), torch.from_numpy(s))
    assert float((got - plain).abs().max()) > 1e-3


# -------------------------------------------------------------- the bridge

def test_bridge_carries_the_new_names():
    """A flax tree with inception convs, a norm-bn BatchNorm_0 (scale and
    batch statistics), prelu_alpha and an SK bottleneck (its grouped
    branches, fc1 / fc2, bn1 / bn3) crosses the bridge onto every port
    parameter and buffer; ``flax_weights_from_seed`` draws such a tree from
    the port model alone, the same on every machine."""
    mod = JaxConv2dBlock(features=32, padding=1, inception_num=2, norm="bn",
                         activation="prelu", attention="sk")
    v = mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 6, 32)))
    port = Conv2dBlock(32, 32, inception_num=2, norm="bn",
                       activation="prelu", attention="sk")
    sd = {**bridge.from_flax_params(_np_tree(v["params"])),
          **bridge.from_flax_batch_stats(_np_tree(v["batch_stats"]))}
    assert set(sd) == set(port.state_dict())
    assert sd["SKBottleneck_0.SKLayer_0.branch_1.weight"].shape == (32, 1, 3,
                                                                    3)
    assert sd["prelu_alpha"].shape == () and float(sd["prelu_alpha"]) == 0.25
    port.load_state_dict(sd)
    params, stats = bridge.flax_weights_from_seed(port, 3)
    again = bridge.flax_weights_from_seed(port, 3)
    assert jax.tree.map(lambda a: a.shape, params) == jax.tree.map(
        lambda a: np.shape(a), _np_tree(v["params"]))
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(again[0])))
    port.load_state_dict({**bridge.from_flax_params(params),
                          **bridge.from_flax_batch_stats(stats)})
    # rpst runs the drawn tree
    mod.apply({"params": params, "batch_stats": stats},
              jnp.zeros((1, 6, 6, 32)))


# ------------------------------------------------------------ the fixture

def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()


@pytest.fixture(scope="module")
def s4r_fx():
    with np.load(CHIP_SMOKE.S4R_FIXTURE) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["deeper", "sk", "se_accum2"])
def test_fixture_case_matches_rpst(s4r_fx, case, dtype):
    """``chip_smoke.s4r_case`` (phase 54's check) on the CPU: the deeper
    yaml's model (masked stylize), SK attention and the SE flagship under
    grad_accum 2 against the fixture, with the CPU's spread (2 x the larger
    of the two frameworks' own float32 gradient errors)."""
    CHIP_SMOKE.s4r_case("cpu", s4r_fx, case, 2.0, dtype)


@pytest.mark.parametrize("case", ["block_bn", "block_in"])
def test_fixture_block_matches_rpst(s4r_fx, case):
    CHIP_SMOKE.s4r_block("cpu", s4r_fx, case)


def test_fixture_is_the_tools_and_chip_smokes_configs(s4r_fx):
    """The fixture's cases are the tool's (``SLICE4R``), its deeper case
    the yaml's model, and phase 56's launch rule is the CPU count of the
    kernels' plain versions (23 / 17 / 15 a microbatch, B1 twice with
    remat)."""
    import json
    from make_torch_port_fixture import SLICE4R
    for case, cfg in SLICE4R.items():
        assert json.loads(str(s4r_fx[f"{case}/config"])) == cfg
    yaml = load_config(str(CHIP_SMOKE.DEEPER_YAML))
    for k in ("network", "enc_stack_way", "rp_blocks", "hidden_dim",
              "inception_num", "use_mask"):
        assert getattr(yaml, k) == SLICE4R["deeper"][k], k
    assert CHIP_SMOKE.remat_per_step(2, True) == (92, 34, 30)


# ------------------------------------------------------------- the drivers

def _script(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_deeper_yaml_trains_and_tests_as_written(tmp_path):
    """configs/train_deeper_multiscale_rp_adain.yaml through train_torch.py
    and test_torch.py on the CPU, as written but for the data paths, the
    VGG, the output, the cadence and the image size (32px): 2 steps, a test
    dump at step 2 of a photoreal set in which the masked AdaIN ran
    (every fusion, up to the encoder's widest), then test_torch.py on the
    checkpoint writes the same files."""
    import json
    from make_photoreal_set import make_photoreal_set
    from test_torch_mrf import port_log
    photo = make_photoreal_set(tmp_path / "photo", n=2, size=32)
    out = tmp_path / "out"
    sets = [f"content_dir={photo / 'content'}",
            f"style_dir={photo / 'style'}", f"test_dir={photo}", "vgg=",
            f"output={out}", "img_size=32", "num_workers=0"]
    with port_log() as lines:
        _script("train_torch").main([
            "--config", str(CHIP_SMOKE.DEEPER_YAML), "--device", "cpu",
            "--set", *sets, "max_iter=3", "test_iter=2", "log_iter=1",
            "snapshot_save_iter=2"])
    steps = [json.loads(ln) for ln in
             (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in steps] == [1, 2]
    assert all(np.isfinite(ln["total_loss"]) and ln["skipped"] == 0.0
               for ln in steps)
    assert any("masked AdaIN, " in m for m in lines), lines
    assert any("Training multi_adain (standard" in m for m in lines)
    names = sorted(f"in{k}-tar{k}{t}" for k in range(2)
                   for t in ("-cat.png", ".png"))
    assert sorted(p.name for p in (out / "test" / "2").iterdir()) == names
    _script("test_torch").main([
        "--config", str(CHIP_SMOKE.DEEPER_YAML), "--device", "cpu", "--set",
        *sets])
    assert sorted(p.name for p in (out / "test" / "test_output")
                  .iterdir()) == names
