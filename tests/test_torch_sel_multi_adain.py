"""sel_multi_adain (SELastRP: the flagship's stack with an SE bottleneck on
the last fusion) of the port on the CPU, and the helpers the slice-4 tests
share (tests/test_torch_ccam.py, test_torch_mst.py).

Against ``tests/fixtures/torch_port_sel_multi_adain.npz``
(``tools/make_torch_port_fixture.py --sel-multi-adain``: rpst's folded and
standard stylize, loss parts, gradients, updated BatchNorm statistics, a
3-step trajectory and int8 stylize at 64px, batch 2, full width): no JAX
compile. Live rpst calls stay at op size: the SE bottleneck and its folded
BatchNorm forms, the standard module, the channel shuffle.

Tolerances: float32 1e-4 (rtol = atol, rpst's ``tests/test_folded.py``); loss
rtol 1e-4; gradients rtol 5e-3, atol 1e-4 x the tensor's max, or, where it is
more, ``GRAD_SPREAD`` (2) x that tensor's own float32 error in rpst x its max:
the larger distance of rpst's folded float32 gradient from its standard float32
one and from its float64 one (the fixtures' ``grads_std/`` and ``grads_f64/``),
relative to the tensor's max. mst's read below 1.4e-5 (the stated bound holds
there); sel_multi_adain's up to 5.1e-3 and ccam's 4.3e-4 .. 2.7e-2: the CCAM
softmax of position sums over 4096 positions and the BatchNorm backward amplify
float32 rounding, and rpst's two float32 paths share much of it (the same
elementwise ops on almost the same inputs round alike), so their spread alone
understates it: sel's SE conv2 gradient has them 2.7e-4 apart and both 1.8e-3
from float64. The port's gradients sit within 1.23 x each tensor's own error on
the CPU (``tools/grad_noise.py`` prints the readings); a wrong gradient of a
tensor whose own error is small still fails at 1e-4. The trajectory's first
loss rtol 1e-4, the later ones ``TRAJECTORY_RTOL`` (1e-2), or twice the spread
of rpst's folded and standard trajectories where that is more: Adam's first
steps move each weight by about lr whatever its gradient's size, so float32
noise in near-zero gradients moves the later losses (rpst's two ccam
trajectories differ by up to 1.8e-3, the port's from rpst's folded one by
3.8e-3); the bfloat16 folded stylize against rpst's bfloat16 one MAE < 1e-2
(the flagship's bf16 budget, ``test_torch_flagship.py``; the two frameworks
round bfloat16 at other places), or ``BF16_OWN`` (3) x rpst's own bfloat16
distance from its float32 output where that is more (each framework's bf16
output sits about that far from the f32 one in its own direction; ccam's CCAM
softmax makes it 2.2e-2; the card's cuDNN bf16 reads 2.4x); q8 with rpst's
scales PSNR >= 40 dB in float32 around the int8 layers, >= 30 dB in bfloat16;
calibration scales rtol 1e-4 where rpst calibrates in float32 (sel, ccam), 2e-2
in bfloat16 (mst).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rpst.models import fast_path as jfp
from rpst.models.adain_rp import SELastRP as JaxSELastRP
from rpst.models.base import channel_shuffle as jax_channel_shuffle
from rpst.nn.attention import SEBottleneck as JaxSEBottleneck
from rpst.ops import folded as jfolded
from rpst_torch.bridge import (flax_tree_from_npz, from_flax_batch_stats,
                               from_flax_params, vgg_from_flax,
                               vgg_weights_from_seed)
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.models.adain_rp import SELastRP
from rpst_torch.models.base import channel_shuffle
from rpst_torch.models.fast_path import _folded_se_bottleneck, se_weights
from rpst_torch.models.fast_path_q8 import q8_plan
from rpst_torch.nn.attention import SEBottleneck
from rpst_torch.nn.blocks import init_torch_default
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.ops import folded
from rpst_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from rpst_torch.train.step import adam_count, create_train_state, train_step
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_KEYS = ("content_loss", "style_loss", "total_loss")
BF16_MAE = 1e-2
BF16_OWN = 3.0
GRAD_SPREAD = 2.0
TRAJECTORY_RTOL = 1e-2


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixture",
        REPO / "tools" / "make_torch_port_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


TOOL = _tool()


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def psnr(got, ref):
    mse = float(np.mean((np.asarray(got, np.float64) - ref) ** 2))
    span = float(ref.max() - ref.min())
    return 10 * np.log10(span * span / max(mse, 1e-30))


def load_fixture(network):
    """{plain keys} and the flax trees (params, batch_stats, grads,
    stats_after) of the network's fixture."""
    with np.load(TOOL.SLICE4_DST[network]) as npz:
        trees = flax_tree_from_npz(npz)
        fx = {k: npz[k] for k in npz.files if "/" not in k}
    fx["trees"] = trees
    return fx


def fixture_params(fx):
    """The fixture's flax params tree (its other trees dropped)."""
    return {k: v for k, v in fx["trees"].items()
            if k not in ("batch_stats", "grads", "grads_std", "grads_f64",
                         "grads_f64s", "stats_after")}


def fixture_bundle(network, fx, **over):
    """The port's bundle at the fixture's config, weights and VGG."""
    cfg = dict(TOOL.SLICE4[network], img_size=fx["content"].shape[1],
               exec_strategy="folded", lr=float(fx["lr"]),
               lr_decay=float(fx["lr_decay"]), **TOOL.SLICE4_LOSS)
    bundle = build_model(load_config(dict(cfg, **over)))
    sd = from_flax_params(fixture_params(fx))
    sd.update(from_flax_batch_stats(fx["trees"].get("batch_stats", {})))
    bundle.load_state_dict(sd)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    return bundle, vgg


def images(fx):
    return torch.from_numpy(fx["content"]), torch.from_numpy(fx["style"])


def check_stylize(network):
    """Folded f32 and the standard module against rpst's, folded bf16
    against rpst's bf16; the folded path against the port's own standard
    module."""
    fx = load_fixture(network)
    bundle, _ = fixture_bundle(network, fx)
    assert bundle.folded_infer() and not bundle.folded_exec()
    c, s = images(fx)
    got = bundle.stylize(c, s)
    assert got.shape == fx["out_folded"].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), fx["out_folded"], **TOL)
    std = bundle.stylize(c, s, folded=False)
    np.testing.assert_allclose(std.numpy(), fx["out_std"], **TOL)
    np.testing.assert_allclose(got.numpy(), std.numpy(), **TOL)
    bf16, _ = fixture_bundle(network, fx, compute_dtype="bfloat16")
    out = bf16.stylize(c, s).numpy()
    own = np.abs(fx["out_folded_bf16"] - fx["out_folded"]).mean()
    assert np.abs(out - fx["out_folded_bf16"]).mean() < max(BF16_MAE,
                                                            BF16_OWN * own)
    return fx, bundle


def check_loss_grads_trajectory(network):
    """The folded float32 loss parts, every parameter's gradient and the
    3-step trajectory against rpst's; returns the bundle after the first
    loss (sel_multi_adain's BatchNorms then hold the moved statistics)."""
    fx = load_fixture(network)
    bundle, vgg = fixture_bundle(network, fx)
    c, s = images(fx)
    bundle.model.train()
    total, parts = bundle.loss(vgg, c, s)
    total.backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(parts[k].detach()), float(fx[k]),
                                   rtol=1e-4, err_msg=k)
    ref, std, f64 = (from_flax_params(fx["trees"][k])
                     for k in ("grads", "grads_std", "grads_f64"))
    checked = 0
    for name, p in bundle.model.named_parameters():
        r = ref[name]
        size = float(r.abs().max())
        if p.grad is None:  # no path from the loss (mst's encoder)
            assert size == 0.0, name
            continue
        own = max(float((r - std[name]).abs().max()),
                  float((r - f64[name]).abs().max())) / size
        torch.testing.assert_close(
            p.grad, r, rtol=5e-3, atol=max(1e-4, GRAD_SPREAD * own) * size,
            msg=name)
        checked += 1
    assert checked and set(ref) == {n for n, _ in
                                    bundle.model.named_parameters()}
    moved = bundle
    fresh, _ = fixture_bundle(network, fx)
    state = create_train_state(fresh)
    losses = [float(train_step(state, vgg, c, s)["total_loss"])
              for _ in range(len(fx["trajectory"]))]
    np.testing.assert_allclose(losses[0], fx["trajectory"][0], rtol=1e-4)
    spread = np.abs(fx["trajectory"] - fx["trajectory_std"]) \
        / np.abs(fx["trajectory"])
    np.testing.assert_array_less(np.abs(losses - fx["trajectory"])
                                 / np.abs(fx["trajectory"]),
                                 np.maximum(TRAJECTORY_RTOL, 2 * spread))
    assert state.step == 3 and adam_count(state.optimizer) == 3
    return fx, moved


def check_q8(network, calib_rtol):
    """The int8 plan, calibration and int8 stylize with rpst's scales."""
    fx = load_fixture(network)
    bundle, _ = fixture_bundle(network, fx)
    c, s = images(fx)
    assert bundle.q8_infer()
    enc, dec = bundle.folded_weights()
    plan = q8_plan([k for k, _ in enc], [k for k, _ in dec], False)
    assert plan == {"scales": 14, "B1": 3, "B4": 12, "B7": 0}
    assert len(fx["act_scales"]) == plan["scales"]
    own = bundle.calibrate_q8(c, s)["act_scales"]
    np.testing.assert_allclose(own, fx["act_scales"], rtol=calib_rtol)
    scales = {"act_scales": fx["act_scales"]}
    reads = {}
    for dt, key, limit in ((torch.float32, "out_q8_f32", 40.0),
                           (torch.bfloat16, "out_q8_bf16", 30.0)):
        got = bundle.stylize_q8(c, s, scales, dtype=dt)
        assert got.dtype == torch.float32 and got.shape == fx[key].shape
        reads[key] = psnr(got.numpy(), fx[key])
        assert reads[key] >= limit, (key, reads[key])
    with pytest.raises(ValueError, match="act scales"):
        bundle.stylize_q8(c, s, {"act_scales": fx["act_scales"][:5]})
    return reads


# ---------------------------------------------------------------- drivers

def _corpus(root: Path, n: int = 2, size: int = 36):
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (root / sub).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8),
                            "RGB").save(root / sub / f"{i}.png")
    return root


def _module(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_serve(root: Path, network: str, mode: str, **over):
    """serve_torch.py in this process on the corpus at 32px: the written
    images."""
    cfg = root / f"serve_{network}_{mode}.yaml"
    cfg.write_text(json.dumps(dict(network=network, rp_blocks=3,
                                   hidden_dim=32, img_size=32, **over)))
    out = root / f"out_{network}_{mode}"
    argv = ["serve_torch.py", "--config", str(cfg), "--content",
            str(root / "content"), "--style", str(root / "style"), "--out",
            str(out), "--mode", mode, "--batch", "2", "--device", "cpu"]
    old = __import__("sys").argv
    __import__("sys").argv = argv
    try:
        _module("serve_torch").main()
    finally:
        __import__("sys").argv = old
    return sorted(out.glob("*.png"))


def run_train(root: Path, network: str, strategy: str, **over):
    """train_torch.py in this process: 3 steps at 32px, batch 2; the
    metric lines."""
    out = root / f"train_{network}_{strategy}"
    cfg = root / f"train_{network}_{strategy}.yaml"
    cfg.write_text(json.dumps(dict(
        network=network, rp_blocks=3, hidden_dim=8, img_size=32,
        batch_size=2, num_workers=1, exec_strategy=strategy, max_iter=4,
        snapshot_save_iter=10, content_dir=str(root / "content"),
        style_dir=str(root / "style"), output=str(out), **over)))
    _module("train_torch").main(["--config", str(cfg), "--device", "cpu"])
    return [json.loads(ln) for ln in
            (out / "logs" / "metrics.jsonl").read_text().splitlines()]


def check_drivers(root: Path, network: str, **over):
    """Serving (standard, folded, q8) and training (standard, folded)."""
    for mode in ("standard", "folded", "q8"):
        assert len(run_serve(root, network, mode, **over)) == 2, mode
    for strategy in ("standard", "folded"):
        lines = run_train(root, network, strategy, **over)
        assert [ln["step"] for ln in lines] == [1, 2, 3]
        assert all(np.isfinite(ln["total_loss"]) and ln["skipped"] == 0.0
                   for ln in lines)


# ------------------------------------------------------------------ tests


def test_channel_shuffle_matches_rpst():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 8)).astype(np.float32)
    ref = np.asarray(jax_channel_shuffle(jnp.asarray(x)))
    got = channel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("train", [False, True])
def test_se_bottleneck_and_its_folded_form_match_rpst(train):
    """The standard SE bottleneck (running or batch statistics, the moved
    running statistics) and its folded form (the BatchNorm affines and
    batch statistics over sub-positions, the exact pool) against rpst's
    flax module and ``_folded_se_bottleneck[_train]``, at its own size."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 6, 16)).astype(np.float32)
    mod = JaxSEBottleneck(planes=16, reduction=4)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.array, variables["params"])
    for bn in ("bn1", "bn2", "bn3"):
        params[bn]["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
        params[bn]["bias"] = rng.uniform(-0.2, 0.2, 16).astype(np.float32)
    stats = {bn: {"mean": rng.normal(size=16).astype(np.float32) * 0.1,
                  "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
             for bn in ("bn1", "bn2", "bn3")}
    v = {"params": params, "batch_stats": stats}
    if train:
        (ref, _), muts = mod.apply(v, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
    else:
        ref, _ = mod.apply(v, jnp.asarray(x))
    port = SEBottleneck(16, reduction=4)
    sd = from_flax_params(_np_tree(params))
    sd.update(from_flax_batch_stats(stats))
    port.load_state_dict(sd)
    port.train(train)
    got, _ = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)
    xf = jfolded.fold(jnp.asarray(x))
    if train:
        fref, fstats = jfp._folded_se_bottleneck_train(xf, params, stats,
                                                       jnp.float32)
        for bn in ("bn1", "bn2", "bn3"):
            for leaf, buf in (("mean", "running_mean"),
                              ("var", "running_var")):
                np.testing.assert_allclose(
                    getattr(getattr(port, bn), buf).numpy(),
                    np.asarray(muts["batch_stats"][bn][leaf]), rtol=1e-5,
                    atol=1e-6, err_msg=f"{bn}.{leaf}")
                np.testing.assert_allclose(
                    np.asarray(fstats[bn][leaf]),
                    np.asarray(muts["batch_stats"][bn][leaf]), rtol=1e-5,
                    atol=1e-6)
    else:
        fref = jfp._folded_se_bottleneck(xf, params, stats, jnp.float32)
    fresh = SEBottleneck(16, reduction=4)
    fresh.load_state_dict(sd)
    fgot = _folded_se_bottleneck(folded.fold(torch.from_numpy(x)),
                                 se_weights(fresh, torch.float32),
                                 torch.float32, train=train)
    np.testing.assert_allclose(fgot.numpy(), np.asarray(fref), **TOL)
    np.testing.assert_allclose(folded.unfold(fgot).numpy(), np.asarray(ref),
                               **TOL)
    if train:  # the folded form moved the same running statistics
        for bn in ("bn1", "bn2", "bn3"):
            np.testing.assert_allclose(
                getattr(fresh, bn).running_var.numpy(),
                np.asarray(fstats[bn]["var"]), rtol=1e-5, atol=1e-6)


def test_folded_se_pieces_match_rpst():
    rng = np.random.default_rng(2)
    k1 = rng.normal(size=(1, 1, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        folded.fold_conv1x1_kernel(torch.from_numpy(k1)).numpy(),
        np.asarray(jfolded.fold_conv1x1_kernel(jnp.asarray(k1))))
    x = rng.normal(size=(2, 4, 6, 20)).astype(np.float32)
    np.testing.assert_allclose(
        folded.folded_channel_pool(torch.from_numpy(x)).numpy(),
        np.asarray(jfolded.folded_channel_pool(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)
    for shape in ((5,), (2, 5)):
        sc, sh = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        np.testing.assert_allclose(
            folded.folded_channel_affine(*(torch.from_numpy(a)
                                           for a in (x, sc, sh))).numpy(),
            np.asarray(jfolded.folded_channel_affine(
                *(jnp.asarray(a) for a in (x, sc, sh)))), rtol=1e-6)
    k3 = rng.normal(size=(3, 3, 5, 5)).astype(np.float32)
    kf = jfolded.fold_conv_kernel(jnp.asarray(k3))
    np.testing.assert_allclose(
        folded.folded_zero_conv(torch.from_numpy(x),
                                torch.from_numpy(np.array(kf))).numpy(),
        np.asarray(jfolded.folded_zero_conv(jnp.asarray(x), kf)), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_standard_module_matches_flax(train):
    rng = np.random.default_rng(3)
    c, s = (rng.random((2, 16, 16, 3), dtype=np.float32) for _ in range(2))
    jm = JaxSELastRP(rp_blocks=3, hidden_dim=16)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(c), jnp.asarray(s))
    port = SELastRP(rp_blocks=3, hidden_dim=16)
    sd = from_flax_params(_np_tree(v["params"]))
    sd.update(from_flax_batch_stats(_np_tree(v["batch_stats"])))
    port.load_state_dict(sd)
    port.train(train)
    if train:
        ref, muts = jm.apply(v, jnp.asarray(c), jnp.asarray(s), train=True,
                             mutable=["batch_stats"])
    else:
        ref = jm.apply(v, jnp.asarray(c), jnp.asarray(s))
    got = port(torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    if train:
        np.testing.assert_allclose(
            port.attention_block.bn2.running_var.numpy(),
            np.asarray(muts["batch_stats"]["attention_block"]["bn2"]["var"]),
            rtol=1e-5, atol=1e-6)


def test_stylize_matches_rpst():
    check_stylize("sel_multi_adain")


def test_loss_gradients_statistics_and_trajectory_match_rpst():
    fx, bundle = check_loss_grads_trajectory("sel_multi_adain")
    moved = from_flax_batch_stats(fx["trees"]["stats_after"])
    buffers = dict(bundle.model.named_buffers())
    assert set(moved) == set(buffers)
    for k, v in moved.items():
        torch.testing.assert_close(buffers[k], v, rtol=1e-5, atol=1e-6,
                                   msg=k)


def test_q8_matches_rpst():
    check_q8("sel_multi_adain", 1e-4)


def _small_sel(strategy, seed=0):
    bundle = build_model(load_config(dict(
        network="sel_multi_adain", rp_blocks=3, hidden_dim=8, img_size=16,
        exec_strategy=strategy, lr=1e-3)))
    init_torch_default(bundle.model, seed)
    return create_train_state(bundle)


@pytest.mark.parametrize("strategy", ["folded", "standard"])
def test_skipped_step_restores_batchnorm_statistics(strategy):
    """rpst's skip rolls back ``batch_stats`` with the parameters: a
    non-finite step leaves the running statistics where they were, a
    finite one moves them."""
    rng = np.random.default_rng(4)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1)))
    c, s = (torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
            for _ in range(2))
    state = _small_sel(strategy)
    train_step(state, vgg, c, s)
    before = {k: v.clone() for k, v in state.model.named_buffers()}
    assert set(before) == {f"attention_block.bn{i}.running_{w}"
                           for i in (1, 2, 3) for w in ("mean", "var")}
    bad = s.clone()
    bad[0, 0, 0, 0] = float("nan")
    parts = train_step(state, vgg, c, bad)
    assert float(parts["skipped"]) == 1.0
    for k, v in state.model.named_buffers():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    assert float(train_step(state, vgg, c, s)["skipped"]) == 0.0
    assert any(not torch.equal(v, before[k])
               for k, v in state.model.named_buffers())


def test_checkpoint_keeps_batchnorm_statistics(tmp_path):
    rng = np.random.default_rng(5)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1)))
    c, s = (torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
            for _ in range(2))
    run = _small_sel("folded")
    for _ in range(2):
        train_step(run, vgg, c, s)
    path = save_checkpoint(tmp_path, run)
    resumed = _small_sel("folded", seed=3)
    restore_checkpoint(path, resumed)
    for (k, a), b in zip(run.model.named_buffers(), resumed.model.buffers()):
        assert k.startswith("attention_block.bn")
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_drivers_serve_and_train_on_cpu(tmp_path):
    check_drivers(_corpus(tmp_path), "sel_multi_adain")
