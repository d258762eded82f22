"""Masked AdaIN, the SE attention and ``sort`` of the RP encoder blocks,
and the masked stylize of every network that reads labels, in the port on
the CPU against rpst.

Against ``tests/fixtures/torch_port_masks.npz``
(``tools/make_torch_port_fixture.py --masks``: rpst's masked stylize at
64px, batch 2, in float32 and bfloat16, of the flagship yaml's multi_adain
at full width with ``attention: se`` (and with ``sort``), ccam,
sel_multi_adain, src, seg_adain and LD v1; the SE flagship's loss,
gradients and moved BatchNorm statistics), with no JAX compile of a model.
Live rpst calls stay at op size: ``ops.segment``, the SE Conv2dBlock and
RPStack, the sort, the reference checkpoint export.

Tolerances: float32 1e-4 (rtol = atol, rpst's ``tests/test_folded.py``); a
bfloat16 stylize against rpst's bfloat16 one MAE < 1e-2, or 3 x rpst's own
bfloat16 distance from its float32 output where that is more (the north
star's bf16 rule; with ``sort`` the SE weights of near-tied channels
reorder in bfloat16, in rpst too: its own distance is then ~0.7); loss
rtol 1e-4; gradients rtol 5e-3, atol 1e-4 x the tensor's max; moved
running statistics 1e-5. Gradients rtol 5e-3, atol 1e-4 x the tensor's
max, or, where it is more, ``GRAD_SPREAD`` (2) x that tensor's own float32
error in rpst (its float32 gradient's distance from its float64 one, the
fixture's ``grads_f64/``) x its max, the rule of the slice-4 tests: the
SE BatchNorms' backward amplifies float32 rounding (the decoder's first
conv reads 1.9e-3 of max in rpst).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from rpst.models.base import sort_channels_by_attention as jax_sort
from rpst.nn.blocks import Conv2dBlock as JaxConv2dBlock
from rpst.nn.blocks import RPStack as JaxRPStack
from rpst.ops import segment as jseg
from rpst_torch import bridge
from rpst_torch.config import load_config
from rpst_torch.models import build_model, build_vgg
from rpst_torch.models.base import sort_channels_by_attention
from rpst_torch.nn.blocks import Conv2dBlock, RPStack
from rpst_torch.ops import segment

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_port_masks.npz"
YAML = REPO / "configs" / "train_constant_multiscale_rp_adain.yaml"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_MAE, BF16_OWN = 1e-2, 3.0
GRAD_SPREAD = 2.0

import sys  # noqa: E402

sys.path.insert(0, str(REPO / "tools"))
from make_photoreal_set import label_maps  # noqa: E402
from make_torch_port_fixture import MASKS  # noqa: E402


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as npz:
        return {k: npz[k] for k in npz.files}


def _tree(fx, case, coll):
    pre, tree = f"{case}/{coll}/", {}
    for key, value in fx.items():
        if key.startswith(pre):
            node = tree
            *parents, leaf = key[len(pre):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value
    return tree


def _case_state_dict(fx, case):
    """The port's state_dict of a fixture case: the stored flax trees, or
    the ``bridge`` draw from the stored seed."""
    cfg = MASKS[case]
    if f"{case}/weights_seed" in fx:
        seed = int(fx[f"{case}/weights_seed"])
        if case == "src":
            tree = bridge.src_weights_from_seed(seed)
        elif case == "seg_adain":
            tree = bridge.seg_adain_weights_from_seed(
                seed, seg_hidden_dim=cfg["seg_hidden_dim"],
                class_num=cfg["class_num"], rp_blocks=cfg["rp_blocks"],
                hidden_dim=cfg["hidden_dim"])
        else:
            tree = bridge.ld_weights_from_seed(
                case, seed, cfg["ld_layer_num"], cfg["hidden_dim"],
                cfg["stylized_layers"])
        return bridge.from_flax_params(tree)
    return {**bridge.from_flax_params(_tree(fx, case, "params")),
            **bridge.from_flax_batch_stats(_tree(fx, case, "batch_stats"))}


def _case_bundle(fx, case, dtype="float32", cfg_path=None):
    size = fx["content"].shape[1]
    over = dict(img_size=size, compute_dtype=dtype)
    cfg = (load_config(cfg_path, over) if cfg_path
           else load_config(dict(MASKS[case], **over)))
    bundle = build_model(cfg)
    bundle.load_state_dict(_case_state_dict(fx, case))
    if bundle.from_features:
        bundle.vgg = build_vgg(cfg.replace(seed=int(fx["vgg_seed"]) - 1))[0]
    return bundle


def _inputs(fx):
    return tuple(torch.from_numpy(fx[k]) for k in
                 ("content", "style", "c_labels", "s_labels"))


# ---------------------------------------------------------------- the op

def _features(rng, n, h, w, c, offset):
    """Features whose mean sits far above their spread (offset), where the
    one-pass variance cancels."""
    return (offset + rng.normal(size=(n, h, w, c))).astype(np.float32)


def masked_adain_f64(cf, sf, cl, sl, num_labels):
    """A numpy float64 oracle of the masked AdaIN, independent of both
    frameworks: each label that passes the filter (over 10 pixels on both
    sides, under 100x apart) normalized by its two-pass unbiased std."""
    out = []
    for f, g, a, b in zip(np.asarray(cf, np.float64),
                          np.asarray(sf, np.float64), cl, sl):
        o = f.copy()
        for lab in range(num_labels):
            mc, ms = a == lab, b == lab
            nc, ns = int(mc.sum()), int(ms.sum())
            if not (nc > 10 and ns > 10 and nc < 100 * ns
                    and ns < 100 * nc):
                continue
            x, y = f[mc], g[ms]
            o[mc] = ((x - x.mean(0)) / np.sqrt(x.var(0, ddof=1) + 1e-5)
                     * np.sqrt(y.var(0, ddof=1) + 1e-5) + y.mean(0))
        out.append(o)
    return np.stack(out)


def own_f32_errors(cf, sf, cl, sl):
    """The port's and rpst's float32 distances (max abs) from the float64
    oracle on the same float32 inputs."""
    oracle = masked_adain_f64(cf, sf, cl, sl, 64)
    port = segment.masked_adain_batch(*(torch.from_numpy(np.asarray(a)) for
                                        a in (cf, sf, cl, sl)), 64).numpy()
    ref = np.asarray(jseg.masked_adain_batch(cf, sf, cl, sl, 64))
    return (float(np.abs(port - oracle).max()),
            float(np.abs(ref - oracle).max()), oracle)


@pytest.mark.parametrize("case", ["four_cases", "batch", "offset"])
def test_masked_adain_matches_rpst(case):
    """The op against rpst's ``masked_adain_batch`` at f32 1e-4: one sample
    whose label maps hold the four cases (labels that pass, a region of 9
    pixels, a pair 169x apart, a label >= num_labels), a batch of three
    with a style of another size, and features 30 above their spread.
    Both frameworks take the one-pass variance in float32, which cancels
    where the mean sits far above the spread: there each is held to a
    float64 oracle (its float32 error under 2e-4 of the output's size),
    and the two to each other within 1e-4 or 2 x the larger of their own
    float32 errors, where that is more (at ``offset`` the port's error is
    9.7e-3 at outputs up to 70, rpst's 2.9e-3, on an AVX-512 CPU: the
    summation order of the one-hot products moves it)."""
    rng = np.random.default_rng(0)
    n, size, offset = {"four_cases": (1, 64, 0.0), "batch": (3, 64, 0.5),
                       "offset": (2, 64, 30.0)}[case]
    maps = [label_maps(size, rng) for _ in range(n)]
    cl = np.stack([m[0] for m in maps]).astype(np.int32)
    sl = np.stack([m[1] for m in maps]).astype(np.int32)
    cf = _features(rng, n, size, size, 6, offset)
    sf = _features(rng, n, size, size, 6, offset) * 2 + 1
    if case == "batch":  # the style on another grid, random labels
        sf = sf[:, :48, :40]
        sl = rng.integers(0, 4, size=(n, 48, 40)).astype(np.int32)
    ref = np.asarray(jseg.masked_adain_batch(cf, sf, cl, sl, 64))
    got = segment.masked_adain_batch(*(torch.from_numpy(a) for a in
                                       (cf, sf, cl, sl)), 64)
    own_port, own_rpst, oracle = own_f32_errors(cf, sf, cl, sl)
    size = float(np.abs(oracle).max())
    assert max(own_port, own_rpst) <= 2e-4 * size, (own_port, own_rpst)
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=TOL["rtol"],
        atol=max(TOL["atol"], 2 * max(own_port, own_rpst)))
    if case == "four_cases":
        untouched = np.isin(cl[0], (2, 3, 65))
        np.testing.assert_array_equal(got.numpy()[0][untouched],
                                      cf[0][untouched])
        assert not np.allclose(got.numpy()[0][cl[0] == 0],
                               cf[0][cl[0] == 0], atol=1e-2)


def test_label_validity_is_the_filter():
    """label_validity counts each label and applies rpst's rule: of the
    four cases only labels 0 and 1 pass; it agrees with the op (the pixels
    it passes are the ones the op changes)."""
    rng = np.random.default_rng(1)
    maps = [label_maps(64, rng) for _ in range(2)]
    cl = torch.from_numpy(np.stack([m[0] for m in maps]).astype(np.int64))
    sl = torch.from_numpy(np.stack([m[1] for m in maps]).astype(np.int64))
    valid = segment.label_validity(cl, sl, 64)
    assert valid.shape == (2, 64)
    assert [torch.nonzero(v).flatten().tolist() for v in valid] == [[0, 1]] * 2
    feats = torch.from_numpy(_features(rng, 2, 64, 64, 4, 0.0))
    out = segment.masked_adain_batch(feats, feats * 3, cl, sl, 64)
    changed = (out - feats).abs().amax(dim=-1) > 1e-6
    passed = valid.gather(1, cl.clamp(0, 63).flatten(1)).view_as(cl) \
        & (cl < 64)
    assert torch.equal(changed, passed)


def test_masked_adain_bfloat16_returns_bfloat16():
    """A bfloat16 feature computes in float32 and returns bfloat16, as
    rpst's cast: rpst's output on the same inputs, bit for bit but where
    the two float32 results straddle a bfloat16 rounding boundary: each
    value that differs is at most one bfloat16 step plus 2 x the larger
    of the two frameworks' own float32 errors (against the float64
    oracle) apart; 102 of 65,536 values differ on an AVX-512 CPU, where
    the port's float32 error is 6.1e-5, rpst's 1.0e-5."""
    rng = np.random.default_rng(2)
    maps = [label_maps(64, rng) for _ in range(2)]
    cl = np.stack([m[0] for m in maps]).astype(np.int32)
    sl = np.stack([m[1] for m in maps]).astype(np.int32)
    cf = torch.from_numpy(_features(rng, 2, 64, 64, 8, 1.0)).bfloat16()
    sf = torch.from_numpy(_features(rng, 2, 64, 64, 8, 2.0)).bfloat16()
    got = segment.masked_adain_batch(cf, sf, torch.from_numpy(cl),
                                     torch.from_numpy(sl), 64)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jseg.masked_adain_batch(
        jnp.asarray(cf.float().numpy(), jnp.bfloat16),
        jnp.asarray(sf.float().numpy(), jnp.bfloat16), cl, sl, 64)
        .astype(jnp.float32))
    own_port, own_rpst, oracle = own_f32_errors(
        cf.float().numpy(), sf.float().numpy(), cl, sl)
    limit = 2 * max(own_port, own_rpst)
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=limit)
    # where they differ, by one bfloat16 step beyond the two float32
    # results' spread (which near 0 spans several steps)
    differ = got != ref
    top = np.maximum(np.abs(got[differ]), np.abs(ref[differ]))
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.all(np.abs(got - ref)[differ] <= step + limit)


def test_masked_adain_leaves_autocast():
    """Under a bfloat16 autocast the op still computes in float32 (its
    one-hot products would otherwise run in bfloat16): the same float32
    output as without it."""
    rng = np.random.default_rng(3)
    cl = torch.from_numpy(label_maps(64, rng)[0][None].astype(np.int64))
    cf = torch.from_numpy(_features(rng, 1, 64, 64, 8, 4.0))
    sf = torch.from_numpy(_features(rng, 1, 64, 64, 8, 1.0))
    plain = segment.masked_adain_batch(cf, sf, cl, cl, 64)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        inside = segment.masked_adain_batch(cf, sf, cl, cl, 64)
    assert inside.dtype == torch.float32
    torch.testing.assert_close(inside, plain, rtol=0, atol=0)


# ------------------------------------------------ SE attention and sort

@pytest.mark.parametrize("train", [False, True])
def test_se_block_matches_rpst(train):
    """Conv2dBlock(attention='se') against rpst's at op size: the output,
    the SE weights, and in train mode the moved running statistics."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, 10, 8)).astype(np.float32)
    mod = JaxConv2dBlock(features=16, padding=1, attention="se")
    variables = jax.tree.map(np.array, dict(mod.init(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    variables["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables["batch_stats"])
    if train:
        (ref, att), muts = mod.apply(variables, jnp.asarray(x), train=True,
                                     return_attention=True,
                                     mutable=["batch_stats"])
    else:
        ref, att = mod.apply(variables, jnp.asarray(x),
                             return_attention=True)
    port = Conv2dBlock(8, 16, attention="se")
    port.load_state_dict({
        **bridge.from_flax_params(_np_tree(variables["params"])),
        **bridge.from_flax_batch_stats(variables["batch_stats"])})
    port.train(train)
    got, got_att = port.forward_with_attention(
        torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)
    np.testing.assert_allclose(got_att.detach()[:, :, 0, 0].numpy(),
                               np.asarray(att)[:, 0, 0, :], **TOL)
    if train:
        for bn in ("bn1", "bn2", "bn3"):
            for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
                np.testing.assert_allclose(
                    getattr(getattr(port.SEBottleneck_0, bn), buf).numpy(),
                    np.asarray(muts["batch_stats"]["SEBottleneck_0"][bn][leaf]),
                    rtol=1e-5, atol=1e-6)


def test_se_stack_intermediates_match_rpst():
    """RPStack(attention='se').intermediates_with_attention against rpst's:
    every layer's feature and SE weights."""
    rng = np.random.default_rng(5)
    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    dims = [(3, 16), (16, 16), (16, 16)]
    mod = JaxRPStack(dims=dims, attention="se")
    variables = mod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                         method=mod.intermediates_with_attention)
    feats, atts = mod.apply(variables, jnp.asarray(x),
                            method=mod.intermediates_with_attention)
    port = RPStack(dims, attention="se").eval()
    port.load_state_dict({
        **bridge.from_flax_params(_np_tree(variables["params"])),
        **bridge.from_flax_batch_stats(_np_tree(variables["batch_stats"]))})
    with torch.no_grad():
        got_f, got_a = port.intermediates_with_attention(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    for f, a, rf, ra in zip(got_f, got_a, feats, atts):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(rf), **TOL)
        np.testing.assert_allclose(a[:, :, 0, 0].numpy(),
                                   np.asarray(ra)[:, 0, 0, :], **TOL)


def test_sort_matches_rpst_with_ties():
    """sort_channels_by_attention against rpst's on SE weights with ties:
    rpst's argsort is stable, so tied channels keep their order; an
    unstable sort would break them apart."""
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    att = np.array([[0.5, 0.7, 0.5, 0.9, 0.7, 0.5, 0.1, 0.9],
                    [0.2, 0.2, 0.2, 0.2, 0.8, 0.8, 0.2, 0.2]], np.float32)
    ref = np.asarray(jax_sort(jnp.asarray(feat),
                              jnp.asarray(att[:, None, None, :])))
    got = sort_channels_by_attention(
        torch.from_numpy(feat).permute(0, 3, 1, 2),
        torch.from_numpy(att)[:, :, None, None])
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    np.testing.assert_array_equal(ref[1], feat[1][..., [4, 5, 0, 1, 2, 3, 6,
                                                        7]])


# ---------------------------------------------------- masked stylize

@pytest.mark.parametrize("case", list(MASKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_stylize_matches_rpst(fx, case, dtype):
    """ModelBundle.stylize with the labels against rpst's (the fixture):
    float32 1e-4, bfloat16 by the bf16 rule; without labels the float32
    output is rpst's unmasked one, and the masks change it (but for
    seg_adain, whose stylize reads no label, as rpst's)."""
    bundle = _case_bundle(fx, case, dtype)
    c, s, cl, sl = _inputs(fx)
    got = bundle.stylize(c, s, cl, sl).numpy()
    ref32 = fx[f"{case}/out_f32"]
    if dtype == "float32":
        np.testing.assert_allclose(got, ref32, **TOL)
        plain = bundle.stylize(c, s).numpy()
        np.testing.assert_allclose(plain, fx[f"{case}/out_nomask"], **TOL)
        effect = np.abs(ref32 - fx[f"{case}/out_nomask"]).max()
        assert effect == 0.0 if case == "seg_adain" else effect > 1e-3
        return
    ref = fx[f"{case}/out_bf16"]
    mae = np.abs(got - ref).mean()
    own = np.abs(ref - ref32).mean()
    assert np.isfinite(got).all() and mae < max(BF16_MAE, BF16_OWN * own), \
        (mae, own)


def test_se_flagship_loss_and_grads_match_rpst(fx):
    """The flagship yaml's model (attention se, use_mask) in training: the
    standard path in train mode, the SE BatchNorms on batch statistics
    moving their running ones, against rpst's float32 ModelBundle.loss:
    loss parts, every gradient, the moved statistics."""
    bundle = _case_bundle(fx, "multi_adain", cfg_path=YAML)
    assert not (bundle.folded_infer() or bundle.q8_infer())
    bundle.model.train()
    c, s, _, _ = _inputs(fx)
    vgg = build_vgg(bundle.cfg.replace(seed=int(fx["vgg_seed"]) - 1))[0]
    total, parts = bundle.loss(vgg, c, s)
    total.backward()
    for k in ("content_loss", "style_loss", "total_loss"):
        np.testing.assert_allclose(float(parts[k].detach()),
                                   float(fx[f"multi_adain/{k}"]), rtol=1e-4,
                                   err_msg=k)
    ref = bridge.from_flax_params(_tree(fx, "multi_adain", "grads"))
    f64 = bridge.from_flax_params(_tree(fx, "multi_adain", "grads_f64"))
    grads = {n: p.grad for n, p in bundle.model.named_parameters()}
    assert set(ref) == set(grads) == set(f64)
    for name, g in ref.items():
        size = float(f64[name].abs().max())
        if size == 0.0:  # no gradient reaches it in rpst either
            assert float(grads[name].abs().max()) < 1e-9, name
            continue
        own = float((g - f64[name]).abs().max()) / size
        np.testing.assert_allclose(
            grads[name].numpy(), g.numpy(), rtol=5e-3,
            atol=max(1e-4, GRAD_SPREAD * own) * size, err_msg=name)
    moved = bridge.from_flax_batch_stats(_tree(fx, "multi_adain",
                                               "stats_after"))
    sd = bundle.model.state_dict()
    for name, v in moved.items():
        np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_bridge_round_trips_se_state(fx, tmp_path):
    """The SE flagship's weights cross both bridges: rpst's flax tree
    (``SEBottleneck_0`` with its ``batch_stats``; also as an npz of
    ``params/`` and ``batch_stats/`` paths through ``load_weights``) and
    the reference ``.pth`` of ``tools/export_reference_checkpoint.py``
    (``{i}.attention_block.*``); both give the model's every key, equal."""
    from export_reference_checkpoint import export_tree
    params = _tree(fx, "multi_adain", "params")
    stats = _tree(fx, "multi_adain", "batch_stats")
    flax_sd = _case_state_dict(fx, "multi_adain")
    port = build_model(load_config(YAML, dict(img_size=64))).model
    assert set(flax_sd) == set(port.state_dict())
    ref_sd = bridge.from_reference_checkpoint(export_tree(params, stats))
    assert set(ref_sd) == set(flax_sd)
    for k in flax_sd:
        torch.testing.assert_close(ref_sd[k], flax_sd[k], rtol=0, atol=0)
    npz = tmp_path / "w.npz"
    np.savez(npz, **{f"params/{k}": v for k, v in fx.items()
                     if k.startswith("multi_adain/params/")
                     for k in [k[len("multi_adain/params/"):]]},
             **{f"batch_stats/{k}": v for k, v in fx.items()
                if k.startswith("multi_adain/batch_stats/")
                for k in [k[len("multi_adain/batch_stats/"):]]})
    loaded = bridge.load_weights(npz)
    assert set(loaded) == set(flax_sd)
    for k in flax_sd:
        torch.testing.assert_close(loaded[k], flax_sd[k], rtol=0, atol=0)


def test_labels_keep_rpsts_gates(fx):
    """rpst's gates: a labelled stylize never takes the folded path (it
    runs standard, and equals the standard model's output), an explicit
    ``folded=True`` with labels is refused, and ``use_mask`` keeps the
    folded and int8 paths shut."""
    c, s, cl, sl = _inputs(fx)
    cfg = load_config(dict(network="multi_adain", rp_blocks=3, hidden_dim=32,
                           img_size=64, exec_strategy="folded"))
    folded = build_model(cfg)
    from rpst_torch.nn.blocks import init_torch_default
    init_torch_default(folded.model, 0)
    assert folded.folded_infer()
    std = build_model(cfg.replace(exec_strategy="standard"))
    std.load_state_dict(folded.model.state_dict())
    torch.testing.assert_close(folded.stylize(c, s, cl, sl), std.stylize(c, s),
                               **TOL)
    with pytest.raises(ValueError, match="no labels"):
        folded.stylize(c, s, cl, sl, folded=True)
    masked = build_model(cfg.replace(use_mask=True))
    assert not (masked.folded_infer() or masked.q8_infer())
