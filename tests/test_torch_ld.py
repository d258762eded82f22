"""The LD family (``ld_adain`` .. ``ld_adain5``) of the port on the CPU: its
pieces against rpst at op size, each variant's standard stylize, loss,
gradients and trajectory against ``tests/fixtures/torch_port_ld_adain*.npz``
(``tools/make_torch_port_fixture.py --ld``: 32px, batch 2, the yamls'
widths), and the two drivers. The int8 path and B5's 7x7 form are
``tests/test_torch_ld_q8.py``.

Live rpst only at op size: ``_resize_nearest`` over a size sweep,
``VGGishBigBranch`` and ``NonOverlapConvTranspose`` against flax (and rpst's
rewrite at s = 32), ``LDAdaINRP`` at small widths on the weights of
``bridge.ld_weights_from_seed`` (rpst's param tree, leaf for leaf).

Tolerances (tests/test_torch_mrf.py, whose helpers run the fixture cases;
the fixtures' float64 gradients have rpst's feature statistics in float64,
and the port's float64 run takes its own so):
the ops 1e-5 (indices equal); modules and the float32 stylize 1e-4; the
bfloat16 stylize against rpst's bfloat16 one MAE < 1e-2, or 3 x rpst's own
bfloat16 distance from its float32 output where that is more; loss parts
rtol 1e-4; gradients in float64 within 1e-4 of max of rpst's float64 ones,
in float32 within 2 x the larger of the two frameworks' own float32 errors
(each one's float32 against its float64); the trajectory's first loss rtol
1e-4, steps 2-3 rtol 1e-2.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from rpst.models import ld_adain as jld
from rpst_torch.bridge import from_flax_params, ld_weights_from_seed
from rpst_torch.config import load_config
from rpst_torch.models import ModelBundle, build_model, roadmap_slice
from rpst_torch.models import ld_adain as ld
from test_torch_mrf import (check_loss_grads_trajectory, check_steps,
                            check_stylize, run_serve, run_train)
from test_torch_sel_multi_adain import _corpus as corpus
from torch_threads import one_torch_thread  # noqa: F401

LD = ("ld_adain", "ld_adain2", "ld_adain3", "ld_adain4", "ld_adain5")
OP_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _variant(network):
    return 1 if network == "ld_adain" else int(network[-1])


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _upsampler(params, c, co, s):
    """The port's upsampler on a flax module's params, through the bridge
    as ``up_0`` (the kernel keeps flax's (s, s, C, Co) layout)."""
    sd = from_flax_params({"up_0": params})
    assert set(sd) == {"up_0.kernel", "up_0.bias"}
    port = ld.NonOverlapConvTranspose(c, co, s)
    port.load_state_dict({k[len("up_0."):]: v for k, v in sd.items()})
    assert tuple(port.kernel.shape) == (s, s, c, co)
    return port


# ------------------------------------------------------------------ pieces

def test_resize_nearest_matches_rpst_over_sizes():
    """Every source size 3 .. 600 to the sizes the family resizes between:
    the pooled branch's (ceil(H / 2) + 2) -> H, the v5 upsampler's
    overshoot back to H, and a shrink; the index maps equal rpst's (torch's
    nearest rule in integers). rpst's own code runs with numpy standing in
    for jax.numpy (one jnp call per size would compile per shape); the real
    jnp function is checked on a sample of the same pairs."""
    rpst_np = types.FunctionType(jld._resize_nearest.__code__, {"jnp": np})
    pairs = []
    for h in range(3, 601):
        pairs += [(-(-h // 2) + 2, h), (2 * h + 3, h), (h, h // 2 + 1)]
    for src, dst in pairs:
        x = np.broadcast_to(np.arange(src, dtype=np.float32)[None, :, None,
                                                              None],
                            (1, src, 3, 1)).copy()
        got = ld.resize_nearest(torch.from_numpy(x), dst, 2).numpy()
        assert np.array_equal(got, rpst_np(x, dst, 2)), (src, dst)
    for src, dst in pairs[::97]:
        x = np.arange(src * 3, dtype=np.float32).reshape(1, src, 3, 1)
        np.testing.assert_array_equal(
            ld.resize_nearest(torch.from_numpy(x), dst, 2).numpy(),
            np.asarray(jld._resize_nearest(jnp.asarray(x), dst, 2)))
    # the NCHW form is the same map
    x = torch.arange(7 * 9, dtype=torch.float32).reshape(1, 7, 9, 1)
    np.testing.assert_array_equal(
        ld.resize_nearest(x.permute(0, 3, 1, 2), 12, 5,
                          channels_last=False).permute(0, 2, 3, 1).numpy(),
        ld.resize_nearest(x, 12, 5).numpy())


@pytest.mark.parametrize("size,trailing_pad", [(5, True), (9, False),
                                               (17, True), (32, False)])
def test_vggish_big_branch_matches_flax(size, trailing_pad):
    """1x1 -> (reflect 3x3, relu) x 2 -> ceil-mode 2x2 max pool (flax's
    SAME padding at odd sizes) -> [trailing reflect pad]."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 6)).astype(np.float32)
    jm = jld.VGGishBigBranch(features=8, trailing_pad=trailing_pad)
    params = jm.init(jax.random.PRNGKey(size), jnp.asarray(x))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = ld.VGGishBigBranch(6, 8, trailing_pad)
    port.load_state_dict(from_flax_params(params))
    got = port(_nchw(x)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **OP_TOL)


def test_v3_coarse_stream_at_32px_runs_rpst_sizes():
    """v3's pooled stream with its trailing pad: 32 -> 18 -> 11 -> 8 -> 6
    -> 5, odd sizes through the ceil-mode pool."""
    x = torch.zeros(1, 4, 32, 32)
    sizes = []
    for _ in range(5):
        x = ld.VGGishBigBranch(4, 4, True)(x)
        sizes.append(x.shape[2])
    assert sizes == [18, 11, 8, 6, 5]


@pytest.mark.parametrize("s", [2, 4, 8])
def test_nonoverlap_conv_transpose_matches_flax_conv_transpose(s):
    """The projection + depth-to-space rewrite against flax's own
    ``nn.ConvTranspose`` (kernel = stride) on the same (s, s, C, Co) kernel
    (the oracle of tests/test_models.py), the kernel in flax's layout
    through the bridge."""
    x = np.random.default_rng(s).normal(size=(2, 8, 6, 16)).astype(
        np.float32)
    ref_mod = nn.ConvTranspose(features=12, kernel_size=(s, s),
                               strides=(s, s))
    params = ref_mod.init(jax.random.PRNGKey(s), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a + 0.1, params)  # a non-zero bias
    ref = np.asarray(ref_mod.apply({"params": params}, jnp.asarray(x)))
    port = _upsampler(params, 16, 12, s)
    got = port(_nchw(x)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **OP_TOL)


def test_nonoverlap_conv_transpose_matches_rpst_at_s32():
    """The deepest v5 upsampler (s = 32) against rpst's rewrite."""
    x = np.random.default_rng(32).normal(size=(2, 1, 2, 8)).astype(np.float32)
    jm = jld.NonOverlapConvTranspose(features=8, kernel_size=(32, 32),
                                     strides=(32, 32))
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a + 0.05, params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = _upsampler(params, 8, 8, 32)
    got = port(_nchw(x)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 32, 64, 8)
    np.testing.assert_allclose(got, ref, **OP_TOL)


@pytest.mark.parametrize("network", LD)
@pytest.mark.parametrize("layers,hidden,stylized,size", [
    (3, 8, 3, 16), (4, 8, 2, 17)])
def test_module_matches_flax(network, layers, hidden, stylized, size):
    """LDAdaINRP against rpst's flax module at small widths on
    ``ld_weights_from_seed``'s weights (whose tree is flax's, leaf for
    leaf): the fusion rules, the clean skip at stylized_layers < layers,
    odd sizes through the pooled branch and v5's resize of an overshoot."""
    variant = _variant(network)
    rng = np.random.default_rng(variant)
    c, s = (rng.random((2, size, size, 3), dtype=np.float32)
            for _ in range(2))
    jm = jld.LDAdaINRP(variant=variant, layer_num=layers, hidden_dim=hidden,
                       stylized_layers=stylized)
    tree = ld_weights_from_seed(network, variant, layers, hidden, stylized)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(c),
                            jnp.asarray(s))["params"]
    assert jax.tree.map(lambda a: a.shape, shapes) == \
        jax.tree.map(lambda a: a.shape, tree)
    ref = np.asarray(jm.apply({"params": jax.tree.map(jnp.asarray, tree)},
                              jnp.asarray(c), jnp.asarray(s)))
    port = ld.LDAdaINRP(variant=variant, layer_num=layers,
                        hidden_dim=hidden, stylized_layers=stylized)
    port.load_state_dict(from_flax_params(tree))
    got = port(torch.from_numpy(c), torch.from_numpy(s)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("network", ["ld_adain", "ld_adain2"])
def test_batched_encode_equals_per_pair(network, monkeypatch):
    """v1 always encodes one 2N batch, v2 from the policy's batch on; both
    compute the same function: a batch of 4 equals each pair alone, across
    v2's gate, to the float32 modules' 1e-4 (the CPU's convs pick their
    summation order by batch: 1.1e-5 apart at values ~0.07)."""
    from rpst_torch import policy
    monkeypatch.setattr(policy, "LD2_2N_ENCODE_MIN_BATCH", 4)
    model = ld.LDAdaINRP(variant=_variant(network), layer_num=3,
                         hidden_dim=8, stylized_layers=3)
    model.load_state_dict(from_flax_params(ld_weights_from_seed(
        network, 2, 3, 8, 3)))
    rng = np.random.default_rng(2)
    c, s = (torch.from_numpy(rng.random((4, 16, 16, 3), dtype=np.float32))
            for _ in range(2))
    with torch.no_grad():
        batched = model(c, s)
        for i in range(4):
            torch.testing.assert_close(batched[i:i + 1],
                                       model(c[i:i + 1], s[i:i + 1]),
                                       **TOL)


def test_masks_raise_and_use_mask_serves_plain_adain():
    """``use_mask`` without labels (the v1 and v4 yamls set it) stylizes as
    plain AdaIN, as in rpst; with labels (slice 7 ported them: the refusal
    this test pinned is gone, its name kept) v4's content-side fusion is
    the masked AdaIN, as rpst's ``LDAdaINRP`` in test mode, f32 1e-4."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from make_photoreal_set import label_maps
    rng = np.random.default_rng(4)
    c, s = (torch.from_numpy(rng.random((1, 32, 32, 3), dtype=np.float32))
            for _ in range(2))
    tree = ld_weights_from_seed("ld_adain4", 4, 3, 8, 3)
    outs = []
    for use_mask in (False, True):
        cfg = load_config(dict(network="ld_adain4", rp_blocks=3,
                               hidden_dim=8, img_size=32, use_mask=use_mask))
        bundle = build_model(cfg)
        bundle.load_state_dict(from_flax_params(tree))
        outs.append(bundle.stylize(c, s))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    cl, sl = (torch.from_numpy(m[None].astype(np.int64))
              for m in label_maps(32, rng))
    masked = bundle.stylize(c, s, cl, sl)
    jm = jld.LDAdaINRP(variant=4, layer_num=3, hidden_dim=8,
                       stylized_layers=3, use_mask=True)
    ref = jm.apply({"params": tree}, jnp.asarray(c.numpy()),
                   jnp.asarray(s.numpy()), c_labels=jnp.asarray(cl.numpy()),
                   s_labels=jnp.asarray(sl.numpy()), test_mode=True)
    np.testing.assert_allclose(masked.numpy(), np.asarray(ref), **TOL)
    assert not torch.allclose(masked, outs[1], atol=1e-4)


def test_config_and_registry():
    """ld_layer_num defaults to rp_blocks (rpst's schema); every LD network
    builds, none is left to a later slice; the yamls' v3 singlescale
    (stylized_layers 1) builds the narrower decoder."""
    cfg = load_config(dict(network="ld_adain", rp_blocks=4))
    assert cfg.ld_layer_num == 4
    assert load_config(dict(network="ld_adain", rp_blocks=4,
                            ld_layer_num=3)).ld_layer_num == 3
    for network in LD:
        assert roadmap_slice(network) is None
        assert build_model(load_config(dict(network=network))).vgg_stages == 4
    single = build_model(load_config(
        "configs/train_ld3_singlescale_rp_adain.yaml"))
    assert single.model.stylized_layers == 1
    assert [d.PadConv_0.Conv_0.out_channels
            for d in single.model.decs()] == [32, 32, 32, 32, 3]
    assert isinstance(single, ModelBundle)


# ---------------------------------------------------------------- fixture

@pytest.mark.parametrize("network", LD)
def test_stylize_matches_rpst(network):
    check_stylize(network)


@pytest.mark.parametrize("network", LD)
def test_loss_gradients_and_trajectory_match_rpst(network):
    """The float64 run with the feature statistics in float64 on both sides
    (the fixture's ``f64/`` keys): with them rounded to float32, as both
    frameworks compute them, the float64 gradients sit up to 4e-4 of max
    apart; in float64 they agree to 5e-8 (at op size, ld_adain4)."""
    check_loss_grads_trajectory(network, f64_stats=True)


# ---------------------------------------------------------------- drivers

@pytest.mark.parametrize("network", LD)
def test_drivers_serve_and_train_on_cpu(tmp_path, network):
    """serve_torch.py standard and train_torch.py (3 steps) at 32px, 3
    layers."""
    root = corpus(tmp_path)
    assert len(run_serve(root, network, "standard", hidden_dim=8)) == 2
    check_steps(run_train(root, network))
