"""The port's flagship (multi_adain, constant stack) against rpst on the CPU:
the bridged standard model against flax MultiScaleAdaINRP, the folded
stylize against rpst's stylize_multi_adain_folded, and folded against
standard within the port. Same numpy-seeded inputs, same flax params."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.config import load_config
from rpst.models import build_model as j_build_model
from rpst.models.fast_path import stylize_multi_adain_folded as j_folded
from rpst_torch.bridge import from_flax_params
from rpst_torch.models import build_model
from rpst_torch.models.fast_path import (folded_blocks,
                                         stylize_multi_adain_folded)
from rpst_torch.ops.folded_conv import fused_folded_conv
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

SMALL = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=3,
             attention="none", inception_num=0)


def _setup(rng, hidden=8, size=16, n=1, **cfg_extra):
    """(jax params, content, style numpy, port bundle with those weights)."""
    cfg = load_config(dict(SMALL, hidden_dim=hidden, img_size=size,
                           **cfg_extra))
    content = rng.random((n, size, size, 3), dtype=np.float32)
    style = rng.random((n, size, size, 3), dtype=np.float32)
    jb = j_build_model(cfg)
    params = jb.model.init(jax.random.PRNGKey(0), jnp.asarray(content),
                           jnp.asarray(style))["params"]
    bundle = build_model(cfg)
    bundle.load_state_dict(from_flax_params(params))
    return jb, params, content, style, bundle


@pytest.mark.parametrize("hidden,size,n", [(8, 16, 2), (32, 16, 1)])
def test_standard_model_matches_flax(rng, hidden, size, n):
    jb, params, content, style, bundle = _setup(rng, hidden, size, n)
    ref = jb.model.apply({"params": params}, jnp.asarray(content),
                         jnp.asarray(style))
    got = bundle.stylize(torch.from_numpy(content), torch.from_numpy(style))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("batch_encode", [False, True])
def test_folded_matches_rpst_folded(rng, batch_encode):
    jb, params, content, style, bundle = _setup(rng, 32, 32, 2)
    ref = j_folded(params, jnp.asarray(content), jnp.asarray(style),
                   dtype=jnp.float32, use_pallas=False,
                   batch_encode=batch_encode)
    with torch.inference_mode():
        got = stylize_multi_adain_folded(
            folded_blocks(bundle.model, torch.float32),
            torch.from_numpy(content), torch.from_numpy(style),
            dtype=torch.float32, batch_encode=batch_encode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_folded_matches_standard_and_counts_no_cpu_launch(rng):
    """exec_strategy=folded through ModelBundle.stylize == the standard
    model (the bounds of tests/test_folded.py); on CPU tensors the B1
    wrapper takes its plain version and the launch count stays put."""
    _, _, content, style, folded = _setup(rng, 8, 32, 1,
                                          exec_strategy="folded")
    assert folded.folded_exec()
    standard = build_model(folded.cfg.replace(exec_strategy="standard"))
    standard.load_state_dict(folded.model.state_dict())
    assert not standard.folded_exec()
    c, s = torch.from_numpy(content), torch.from_numpy(style)
    before = fused_folded_conv.launches
    got = folded.stylize(c, s)
    assert fused_folded_conv.launches == before
    ref = standard.stylize(c, s)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(got.numpy() - ref.numpy()).mean() < 1e-5


def test_bf16_folded_near_f32(rng):
    """compute_dtype=bfloat16 folds the weights in bf16; pixels stay within
    the <1e-2 MAE budget of the f32 result."""
    _, _, content, style, bundle = _setup(rng, 8, 16, 1,
                                          exec_strategy="folded",
                                          compute_dtype="bfloat16")
    c, s = torch.from_numpy(content), torch.from_numpy(style)
    got = bundle.stylize(c, s)
    assert got.dtype == torch.float32
    with torch.inference_mode():
        ref = stylize_multi_adain_folded(bundle.folded_weights(torch.float32),
                                         c, s, dtype=torch.float32)
    assert np.abs(got.numpy() - ref.numpy()).mean() < 1e-2


def test_load_state_dict_refolds(rng):
    """New weights invalidate the cached folded weights."""
    _, _, content, style, bundle = _setup(rng, 8, 16, 1,
                                          exec_strategy="folded")
    c, s = torch.from_numpy(content), torch.from_numpy(style)
    first = bundle.stylize(c, s)
    sd = {k: v * 0.5 for k, v in bundle.model.state_dict().items()}
    bundle.load_state_dict(sd)
    assert not torch.equal(bundle.stylize(c, s), first)


@pytest.mark.parametrize("network", ["ld_adain3", "ld_adain4", "ld_adain2",
                                     "ld_adain5", "ld_adain"])
def test_unported_networks_raise(network):
    """The LD networks, the last that ``build_model`` refused (slice 5b),
    build at their yamls' widths and stylize a 32px pair (these cases keep
    their ids); no registry network is left to a later slice."""
    from pathlib import Path

    from rpst_torch.config import load_config as port_config
    from rpst_torch.models import roadmap_slice
    from rpst_torch.nn.blocks import init_torch_default
    tag = {"ld_adain": "ld"}.get(network, f"ld{network[-1]}")
    cfg = port_config(Path(__file__).resolve().parent.parent / "configs"
                      / f"train_{tag}_multiscale_rp_adain.yaml",
                      dict(img_size=32))
    assert roadmap_slice(network) is None
    bundle = build_model(cfg)
    init_torch_default(bundle.model, 0)
    rng = np.random.default_rng(1)
    c, s = (torch.from_numpy(rng.random((1, 32, 32, 3), dtype=np.float32))
            for _ in range(2))
    out = bundle.stylize(c, s)
    assert out.shape == (1, 32, 32, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("extra", [dict(attention="se"), dict(use_mask=True),
                                   dict(inception_num=1), dict(sort=True),
                                   dict(enc_stack_way="deeper"),
                                   dict(attention="sk")])
def test_unported_options_raise(extra):
    """The options the refusal pinned until the port built them, SE
    attention, the masks and sort (slice 7), inception, the deeper stacks
    and SK attention (slice 4's remainder), build and stylize as rpst's
    (these cases keep their ids): the flax weights through the bridge,
    test mode with seeded label maps, f32 1e-4."""
    from make_photoreal_set import label_maps
    from rpst_torch.bridge import from_flax_batch_stats
    rng = np.random.default_rng(7)
    over = dict(attention="se", **extra) if "sort" in extra else extra
    cfg = load_config(dict(SMALL, hidden_dim=16, img_size=32, **over))
    c, s = (rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(2))
    maps = [label_maps(32, rng) for _ in range(2)]
    cl, sl = (np.stack([m[i] for m in maps]).astype(np.int32)
              for i in (0, 1))
    jb = j_build_model(cfg)
    v = jax.tree.map(np.asarray, dict(jb.model.init(
        jax.random.PRNGKey(0), jnp.asarray(c), jnp.asarray(s))))
    ref = jb.stylize(v, None, jnp.asarray(c), jnp.asarray(s),
                     jnp.asarray(cl), jnp.asarray(sl))
    bundle = build_model(cfg)
    bundle.load_state_dict({
        **from_flax_params(v["params"]),
        **from_flax_batch_stats(v.get("batch_stats", {}))})
    got = bundle.stylize(*(torch.from_numpy(a) for a in (c, s, cl, sl)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert not bundle.folded_infer()


@pytest.mark.parametrize("option", [dict(norm="bn"), dict(norm="in"),
                                    dict(activation="prelu")])
def test_block_refusals_name_a_queued_slice(option):
    """rpst's Conv2dBlock norm bn / in and prelu (``nn/blocks.py:142-155``),
    which the port refused naming slice 4's remainder until it built them
    (the cases keep their ids), match rpst's at op size in train and eval
    mode: the output, and for bn the moved running statistics."""
    from rpst.nn.blocks import Conv2dBlock as JaxConv2dBlock
    from rpst_torch.bridge import from_flax_batch_stats
    from rpst_torch.nn.blocks import Conv2dBlock
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, 9, 6)).astype(np.float32)
    mod = JaxConv2dBlock(features=8, padding=1, **option)
    v = jax.tree.map(np.array, dict(mod.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x))))
    port = Conv2dBlock(6, 8, **option)
    port.load_state_dict({
        **from_flax_params(v["params"]),
        **from_flax_batch_stats(v.get("batch_stats", {}))})
    for train in (False, True):
        if train:
            ref, muts = mod.apply(v, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        else:
            ref, muts = mod.apply(v, jnp.asarray(x)), {}
        port.train(train)
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), rtol=1e-4, atol=1e-4)
        for name, buf in from_flax_batch_stats(
                muts.get("batch_stats", {})).items():
            np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                       buf.numpy(), rtol=1e-5, atol=1e-6)


def test_bf16_folded_stylize_matches_rpst():
    """The bfloat16 folded flagship (compute_dtype bfloat16: rpst's
    ``_folded_dtype``) against rpst's bfloat16 folded stylize, full width
    at 64px on the flagship fixture's params: MAE < 1e-2, the bf16 budget
    above (the two frameworks round bfloat16 at other places), and no
    further from rpst's float32 output than rpst's own bfloat16 output is,
    give or take that budget."""
    from pathlib import Path

    from rpst_torch.bridge import flax_tree_from_npz
    fixture = (Path(__file__).resolve().parent / "fixtures"
               / "torch_port_flagship.npz")
    with np.load(fixture) as npz:
        params = flax_tree_from_npz(npz)
        content, style, out_f32 = (npz[k] for k in ("content", "style",
                                                    "out"))
    cfg = load_config(dict(SMALL, rp_blocks=5, hidden_dim=32,
                           img_size=content.shape[1],
                           exec_strategy="folded", compute_dtype="bfloat16"))
    jb = j_build_model(cfg)
    ref = np.asarray(jax.jit(lambda p, c, s: jb.stylize(
        {"params": p}, None, c, s))(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(content),
                                     jnp.asarray(style)), np.float32)
    bundle = build_model(cfg)
    bundle.load_state_dict(from_flax_params(params))
    got = bundle.stylize(torch.from_numpy(content), torch.from_numpy(style))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).mean() < 1e-2
    assert np.abs(got.numpy() - out_f32).mean() < \
        np.abs(ref - out_f32).mean() + 1e-2
