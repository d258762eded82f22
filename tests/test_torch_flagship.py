"""The port's flagship (multi_adain, constant stack) against rpst on the CPU:
the bridged standard model against flax MultiScaleAdaINRP, the folded
stylize against rpst's stylize_multi_adain_folded, and folded against
standard within the port. Same numpy-seeded inputs, same flax params."""

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


@pytest.mark.parametrize("network", ["seg_adain", "sel_multi_adain", "ccam",
                                     "dynamic_sanet", "ld_adain"])
def test_unported_networks_raise(network):
    with pytest.raises(ValueError, match="ROADMAP.md section A slice"):
        build_model(load_config(dict(network=network)))


@pytest.mark.parametrize("extra", [dict(attention="se"), dict(use_mask=True),
                                   dict(inception_num=1), dict(shuffle=True),
                                   dict(enc_stack_way="deeper")])
def test_unported_options_raise(extra):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(load_config(dict(SMALL, hidden_dim=8, **extra)))
