"""ccam (CCAMRP: the flagship's stack with a cross-channel attention
residual before each decoder block) of the port on the CPU: ``CCAMDec`` at
its own size with a non-zero ``scale`` against rpst's flax module, the
folded form (one (4C, 4C) product, its diagonal blocks summed, kron(I4,
attention)) against the unfolded module, the int8 form against rpst's, the
standard module (with the test-time channel shuffle) against flax, and the
network against ``tests/fixtures/torch_port_ccam.npz``
(``tools/make_torch_port_fixture.py --ccam``, scales 0.3 .. 0.7). The
tolerances and helpers are test_torch_sel_multi_adain.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.models import fast_path_q8 as jq8
from rpst.models.adain_rp import CCAMDec as JaxCCAMDec
from rpst.models.adain_rp import CCAMRP as JaxCCAMRP
from rpst_torch.bridge import from_flax_params
from rpst_torch.models.adain_rp import CCAMRP, CCAMDec
from rpst_torch.models.fast_path import _folded_ccam
from rpst_torch.models.fast_path_q8 import _folded_ccam_q8
from rpst_torch.ops.folded import fold, unfold
from test_torch_sel_multi_adain import (TOL, _corpus, _np_tree,
                                        check_drivers,
                                        check_loss_grads_trajectory,
                                        check_q8, check_stylize,
                                        fixture_bundle, fixture_params,
                                        images, load_fixture)
from test_torch_sel_multi_adain import one_torch_thread  # noqa: F401


def _features(seed, shape=(2, 6, 8, 16)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def test_ccam_dec_matches_flax_with_a_nonzero_scale():
    x, y = _features(0)
    mod = JaxCCAMDec()
    params = {"scale": jnp.full((1,), 0.7)}
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(y)))
    port = CCAMDec()
    port.load_state_dict({"scale": torch.full((1,), 0.7)})
    got = port(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, y)))
    got = got.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(got - x).max() > 1e-2  # the attention term is there


def test_folded_ccam_is_the_unfolded_module():
    """The (4C, 4C) cross product's diagonal-block sum and the kron(I4,
    attention) recombination are exact: the folded form equals CCAMDec on
    the unfolded features, and only ``scale`` gets a gradient."""
    x, y = _features(1, (2, 8, 6, 16))
    port = CCAMDec()
    port.load_state_dict({"scale": torch.full((1,), 0.4)})
    ref = port(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, y)))
    scale = torch.full((1,), 0.4, requires_grad=True)
    xt, yt = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    got = _folded_ccam(fold(xt), fold(yt), scale)
    np.testing.assert_allclose(unfold(got).detach().numpy(),
                               ref.detach().permute(0, 2, 3, 1).numpy(),
                               **TOL)
    got.sum().backward()
    assert scale.grad is not None and xt.grad is None and yt.grad is None


@pytest.mark.parametrize("quantized", [False, True])
def test_folded_ccam_q8_matches_rpst(quantized):
    """rpst's ``_folded_ccam_q8`` on (int8, scale) pairs (the energy
    reduced over int8, exact) or float features."""
    rng = np.random.default_rng(2)
    if quantized:
        xq, yq = (rng.integers(-127, 128, (2, 4, 6, 64), dtype=np.int8)
                  for _ in range(2))
        jx, jy = (jnp.asarray(xq), 0.02), (jnp.asarray(yq), 0.03)
        tx, ty = (torch.from_numpy(xq), 0.02), (torch.from_numpy(yq), 0.03)
    else:
        xf = rng.normal(size=(2, 4, 6, 64)).astype(np.float32)
        yq = rng.integers(-127, 128, (2, 4, 6, 64), dtype=np.int8)
        jx, jy = jnp.asarray(xf), (jnp.asarray(yq), 0.03)
        tx, ty = torch.from_numpy(xf), (torch.from_numpy(yq), 0.03)
    ref = np.asarray(jq8._folded_ccam_q8(jx, jy, jnp.float32(0.5)))
    got = _folded_ccam_q8(tx, ty, torch.tensor(0.5))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shuffle", [False, True])
def test_standard_module_matches_flax(shuffle):
    rng = np.random.default_rng(3)
    c, s = (rng.random((2, 16, 16, 3), dtype=np.float32) for _ in range(2))
    jm = JaxCCAMRP(rp_blocks=3, hidden_dim=16, shuffle=shuffle,
                   stylized_layers=2)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(c), jnp.asarray(s))
    params = dict(_np_tree(v["params"]))
    for i in range(3):
        params[f"ccam_{i}"] = {"scale": np.full((1,), 0.3 + 0.2 * i,
                                                np.float32)}
    ref = jm.apply({"params": params}, jnp.asarray(c), jnp.asarray(s),
                   test_mode=True)
    port = CCAMRP(rp_blocks=3, hidden_dim=16, shuffle=shuffle,
                  stylized_layers=2)
    port.load_state_dict(from_flax_params(params))
    got = port(torch.from_numpy(c), torch.from_numpy(s), test_mode=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_stylize_and_shuffled_standard_match_rpst():
    fx, _ = check_stylize("ccam")
    shuffled, _ = fixture_bundle("ccam", fx, shuffle=True)
    assert not shuffled.folded_infer()  # the yaml's shuffle does not fold
    got = shuffled.stylize(*images(fx))
    np.testing.assert_allclose(got.numpy(), fx["out_std_shuffle"], **TOL)


def test_loss_gradients_and_trajectory_match_rpst():
    fx, bundle = check_loss_grads_trajectory("ccam")
    scales = [float(m.scale.detach()) for m in
              bundle.model.channel_attentions]
    assert scales == pytest.approx([0.3, 0.4, 0.5, 0.6, 0.7])
    assert all(m.scale.grad is not None and float(m.scale.grad.abs()) > 0
               for m in bundle.model.channel_attentions)


def test_q8_matches_rpst():
    check_q8("ccam", 1e-4)


def test_fixture_loads_every_parameter():
    fx = load_fixture("ccam")
    bundle, _ = fixture_bundle("ccam", fx)
    assert sorted(bundle.model.state_dict()) == sorted(
        from_flax_params(fixture_params(fx)))


def test_drivers_serve_and_train_on_cpu(tmp_path):
    check_drivers(_corpus(tmp_path), "ccam")
