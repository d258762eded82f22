"""mst (MSTRP: the flagship's stack with k-means channel matching at the
deepest scale) of the port on the CPU: ``ops.kmeans``, ``ops.graphcut`` and
``ops.mst`` against rpst's at op size, the standard module against flax,
and the network against ``tests/fixtures/torch_port_mst.npz``
(``tools/make_torch_port_fixture.py --mst``), its deepest scale's labels
equal to rpst's. The tolerances and helpers are
test_torch_sel_multi_adain.py's; the gradients reach the decoder only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.models.adain_rp import MSTRP as JaxMSTRP
from rpst.ops import graphcut as jgraphcut
from rpst.ops import kmeans as jkmeans
from rpst.ops import mst as jmst
from rpst_torch.bridge import from_flax_params
from rpst_torch.models.adain_rp import MSTRP
from rpst_torch.ops.graphcut import chain_map_labeling, potts_pairwise
from rpst_torch.ops.kmeans import kmeans
from rpst_torch.ops.mst import mst_transfer, mst_transfer_batch
from test_torch_sel_multi_adain import (TOL, _corpus, _np_tree,
                                        check_drivers,
                                        check_loss_grads_trajectory,
                                        check_q8, check_stylize,
                                        fixture_bundle, images, load_fixture)
from test_torch_sel_multi_adain import one_torch_thread  # noqa: F401


def _clusters(seed, n=24, d=40, k=3):
    """Points around k well separated centers (and the first point on a
    cluster, as farthest-point seeding starts there)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 5
    labels = rng.integers(0, k, n)
    return (centers[labels] + rng.normal(size=(n, d)) * 0.3).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_matches_rpst(seed):
    x = _clusters(seed)
    ref_labels, ref_centers = jkmeans.kmeans(jnp.asarray(x), 3)
    labels, centers = kmeans(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_allclose(centers.numpy(), np.asarray(ref_centers),
                               rtol=1e-5, atol=1e-5)


def test_kmeans_ties_and_empty_clusters_follow_rpst():
    """Duplicate points (an exact tie: the first index wins) and more
    clusters than distinct points (an empty cluster keeps its center)."""
    x = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [1.0, 1.0]],
                 np.float32)
    ref_labels, ref_centers = jkmeans.kmeans(jnp.asarray(x), 3)
    labels, centers = kmeans(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_allclose(centers.numpy(), np.asarray(ref_centers))


def test_chain_map_labeling_matches_rpst():
    rng = np.random.default_rng(2)
    d = rng.random((17, 3)).astype(np.float32)
    for lam in (0.0, 0.05, 0.3):
        v = potts_pairwise(3, lam)
        ref = jgraphcut.chain_map_labeling(
            jnp.asarray(d), jgraphcut.potts_pairwise(3, lam))
        np.testing.assert_allclose(v.numpy(), np.asarray(
            jgraphcut.potts_pairwise(3, lam)))
        got = chain_map_labeling(torch.from_numpy(d), v)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lam", [0.0, 0.1])
def test_mst_transfer_matches_rpst(lam):
    rng = np.random.default_rng(3)
    c = rng.normal(size=(6, 5, 8)).astype(np.float32)
    s = rng.normal(size=(6, 5, 8)).astype(np.float32) * 2 + 1
    ref = jmst.mst_transfer(jnp.asarray(c), jnp.asarray(s), 3, lam)
    got = mst_transfer(torch.from_numpy(c), torch.from_numpy(s), 3, lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    batch = mst_transfer_batch(torch.from_numpy(np.stack([c, s])),
                               torch.from_numpy(np.stack([s, c])), 3, lam)
    np.testing.assert_allclose(batch[0].numpy(), got.numpy())


def test_standard_module_matches_flax():
    rng = np.random.default_rng(4)
    c, s = (rng.random((2, 16, 16, 3), dtype=np.float32) for _ in range(2))
    jm = JaxMSTRP(rp_blocks=3, hidden_dim=16, stylized_layers=2)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(c), jnp.asarray(s))
    ref = jm.apply(v, jnp.asarray(c), jnp.asarray(s))
    port = MSTRP(rp_blocks=3, hidden_dim=16, stylized_layers=2)
    port.load_state_dict(from_flax_params(_np_tree(v["params"])))
    got = port(torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_deepest_scale_labels_equal_rpst():
    """The k-means labels of the style channels and each content channel's
    matched cluster at the deepest scale, from the port's folded float32
    encode, equal rpst's; the fixture's smallest relative margin between
    a channel's nearest and second-nearest choice (``label_gap``) is far
    above float32 rounding, so a flip would be a fault."""
    from rpst_torch.models.fast_path import _encode_folded
    from rpst_torch.ops.folded import unfold
    fx = load_fixture("mst")
    assert float(fx["label_gap"]) > 1e-5
    bundle, _ = fixture_bundle("mst", fx)
    c, s = images(fx)
    with torch.no_grad():
        cf, sf = _encode_folded(bundle.folded_weights(torch.float32), c, s,
                                torch.float32)
    for i in range(c.shape[0]):
        cfi, sfi = unfold(cf[-1])[i], unfold(sf[-1])[i]
        ch = sfi.shape[-1]
        s_labels, centers = kmeans(sfi.reshape(-1, ch).t(), 3)
        np.testing.assert_array_equal(s_labels.numpy(), fx["s_labels"][i])
        cc = cfi.reshape(-1, ch).t()
        cos = (cc @ centers.t()) / (cc.norm(dim=1, keepdim=True)
                                    @ centers.norm(dim=1, keepdim=True).t())
        np.testing.assert_array_equal(torch.argmin(1 - cos, dim=1).numpy(),
                                      fx["c_labels"][i])


def test_stylize_matches_rpst():
    check_stylize("mst")


def test_loss_gradients_and_trajectory_match_rpst():
    _, bundle = check_loss_grads_trajectory("mst")
    enc = bundle.model.ms.rp_shared_encoder
    assert all(p.grad is None for p in enc.parameters())


def test_q8_matches_rpst():
    check_q8("mst", 2e-2)


def test_drivers_serve_and_train_on_cpu(tmp_path):
    check_drivers(_corpus(tmp_path), "mst")
