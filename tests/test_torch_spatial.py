"""Row-sharded ("spatial") folded serving and training of multi_adain,
sel_multi_adain and ccam (rpst_torch.models.fast_path_spatial) on gloo
ranks on the CPU, against two references:

  * rpst's row-sharded functions on the 8-virtual-CPU mesh,
    ``tests/fixtures/torch_port_spatial.npz`` (``python
    tools/make_torch_port_fixture.py --spatial``: float32 with
    interpret-mode kernels, float64 with float64 statistics);
  * the port's own one-device folded path on the same weights and images.

The counterparts of rpst's tests/test_spatial_fast_path.py (:35 one halo
conv, :57 {spatial: 4} / {data: 2, spatial: 2}, :86 sel, :114 ccam) and
tests/test_spatial_train.py (:74 gradients on three meshes, :135 the
sharded step, :161 ccam, :208 sel with its running statistics, :252 the
gate). One module-scoped run of 4 ranks (tests/torch_dist_worker.py,
suite ``spatial``) computes every case; each case is a test of its own.

Limits (ROADMAP.md "How parts are held"): stylize 5e-5 (rpst's own
spatial-vs-one-device limit); loss parts rtol 1e-4; float64 gradients
rtol 5e-3 / atol 1e-4 of the tensor's max; float32 gradients within 2x
the larger of the two sides' own float32 errors (each against its float64
run), at least 1e-4 of the max.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from rpst_torch.bridge import from_flax_batch_stats, from_flax_params
from rpst_torch.dist import make_mesh, spatial_folded_train_ok
from rpst_torch.models import build_model
from rpst_torch.config import load_config
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_port_spatial.npz"
CASES = [(n, m) for n in W.SPATIAL for m in ("s2", "d2s2")]
IDS = [f"{n}-{m}" for n, m in CASES]
OUT_TOL = dict(rtol=1e-5, atol=5e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the ``spatial`` suite, or the error."""
    try:
        return W.run_ranks("spatial", 4, tmp_path_factory.mktemp("spatial"),
                           timeout=600)
    except RuntimeError as err:
        return err


def _results(ranks):
    if isinstance(ranks, Exception):
        pytest.fail(str(ranks))
    return ranks


@functools.lru_cache(maxsize=None)
def rpst_fixture():
    with np.load(FIXTURE) as npz:
        return {k: npz[k] for k in npz.files}


def rpst_tree(network, mesh, what):
    """A subtree of the fixture in the port's names."""
    prefix = f"{network}/{mesh}/{what}/"
    fx = rpst_fixture()
    flat = {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    if what == "stats_after":
        return from_flax_batch_stats(tree)
    return from_flax_params(tree)


@functools.lru_cache(maxsize=None)
def one_device(network, f64=False):
    """The port's one-device folded path at the point: stylize (float32),
    loss parts and gradient corners, buffers after the loss."""
    dt = torch.float64 if f64 else torch.float32
    bundle, vgg, c, s = W.fixture_bundle(network, dt)
    out = None if f64 else bundle.stylize(c, s)
    total, parts = bundle.loss(vgg, c, s)
    total.backward()
    grads = {n: W.grad_corner(p.grad)
             for n, p in bundle.model.named_parameters()}
    buffers = {n: b.clone() for n, b in bundle.model.named_buffers()}
    return out, {k: float(v.detach()) for k, v in parts.items()}, grads, \
        buffers


def assemble(res, key, shape):
    """The full (N, H, W, 3) output from the ranks' shares."""
    sizes = tuple(shape.values())
    rows = {}
    for r in range(int(np.prod(sizes))):
        coords = dict(zip(shape, np.unravel_index(r, sizes)))
        rows[(coords.get("data", 0), coords.get("spatial", 0))] = \
            res[r][key].numpy()
    d, s = shape.get("data", 1), shape.get("spatial", 1)
    return np.concatenate([np.concatenate([rows[(i, j)] for j in range(s)],
                                          axis=1) for i in range(d)], axis=0)


@pytest.mark.parametrize("network,mesh", CASES + [("multi_adain", "s4")],
                         ids=IDS + ["multi_adain-s4"])
def test_stylize_matches_rpst_and_one_device(ranks, network, mesh):
    res = _results(ranks)
    got = assemble(res, f"{network}/{mesh}/out", W.MESHES[mesh])
    ref, _, _, _ = one_device(network)
    assert got.shape == tuple(ref.shape)
    np.testing.assert_allclose(got, ref.numpy(), **OUT_TOL)
    if mesh != "s4":  # the fixture holds rpst's s2 and d2s2
        np.testing.assert_allclose(got, rpst_fixture()[
            f"{network}/{mesh}/out"], **OUT_TOL)


def _check_grads(got, got64, ref, ref64, own_ref):
    """got / got64: the port's float32 / float64 corners; ref / ref64 the
    reference's; own_ref: the reference's own float32 error per tensor
    (None: take |ref - ref64|)."""
    assert set(got) == set(ref), set(got) ^ set(ref)
    for name in got:
        r = ref[name].double()
        size = max(float(r.abs().max()), 1e-30)
        torch.testing.assert_close(got64[name].double(),
                                   ref64[name].double(), rtol=5e-3,
                                   atol=1e-4 * size, msg=f"{name} float64")
        own = max(float((got[name].double() - got64[name]).abs().max()),
                  float((r - ref64[name].double()).abs().max())
                  if own_ref is None else own_ref[name]) / size
        torch.testing.assert_close(got[name].double(), r, rtol=5e-3,
                                   atol=max(1e-4, 2 * own) * size,
                                   msg=name)


@pytest.mark.parametrize("network,mesh", CASES, ids=IDS)
def test_loss_and_grads_match_rpst(ranks, network, mesh):
    """rpst's loss_and_grads_*_folded_spatial on the same mesh."""
    res = _results(ranks)[0]
    key = f"{network}/{mesh}"
    fx = rpst_fixture()
    for k in ("content_loss", "style_loss", "total_loss"):
        np.testing.assert_allclose(float(res[f"{key}/{k}"]), fx[f"{key}/{k}"],
                                   rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(res[f"{key}/{k}_f64"]),
                                   fx[f"{key}/{k}_f64"], rtol=1e-6,
                                   err_msg=f"{k} float64")
    pick = lambda what: {k[len(f"{key}/{what}/"):]: v  # noqa: E731
                         for k, v in res.items()
                         if k.startswith(f"{key}/{what}/")}
    _check_grads(pick("grads"), pick("grads_f64"),
                 rpst_tree(network, mesh, "grads"),
                 rpst_tree(network, mesh, "grads_f64"), None)


@pytest.mark.parametrize("network,mesh", CASES + [("multi_adain", "s4")],
                         ids=IDS + ["multi_adain-s4"])
def test_loss_and_grads_match_one_device(ranks, network, mesh):
    """The port's own one-device folded loss (folded VGG, reflect rings)
    on the same point: the sharding changes only the order of sums."""
    res = _results(ranks)[0]
    key = f"{network}/{mesh}"
    _, parts, grads, _ = one_device(network)
    for k in ("content_loss", "style_loss", "total_loss"):
        np.testing.assert_allclose(float(res[f"{key}/{k}"]), parts[k],
                                   rtol=1e-4, err_msg=k)
    got = {k[len(f"{key}/grads/"):]: v for k, v in res.items()
           if k.startswith(f"{key}/grads/")}
    _, _, grads64, _ = one_device(network, True)
    if mesh == "s4":  # no float64 run: hold to the one-device float32 noise
        own = {n: float((grads[n].double() - grads64[n]).abs().max())
               for n in grads}
        got64 = grads64
    else:
        got64 = {k[len(f"{key}/grads_f64/"):]: v for k, v in res.items()
                 if k.startswith(f"{key}/grads_f64/")}
        own = None
    _check_grads(got, got64, grads, grads64, own)


@pytest.mark.parametrize("mesh", ["s2", "d2s2"])
def test_sel_running_statistics_match(ranks, mesh):
    """sel_multi_adain's train-mode BatchNorms take the statistics of the
    whole batch over every rank and move the running ones by them: rpst's
    returned ``muts`` and the port's one-device step."""
    res = _results(ranks)
    key = f"sel_multi_adain/{mesh}/buffers/"
    ref = rpst_tree("sel_multi_adain", mesh, "stats_after")
    _, _, _, own = one_device("sel_multi_adain")
    n_ranks = int(np.prod(list(W.MESHES[mesh].values())))
    for name, r in ref.items():
        for rank in range(n_ranks):  # replicated on every rank
            got = res[rank][key + name]
            torch.testing.assert_close(got, torch.as_tensor(r),
                                       rtol=1e-4, atol=1e-5, msg=name)
            torch.testing.assert_close(got, own[name], rtol=1e-4,
                                       atol=1e-5, msg=name)


def test_train_step_on_a_mesh_matches_one_device(ranks):
    """Two Adam steps of ``train_step`` with a {data: 2, spatial: 2} mesh
    (the row-sharded route) against the one-device step (rpst
    test_sharded_train_step_uses_spatial_pallas :135)."""
    from rpst_torch.train.step import create_train_state, train_step
    res = _results(ranks)[0]
    bundle, vgg, c, s = W.fixture_bundle("multi_adain")
    state = create_train_state(bundle)
    ref = [float(train_step(state, vgg, c, s)["total_loss"])
           for _ in range(2)]
    got = res["train_step/losses"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-3)


def test_spatial_folded_train_ok_gates():
    """rpst's gate (test_spatial_train.py:252): the folded flagship, ccam
    and sel_multi_adain on a {data, spatial} mesh; not mst, not with
    folded_train_pallas off, not a model axis, not an image whose row
    shares lack three pools and two relu4_1 rows."""
    base = dict(network="multi_adain", enc_stack_way="constant",
                rp_blocks=3, hidden_dim=32, img_size=32,
                exec_strategy="folded")
    ok = {"data": 2, "spatial": 2}

    def gate(mesh=ok, **over):
        return spatial_folded_train_ok(
            build_model(load_config(dict(base, **over))), mesh)

    assert gate()
    assert not gate({"data": 2, "model": 2})
    assert not gate(network="mst")
    assert gate(network="sel_multi_adain") and gate(network="ccam")
    assert not gate(folded_train_pallas=False)
    assert not gate(img_size=16)
    assert not gate(exec_strategy="standard")


def test_mesh_layout_and_refusals():
    """Rank layout row-major over the axes as rpst reshapes its devices;
    a model axis beside a spatial one is a mesh (the rows route trains it:
    tests/test_torch_std_spatial_train.py), unknown axes refuse; a
    one-rank mesh needs no group."""
    from rpst_torch.dist import check_mesh_shape
    mesh = make_mesh({"data": 1, "spatial": 1}, torch.device("cpu"))
    assert mesh.size == 1 and mesh.reduce_axes() == ()
    assert mesh.axis("spatial").index == 0
    assert check_mesh_shape({"data": 2, "model": 2}) == {"data": 2,
                                                         "model": 2}
    assert check_mesh_shape({"spatial": 2, "model": 2}) == {"spatial": 2,
                                                            "model": 2}
    with pytest.raises(ValueError, match="within"):
        check_mesh_shape({"rows": 2})
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh({"data": 2, "spatial": 2}, torch.device("cpu"))
