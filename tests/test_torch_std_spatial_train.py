"""Row-sharded training of the standard layout
(``rpst_torch.train.step``'s "rows" route:
``models.fast_path_spatial.loss_std_spatial`` inside ``dist.row_shares``)
on gloo ranks on the CPU: rpst's GSPMD step made explicit, for its 16
``spatial_ok`` networks (tests/test_train_matrix.py:46-64) on {spatial: 2},
{data: 2, spatial: 2} and {spatial: 2, model: 2}.

Each network's SGD(1.0) step (the update is the gradient) is held

  * against rpst's one-device and GSPMD {data: 2, spatial: 2} steps
    (``tests/fixtures/torch_port_slice8c_train.npz``, ``python
    tools/make_torch_port_fixture.py --slice8c-train``) at rpst's limits
    (test_train_matrix.py:127-141: loss rtol 1e-5 / atol 1e-6, parameters
    and batch statistics rtol 1e-4 / atol 1e-5), or, for ``FIXTURE_NOISE``,
    within those limits plus twice the larger of the two frameworks' own
    float32 distances per tensor (the port's one device from rpst's,
    rpst's GSPMD step from its one device: ROADMAP.md section C's
    float32-noise rule), where the float64 steps below show the port's
    row shares compute one device's function (the SANets: 1e-3 of the
    largest update);
  * against the port's one-device step: float32 at rpst's limits, or for
    ``F32_NOISE`` within 1e-3 of the largest update (the rule of
    tests/test_torch_tp.py), and in float64 (statistics too) within 1e-6
    of it for ``TRAIN_F64_8C``;
  * with every rank's state bit-equal.

A leaf above ``torch_dist_worker.BIG_LEAF`` elements (the SANets' 512-wide
convs) is compared through its picked elements, sum, norm and seeded
projections (``torch_dist_worker.leaf_errors``).
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_port_slice8c_train.npz"
MESHES = list(W.TRAIN_MESHES_8C)
CASES = [(m, n, o) for m in MESHES for n, o in W.TRAIN_8C]
CASE_IDS = [f"{m}-{W.family_id(n, o)}" for m, n, o in CASES]
LOSS = dict(rtol=1e-5, atol=1e-6)
RPST = dict(atol=1e-5, rtol=1e-4)
# float32 updates that move by more than rpst's limits between two
# summation orders at these widths (their float64 steps, or for the SANets
# their float32 ones, hold them): the rule of tests/test_torch_tp.py
F32_NOISE = ("spade", "src", "sanet", "dynamic_sanet")
# the networks whose float32 step in the port and in rpst sit further apart
# than rpst's limits at these widths (sel_multi_adain's BatchNorms read
# E[x^2] - E[x]^2 in float32, as flax's)
FIXTURE_NOISE = ("sel_multi_adain", "ccam", "wct", "spade", "src", "sanet",
                 "dynamic_sanet", "ld_adain", "ld_adain3", "ld_adain4")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    try:
        return W.run_ranks("std_spatial_train", 4,
                           tmp_path_factory.mktemp("std_spatial_train"),
                           timeout=600)
    except RuntimeError as err:
        return err


def _key(ranks, key):
    """``key``'s value, the same on every rank that holds it."""
    if isinstance(ranks, Exception):
        pytest.fail(str(ranks))
    vals = [r[key] for r in ranks if key in r]
    assert vals, key
    for v in vals[1:]:
        assert torch.equal(v, vals[0]), f"{key}: the ranks differ"
    return vals[0]


def _leaves(src, prefix):
    """{leaf: {part: array}} of the ``prefix`` step in ``src`` (a rank's
    dict of arrays)."""
    out = {}
    for k, v in src.items():
        if k.startswith(prefix + "state/"):
            name, part = k[len(prefix) + 6:].rsplit("/", 1)
            out.setdefault(name, {})[part] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def fixture():
    with np.load(FIXTURE) as npz:
        return {k: npz[k] for k in npz.files}


def _rpst(fid, step, like):
    """rpst's compressed step ``step`` (one, d2s2) of a family, unpacked
    in the layout of the port's ``like``."""
    return W.unpack_leaves(fixture()[f"{fid}/{step}/state"], like)


def _step(ranks, prefix):
    """(loss, leaves) of a step the ranks ran, checking that every rank
    that ran it holds the same state (its digest) and loss."""
    if isinstance(ranks, Exception):
        pytest.fail(str(ranks))
    held = [r for r in ranks if prefix + "loss" in r]
    assert held, prefix
    for key in ("loss", "digest"):
        _key(held, prefix + key)
    return float(held[0][prefix + "loss"]), _leaves(
        {k: v.numpy() for k, v in held[0].items()}, prefix)


def _largest_update(leaves):
    return max(float(v["upd_max"]) for v in leaves.values())


def _check(got, ref, atol, rtol, noise=()):
    assert set(got) == set(ref)
    bad = {}
    for n in ref:
        errs = W.leaf_errors(got[n], ref[n], atol, rtol,
                             [(a[n], b[n]) for a, b in noise])
        if errs:
            bad[n] = errs
    assert not bad, bad


@pytest.mark.parametrize("mesh,net,over", CASES, ids=CASE_IDS)
def test_matches_one_device(ranks, mesh, net, over):
    """float32, every rank bit-equal: the loss at rtol 1e-5, the updated
    parameters and batch statistics at rpst's limits (``F32_NOISE``:
    within 1e-3 of the largest update)."""
    fid = W.family_id(net, over)
    loss, got = _step(ranks, f"{mesh}/{fid}/")
    ref_loss, ref = _step(ranks, f"one/{fid}/")
    np.testing.assert_allclose(loss, ref_loss, **LOSS)
    if net in F32_NOISE:
        _check(got, ref, 1e-3 * _largest_update(ref), 0.0)
    else:
        _check(got, ref, **RPST)


@pytest.mark.parametrize("net,over", W.TRAIN_F64_8C,
                         ids=[W.family_id(n, o) for n, o in W.TRAIN_F64_8C])
def test_float64_matches_one_device(ranks, net, over):
    """float64 with float64 statistics on {spatial: 2}: the loss at rtol
    1e-6 (seg_adain's class weights and their sum over the pixels stay
    float32, 2e-8 apart in two orders; wct's eigh runs in float32, as
    rpst's: 2e-7) and every
    parameter and batch statistic within 1e-6 of the largest update of one
    device's step (float32 summation order is what parts them in
    float32)."""
    fid = W.family_id(net, over)
    loss, got = _step(ranks, f"s2/{fid}/f64/")
    ref_loss, ref = _step(ranks, f"one/{fid}/f64/")
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    _check(got, ref, 1e-6 * _largest_update(ref), 0.0)


@pytest.mark.parametrize("net,over", W.TRAIN_OPTS_8C,
                         ids=[W.family_id(n, o) for n, o in W.TRAIN_OPTS_8C])
def test_remat_and_grad_accum_match_one_device(ranks, net, over):
    """remat (the recompute under the same row shares) and grad_accum 2
    (rpst's global microbatches re-dealt over data, the rows and
    seg_adain's labels kept) on {data: 2, spatial: 2}, in float64 with
    float64 statistics: the loss at rtol 1e-6 and every parameter and
    batch statistic within 1e-6 of the largest update of one device's
    step with the same option, every rank bit-equal."""
    fid = W.family_id(net, over)
    loss, got = _step(ranks, f"d2s2/{fid}/f64/")
    ref_loss, ref = _step(ranks, f"one/{fid}/f64/")
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    _check(got, ref, 1e-6 * _largest_update(ref), 0.0)


@pytest.mark.parametrize("mesh,net,over", CASES, ids=CASE_IDS)
def test_matches_rpst(ranks, mesh, net, over):
    """Against rpst's one-device and GSPMD {data: 2, spatial: 2} steps:
    the loss at rtol 1e-5 / atol 1e-6, every updated parameter and batch
    statistic at rpst's limits (``FIXTURE_NOISE``: each plus twice the
    larger of the two frameworks' own float32 distances; the SANets, whose
    float32 transforms leave no float64 oracle, within 1e-3 of the largest
    update, as tests/test_torch_tp.py holds them: dynamic_sanet's
    thresholds, a sigmoid at scale 50, amplify the rounding)."""
    fid = W.family_id(net, over)
    fx = fixture()
    loss, got = _step(ranks, f"{mesh}/{fid}/")
    port_loss, port_one = _step(ranks, f"one/{fid}/")
    rpst_loss = {k: float(fx[f"{fid}/{k}/loss"]) for k in ("one", "d2s2")}
    rpst = {k: _rpst(fid, k, port_one) for k in ("one", "d2s2")}
    noise, loss_noise = [], 0.0
    if net in FIXTURE_NOISE:
        noise = [(port_one, rpst["one"]), (rpst["d2s2"], rpst["one"])]
        loss_noise = 2 * max(abs(port_loss - rpst_loss["one"]),
                             abs(rpst_loss["d2s2"] - rpst_loss["one"]))
    for step in ("one", "d2s2"):
        ref, ref_leaves = rpst_loss[step], rpst[step]
        assert abs(loss - ref) <= (LOSS["atol"] + LOSS["rtol"] * abs(ref)
                                   + loss_noise), (loss, ref)
        if net in W.F32_ONLY:
            _check(got, ref_leaves, 1e-3 * _largest_update(ref_leaves), 0.0)
        else:
            _check(got, ref_leaves, **RPST, noise=noise)


def test_noise_list_is_the_float32_noise(ranks):
    """``FIXTURE_NOISE`` is exactly the networks whose port one-device step
    misses rpst's at rpst's bare limits (the fixture's point is the
    port's, so the others meet it), and every one of them but the SANets
    (float32 transforms) has a float64 step above."""
    missing = []
    for net, over in W.TRAIN_8C:
        fid = W.family_id(net, over)
        _, port_one = _step(ranks, f"one/{fid}/")
        try:
            _check(port_one, _rpst(fid, "one", port_one), **RPST)
        except AssertionError:
            missing.append(net)
    assert sorted(missing) == sorted(FIXTURE_NOISE)
    f64 = {n for n, _ in W.TRAIN_F64_8C}
    assert set(FIXTURE_NOISE) - f64 <= set(W.F32_ONLY)


def test_mst_refuses_a_spatial_axis(ranks):
    """mst raises ValueError on a spatial axis (rpst's documented
    exception, test_train_matrix.py:154-168), on the ranks and here."""
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.train.step import train_route
    msg = bytes(_key(ranks, "mst_refusal").tolist()).decode()
    assert "data-only mesh" in msg
    mst = build_model(load_config(dict(W.TINY, network="mst")))
    for shape in ({"spatial": 2}, {"data": 2, "spatial": 2},
                  {"spatial": 2, "model": 2}):
        with pytest.raises(ValueError, match="data-only mesh"):
            train_route(mst, shape)
    assert train_route(mst, {"data": 2}) == "data"


def test_routes():
    """``train_route``: the 16 networks take the rows route on every mesh
    with a spatial axis, a model axis beside it included; the folded three
    keep the folded route on {spatial: 2} where it fits and take the rows
    route where it turns them away (SE attention, a height the folded
    route cannot split, a model axis); img_size % spatial != 0 raises."""
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.train.step import train_route
    meshes = ({"spatial": 2}, {"data": 2, "spatial": 2},
              {"spatial": 2, "model": 2},
              {"data": 2, "spatial": 2, "model": 2})
    for net, over in W.TRAIN_8C:
        bundle = build_model(load_config(dict(W.TINY, network=net, **over)))
        for shape in meshes:
            assert train_route(bundle, shape) == "rows", (net, shape)
        with pytest.raises(ValueError, match="multiple of the spatial"):
            train_route(bundle, {"spatial": 3})
    folded = dict(W.FLAGSHIP, img_size=32, exec_strategy="folded")
    for net in ("multi_adain", "sel_multi_adain", "ccam"):
        bundle = build_model(load_config(dict(folded, network=net)))
        assert train_route(bundle, {"spatial": 2}) == "spatial"
        assert train_route(bundle, {"spatial": 2, "model": 2}) == "rows"
        assert train_route(bundle, {"model": 2}) == "model"
        assert train_route(bundle, {"spatial": 4}) == "rows"  # 32 % 64
    se = build_model(load_config(dict(folded, attention="se")))
    assert train_route(se, {"spatial": 2}) == "rows"


def test_fixture_point():
    """The fixture's losses are the port's one-device losses at rpst's
    loss limit, and it holds every network's two steps."""
    fx = fixture()
    for net, over in W.TRAIN_8C:
        fid = W.family_id(net, over)
        for step in ("one", "d2s2"):
            assert f"{fid}/{step}/loss" in fx, (fid, step)
        np.testing.assert_allclose(float(fx[f"{fid}/d2s2/loss"]),
                                   float(fx[f"{fid}/one/loss"]), **LOSS)


def _driver():
    import importlib.util
    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_driver_spatial_step_and_resume(tmp_path):
    """``train_torch.py`` on {spatial: 2} trains a standard-layout config
    (two ranks, each cutting its rows from its batch share), logs the
    rows route, writes a one-device checkpoint that loads into a
    one-device bundle, and resumes from it for another step."""
    from PIL import Image
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    rng = np.random.default_rng(0)
    for sub in ("c", "s"):
        (tmp_path / sub).mkdir()
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8),
                            "RGB").save(tmp_path / sub / f"{i}.png")
    cfg = dict(W.TINY, network="sel_multi_adain",
               content_dir=str(tmp_path / "c"), style_dir=str(tmp_path / "s"),
               test_dir="", output=str(tmp_path / "out"), batch_size=2,
               max_iter=2, log_iter=1, snapshot_save_iter=1, num_workers=0,
               mesh_shape={"spatial": 2})
    (tmp_path / "cfg.yaml").write_text(json.dumps(cfg))
    drv = _driver()
    base = ["--config", str(tmp_path / "cfg.yaml"), "--device", "cpu"]
    drv.main(base)
    drv.main([*base, "--set", "resume=true"])
    ckpts = sorted(p.name for p in (tmp_path / "out" / "checkpoints")
                   .iterdir())
    assert ckpts == ["1", "2"], ckpts
    lines = [json.loads(ln) for ln in (tmp_path / "out" / "logs"
                                       / "metrics.jsonl").read_text()
             .splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln["total_loss"]) and ln["skipped"] == 0.0
               for ln in lines)
    saved = torch.load(tmp_path / "out" / "checkpoints" / "2" / "state.pt",
                       weights_only=True)
    assert saved["step"] == 2
    bundle = build_model(load_config(dict(cfg, mesh_shape=None)))
    bundle.load_state_dict(saved["params"])  # the one-device layout
