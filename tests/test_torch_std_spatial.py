"""Row-sharded serving of the standard layout
(``rpst_torch.models.fast_path_spatial.stylize_std_spatial``, through
``serving.make_mesh_run_impl``) on gloo ranks on the CPU: rpst's GSPMD
route made explicit. Held against rpst's single-device and GSPMD serving at
rpst's test size (``tests/fixtures/torch_port_slice8c.npz``, ``python
tools/make_torch_port_fixture.py --slice8c``; rpst's
tests/test_spatial_gspmd.py), against the port's one-device stylize, and
each row-share primitive against its one-device op; ``mesh_mode``'s rules;
``serve_torch.py --mesh`` and the daemon over ranks on these networks.

Limits (ROADMAP.md "How parts are held"): uint8 within one step of rpst's
outputs (rpst's own GSPMD test); float32 1e-4 against the port's one
device and rpst's one-device float32 stylize; bfloat16 MAE 1e-2 (PERF.md
section 2) against the port's one-device bfloat16 stylize; the primitives'
sums 1e-5 (float32 summed in another order), their data movement exact.
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
FIXTURE = REPO / "tests" / "fixtures" / "torch_port_slice8c.npz"
# rpst's GSPMD cases of the fixture: (case, mesh)
GSPMD = ([(c, "s2") for c in list(W.CASES_8C)[:11]]
         + [("adain", "d2s2"), ("ld_adain3_l5", "s4"),
            ("ld_adain5_l5", "s4")])
F32_TOL = 1e-4
BF16_MAE = 1e-2
SUM_TOL = 1e-5  # the primitives' statistics: float32 sums in another order
PRIMS = ([f"pad2d/{m}/{p}" for m in ("reflect", "replicate", "zero")
          for p in (1, 2)]
         + [f"padconv/{m}/{k}" for m in ("reflect", "replicate", "zero")
            for k in (3, 7)]
         + ["short/padconv/reflect/7", "short/padconv/zero/7",
            "conv2d_rows", "instance_norm", "maxpool_ceil", "maxpool_twice",
            "resize_up", "resize_pad", "spatial_mean", "calc_mean_std"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    try:
        return W.run_ranks("std_spatial", 4,
                           tmp_path_factory.mktemp("std_spatial"),
                           timeout=600)
    except RuntimeError as err:
        return err


def _out(ranks, key):
    """The gathered batch of ``key``, equal on every rank that ran it."""
    if isinstance(ranks, Exception):
        pytest.fail(str(ranks))
    outs = [r[key] for r in ranks if key in r]
    assert outs, key
    for o in outs[1:]:
        assert torch.equal(o, outs[0]), f"{key}: the ranks differ"
    return outs[0]


@functools.lru_cache(maxsize=None)
def fixture():
    with np.load(FIXTURE) as npz:
        return {k: npz[k] for k in npz.files}


def _u8(y):
    """rpst serve's uint8 cut: clip, * 255 + 0.5, floored."""
    y = np.clip(np.asarray(y, np.float32), 0.0, 1.0) * 255.0 + 0.5
    return y.astype(np.uint8).astype(int)


@functools.lru_cache(maxsize=None)
def one_device(case, dtype="float32", size=None):
    """The port's one-device stylize of a case (what the shards hold)."""
    bundle, c, s = W.case_8c(case, dtype, size=size)
    with torch.inference_mode():
        return bundle.stylize(c, s, folded=False)


def test_fixture_point():
    """The fixture's images are the worker's, and its uint8 outputs those
    of its float32 ones."""
    fx = fixture()
    c, s = W.images_8c()
    assert np.array_equal(fx["content"], c)
    assert np.array_equal(fx["style"], s)
    for case in W.CASES_8C:
        assert np.abs(_u8(fx[f"{case}/one_f32"])
                      - fx[f"{case}/one"].astype(int)).max() <= 1, case


@pytest.mark.parametrize("case,mesh", GSPMD,
                         ids=[f"{c}-{m}" for c, m in GSPMD])
def test_matches_rpst_gspmd(ranks, case, mesh):
    """rpst's test_gspmd_spatial_matches_single_device (and its
    data-axis combo, and {spatial: 4} where LD's coarse streams run whole):
    the port's row-sharded uint8 output within one step of rpst's GSPMD
    output and of its single-device one."""
    got = _u8(_out(ranks, f"{case}/{mesh}/float32").numpy())
    fx = fixture()
    for ref in (fx[f"{case}/{mesh}"], fx[f"{case}/one"]):
        assert got.shape == ref.shape == (2, 32, 32, 3)
        assert np.abs(got - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("case", list(W.CASES_8C))
def test_float32_matches_rpst_one_device(ranks, case):
    """The float32 output before the uint8 cut (src's and LD v3's clip to
    0 everywhere at these weights, so the uint8 check alone would be
    blind) within 1e-4 of rpst's one-device float32 stylize."""
    mesh = "s4" if case.endswith("_l5") else "s2"
    got = _out(ranks, f"{case}/{mesh}/float32").numpy()
    np.testing.assert_allclose(got, fixture()[f"{case}/one_f32"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case,mesh,dtype", W.RUNS_8C,
                         ids=[f"{c}-{m}-{d}" for c, m, d in W.RUNS_8C])
def test_matches_one_device(ranks, case, mesh, dtype):
    """Every run against the port's one-device stylize of the same
    bundle: float32 1e-4, bfloat16 MAE 1e-2."""
    got = _out(ranks, f"{case}/{mesh}/{dtype}")
    ref = one_device(case, dtype)
    assert got.shape == ref.shape
    if dtype == "bfloat16":
        assert float((got - ref).abs().mean()) <= BF16_MAE
    else:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("case,size,mesh", W.SWEEP_8C,
                         ids=[f"{c}-{n}px-{m}" for c, n, m in W.SWEEP_8C])
def test_heights_match_one_device(ranks, case, size, mesh):
    """rpst serves every img_size % spatial == 0: at 6px on two ranks
    (3-row shares: the pools and pads gather, a 7x7 halo outgrows them),
    12px on four and 36px on two, each network's stylize equals one
    device's to float32 1e-4."""
    got = _out(ranks, f"sweep/{case}/{size}/{mesh}")
    ref = one_device(case, "float32", size)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("mesh", ["s2", "s4"])
@pytest.mark.parametrize("prim", PRIMS)
def test_row_share_primitive(ranks, prim, mesh):
    """Each primitive on row shares against its one-device op: the pads,
    halo convs (3x3 and 7x7, each edge mode; 2-row shares a 7x7 halo
    outgrows), pools (an odd share pooled whole), LD's resize from a
    share and from a gathered, padded source; statistics to float32
    summation order."""
    key = f"prim/{mesh}/{prim}"
    got, ref = _out(ranks, f"{key}/got"), _out(ranks, f"{key}/ref")
    assert got.shape == ref.shape
    stat = prim in ("instance_norm", "spatial_mean", "calc_mean_std")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=SUM_TOL if stat else 0)


@pytest.mark.parametrize("mesh", ["s2", "s4"])
@pytest.mark.parametrize("prim", W.GRAD_PRIMS)
def test_row_share_primitive_gradient(ranks, prim, mesh):
    """The primitives stay differentiable on row shares (the training
    half's need): the halo's, the gather's and the sums' backwards give
    the shares one device's input gradient, each rank seeding its copy of
    the loss over the axis size."""
    key = f"prim/{mesh}/grad/{prim}"
    got, ref = _out(ranks, f"{key}/got"), _out(ranks, f"{key}/ref")
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=SUM_TOL,
                               atol=SUM_TOL)


def test_mesh_mode_rules():
    """``mesh_mode`` on a spatial axis: every network but mst serves the
    standard layout (no NotImplementedError), mst raises ValueError (rpst
    serve.py:189-192), and the one height rule is img_size % spatial
    (rpst :189-190)."""
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.models.fast_path_spatial import STD_SPATIAL_FAMILIES
    from rpst_torch.serving import mesh_mode
    for net in STD_SPATIAL_FAMILIES:
        bundle = build_model(load_config(dict(W.TINY_8C, network=net)))
        for shape in ({"spatial": 2}, {"data": 2, "spatial": 2},
                      {"spatial": 4}):
            assert mesh_mode(bundle, "standard", shape) == "standard"
        with pytest.raises(ValueError, match="multiple of the spatial"):
            mesh_mode(bundle, "standard", {"spatial": 3})
    mst = build_model(load_config(dict(W.TINY_8C, network="mst")))
    with pytest.raises(ValueError, match="data-only mesh"):
        mesh_mode(mst, "standard", {"spatial": 2})


def _write_data(root, network, size=32, n=2):
    from PIL import Image
    rng = np.random.default_rng(0)
    (root / "c").mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8),
                        "RGB").save(root / "c" / f"c{i}.png")
    Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8),
                    "RGB").save(root / "s.png")
    (root / "cfg.yaml").write_text(json.dumps(dict(
        W.TINY_8C, network=network, img_size=size)))
    return root


def _serve(argv):
    import importlib.util
    spec = importlib.util.spec_from_file_location("serve_torch",
                                                  REPO / "serve_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


@pytest.mark.parametrize("network,mesh", [("ld_adain3", "spatial=2"),
                                          ("wct", "data=2,spatial=2")])
def test_serve_cli_spatial_standard(tmp_path, network, mesh):
    """``serve_torch.py --mesh ... --mode standard``: the same file names
    as one process, each PNG within one uint8 step."""
    from PIL import Image
    root = _write_data(tmp_path, network)
    base = ["--config", str(root / "cfg.yaml"), "--content",
            str(root / "c"), "--style", str(root / "s.png"), "--device",
            "cpu", "--batch", "2", "--mode", "standard"]
    _serve([*base, "--out", str(root / "one")])
    _serve([*base, "--out", str(root / "mesh"), "--mesh", mesh])
    names = sorted(p.name for p in (root / "one").iterdir())
    assert len(names) == 2
    assert sorted(p.name for p in (root / "mesh").iterdir()) == names
    for n in names:
        a = np.asarray(Image.open(root / "one" / n)).astype(int)
        b = np.asarray(Image.open(root / "mesh" / n)).astype(int)
        assert np.abs(a - b).max() <= 1, n


def test_daemon_over_row_shares(tmp_path):
    """``serve_torch.py --daemon --mesh spatial=2`` on LD v5 (``--mode
    folded`` serves standard with a warning): four requests through the
    same run function, each PNG within one uint8 step of the
    one-process daemon's, and a shutdown that stops both ranks."""
    from PIL import Image
    from test_torch_mesh_daemon import _daemon
    root = _write_data(tmp_path / "data", "ld_adain5", n=4)
    one, rc, log = _daemon(root, tmp_path / "one")
    assert rc == 0, log
    got, rc, log = _daemon(root, tmp_path / "mesh", "--mesh", "spatial=2")
    assert rc == 0, log
    assert sorted(got) == sorted(one) == [f"r{i}" for i in range(4)]
    for rid in one:
        assert one[rid]["ok"] and got[rid]["ok"], (one[rid], got[rid])
        a = np.asarray(Image.open(one[rid]["out"])).astype(int)
        b = np.asarray(Image.open(got[rid]["out"])).astype(int)
        assert np.abs(a - b).max() <= 1, rid
