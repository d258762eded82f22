"""Row-sharded SANet / AdaptiveSANet serving
(rpst_torch.models.fast_path_spatial.stylize_sanet_spatial) on gloo ranks
on the CPU, against rpst's ``stylize_sanet_spatial`` on a {spatial: 2}
mesh of virtual CPU devices (``tests/fixtures/torch_port_slice8b.npz``,
``python tools/make_torch_port_fixture.py --slice8b``; its flash kernel in
interpret mode) and against the port's one-device stylize; and
``serve_torch.py --mesh spatial=2`` on sanet.

Limits (ROADMAP.md "How parts are held"): float32 1e-4; the ``aea``
module's 1e-3, as tests/test_torch_dynamic_sanet.py holds rpst's aea
stylize (its sigmoid at scale 50 amplifies the thresholds' float32
rounding); bfloat16 MAE 1e-2, or 3x rpst's own bfloat16 distance (its
bfloat16 output against its float32 one).
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from rpst_torch.dist import make_mesh
from rpst_torch.models.fast_path_spatial import stylize_sanet_spatial
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_port_slice8b.npz"
CASES = list(W.SANET_CASES)
TOL = {"sanet_f32": 1e-4, "dynamic_sanet_relu": 1e-4,
       "dynamic_sanet_aea": 1e-3}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    try:
        return W.run_ranks("sanet_spatial", 2,
                           tmp_path_factory.mktemp("sanet_spatial"),
                           timeout=600)
    except RuntimeError as err:
        return err


def _out(ranks, case):
    if isinstance(ranks, Exception):
        pytest.fail(str(ranks))
    r0, r1 = ranks
    assert torch.equal(r0[f"{case}/out"], r1[f"{case}/out"])
    return r0[f"{case}/out"].numpy()


@functools.lru_cache(maxsize=None)
def rpst_out(case):
    with np.load(FIXTURE) as npz:
        return npz[f"{case}/out"]


def _bf16_limit():
    own = np.abs(rpst_out("sanet_bf16") - rpst_out("sanet_f32")).mean()
    return max(1e-2, 3 * own)


@pytest.mark.parametrize("case", CASES)
def test_spatial_stylize_matches_rpst(ranks, case):
    got, ref = _out(ranks, case), rpst_out(case)
    assert got.shape == ref.shape == (1, 64, 64, 3)
    if case == "sanet_bf16":
        assert np.abs(got - ref).mean() <= _bf16_limit()
    else:
        np.testing.assert_allclose(got, ref, rtol=TOL[case], atol=TOL[case])


@pytest.mark.parametrize("case", CASES)
def test_spatial_stylize_matches_one_device(ranks, case):
    """float32 against the one-device stylize (dynamic_sanet on its
    streamed route, the one the shards take); bfloat16 against the same
    bfloat16 function on one rank (the one-device stylize keeps the
    transform in float32, as rpst's) by PERF.md section 2's bfloat16 rule,
    MAE 1e-2 or 3x rpst's own bfloat16 distance (``_bf16_limit``, 0.103
    here): the outputs reach |10|, where a bfloat16 step is 0.0625, and the
    two sides' bfloat16 convs round in the orders the CPU's oneDNN kernels
    pick for a whole image and for a share (MAE 0.0150 with AMX-BF16, 0
    under AVX2)."""
    bundle, c, s = W.sanet_bundle(case, 64)
    with torch.inference_mode():
        if case == "sanet_bf16":
            ref = stylize_sanet_spatial(bundle, c, s, make_mesh(
                {"spatial": 1}, torch.device("cpu"))).numpy()
        else:
            if bundle.network == "dynamic_sanet":
                bundle.model.transform.blockwise = "always"
            ref = bundle.stylize(c, s).numpy()
    got = _out(ranks, case)
    if case == "sanet_bf16":
        assert np.abs(got - ref).mean() <= _bf16_limit()
    else:
        np.testing.assert_allclose(got, ref, rtol=TOL[case], atol=TOL[case])


def _serve(argv):
    import importlib.util
    spec = importlib.util.spec_from_file_location("serve_torch",
                                                  REPO / "serve_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


def test_serve_cli_spatial_sanet(tmp_path):
    """``serve_torch.py --mesh spatial=2 --mode standard`` on sanet: the
    same file names as one process, each PNG within one uint8 step."""
    from PIL import Image
    rng = np.random.default_rng(0)
    (tmp_path / "c").mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8),
                        "RGB").save(tmp_path / "c" / f"c{i}.png")
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8),
                    "RGB").save(tmp_path / "s.png")
    (tmp_path / "cfg.yaml").write_text(json.dumps(dict(
        network="sanet", img_size=64, vgg="")))
    base = ["--config", str(tmp_path / "cfg.yaml"), "--content",
            str(tmp_path / "c"), "--style", str(tmp_path / "s.png"),
            "--device", "cpu", "--batch", "1", "--mode", "standard"]
    _serve([*base, "--out", str(tmp_path / "one")])
    _serve([*base, "--out", str(tmp_path / "mesh"), "--mesh", "spatial=2"])
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert len(names) == 2
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()) == names
    for n in names:
        a = np.asarray(Image.open(tmp_path / "one" / n)).astype(int)
        b = np.asarray(Image.open(tmp_path / "mesh" / n)).astype(int)
        assert np.abs(a - b).max() <= 1, n
