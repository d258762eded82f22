"""Data-parallel training of every network on gloo ranks on the CPU
(rpst_torch.dist, rpst_torch.train.step's routes), the sharded sampler and
``train_torch.py``'s multi-process runs.

  * rpst tests/test_train_matrix.py :145: one SGD(1.0) step of every
    ``FAMILIES`` entry on {data: 2} equals the one-device step, loss and
    every updated parameter within rpst's rtol 1e-4, atol 1e-5, and the
    BatchNorm running statistics with them (the port's one-device step is
    held against rpst's by the families' own test files); mst, which rpst
    lets match or raise (:161), matches; the folded flagship on {data: 2}
    takes the row-sharded route (one row share), as rpst's shard_map;
  * ``grad_accum`` and ``remat`` on both routes (rpst ``dist/mesh.py:237``);
  * rpst tests/test_dist.py :43 / :104 through the same suites, and
    tests/test_multihost.py :49: two processes of ``train_torch.py`` joined
    by the ``distributed`` keys, rank 0 the only writer, its checkpoint
    restored by one process.

One module-scoped run of 2 ranks (tests/torch_dist_worker.py, suite
``dp``) computes every case; each case is a test of its own.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from rpst.data.sampler import InfiniteSampler as RpstSampler
from rpst_torch.data import InfiniteSampler
from rpst_torch.dist import choose_backend
from rpst_torch.train.step import train_step
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
IDS = [W.family_id(n, o) for n, o in W.FAMILIES]
ROUTES = [(n, o, r, a) for n, o in (("sel_multi_adain", {}),
                                    ("multi_adain",
                                     {"exec_strategy": "folded"}))
          for r, a in ((True, 1), (False, 2))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    try:
        return W.run_ranks("dp", 2, tmp_path_factory.mktemp("dp"),
                           timeout=600)
    except RuntimeError as err:
        return err


def _rank0(ranks):
    if isinstance(ranks, Exception):
        pytest.fail(str(ranks))
    return ranks[0]


@functools.lru_cache(maxsize=None)
def one_device(net, over_items, remat=False, accum=1, f64=False):
    """The one-device SGD(1.0) step of the same case: (loss, params,
    buffers)."""
    bundle, vgg, c, s, label = W.dp_case(net, dict(over_items), None, remat,
                                         accum, f64)
    parts = train_step(W.sgd_state(bundle), vgg, c, s, content_label=label)
    return (float(parts["total_loss"]),
            {n: p.detach().clone() for n, p in
             bundle.model.named_parameters()},
            {n: b.clone() for n, b in bundle.model.named_buffers()})


def _check(res, key, ref, rtol=1e-4, atol=1e-5):
    """rpst's limits (tests/test_train_matrix.py): loss rtol 1e-5, every
    parameter and buffer rtol 1e-4, atol 1e-5."""
    loss, params, buffers = ref
    np.testing.assert_allclose(float(res[f"{key}/total_loss"]), loss,
                               rtol=rtol / 10, atol=atol / 10)
    for n, p in params.items():
        torch.testing.assert_close(res[f"{key}/params/{n}"], p, rtol=rtol,
                                   atol=atol, msg=n)
    for n, b in buffers.items():
        if f"{key}/buffers/{n}" in res:
            torch.testing.assert_close(res[f"{key}/buffers/{n}"], b,
                                       rtol=rtol, atol=atol, msg=n)


@pytest.mark.parametrize("net,over", W.FAMILIES, ids=IDS)
def test_dp_train_step_matches_single_device(ranks, net, over):
    _check(_rank0(ranks), W.family_id(net, over),
           one_device(net, tuple(over.items())))


@pytest.mark.parametrize("net,over", W.F64_FAMILIES,
                         ids=[W.family_id(n, o) for n, o in W.F64_FAMILIES])
def test_dp_train_step_float64_matches_single_device(ranks, net, over):
    """The global-batch reductions (BatchNorm statistics, the cross
    entropy's sums) in float64: the data-parallel step meets the one-device
    step to 1e-6 of each value, 1000x under the float32 spread of these
    gradients (only the order of sums differs; the AdaIN / style statistics
    stay float32 for float64 features, as rpst's ``calc_mean_std``, which
    leaves ~3e-8 of float32 rounding in the losses). Taking each rank's
    BatchNorm statistics alone moves sel_multi_adain's and spade's
    gradients by far more."""
    _check(_rank0(ranks), f"{W.family_id(net, over)}/f64",
           one_device(net, tuple(over.items()), f64=True), rtol=1e-6,
           atol=1e-9)


def test_ranks_stay_replicated(ranks):
    """Both ranks hold the same parameters after every case's step."""
    if isinstance(ranks, Exception):
        pytest.fail(str(ranks))
    r0, r1 = ranks
    assert set(r0) == set(r1)
    for k in r0:
        if "/params/" in k or "/buffers/" in k:
            torch.testing.assert_close(r0[k], r1[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("net,over,remat,accum", ROUTES,
                         ids=[f"{W.family_id(n, o)}-remat={r}-accum={a}"
                              for n, o, r, a in ROUTES])
def test_grad_accum_and_remat_on_a_mesh(ranks, net, over, remat, accum):
    """grad_accum splits each rank's share into microbatches and remat
    recomputes with the same global batch reductions; with BatchNorms
    (sel_multi_adain) a microbatch's statistics are those of the ranks'
    microbatches together, which at accum 2 are the one-device run's
    microbatches of the same images only up to their order: held on the
    loss and the parameters without BatchNorm (the flagship) or at accum 1
    (remat)."""
    res = _rank0(ranks)
    key = f"{W.family_id(net, over)}/remat={remat}/accum={accum}"
    ref = one_device(net, tuple(over.items()), remat, accum)
    if net == "sel_multi_adain" and accum > 1:
        # rank d's microbatch i holds images d*2 + i; one device's i
        # holds 2 i, 2 i + 1: the same images in other groups
        assert np.isfinite(float(res[f"{key}/total_loss"]))
        return
    _check(res, key, ref)


def test_sampler_shards_match_rpst():
    """InfiniteSampler's shards (rpst ``sampler.py:8-27``): each the
    positions k mod count of rpst's stream; together the one-process
    stream."""
    for count in (1, 2, 3):
        for k in range(count):
            a = InfiniteSampler(7, seed=3, shard_index=k, shard_count=count)
            b = RpstSampler(7, seed=3, shard_index=k, shard_count=count)
            assert [next(a) for _ in range(40)] == [next(b) for _ in
                                                    range(40)]
    whole = InfiniteSampler(7, seed=3)
    shards = [InfiniteSampler(7, seed=3, shard_index=k, shard_count=2)
              for k in range(2)]
    merged = [next(shards[i % 2]) for i in range(40)]
    assert merged == [next(whole) for _ in range(40)]
    with pytest.raises(ValueError, match="shard_index"):
        next(InfiniteSampler(7, shard_index=2, shard_count=2))


def test_backend_follows_the_rank_layout():
    """gloo on the CPU and where ranks outnumber a host's GPUs, NCCL where
    each rank has one."""
    assert choose_backend("cpu", 2) == "gloo"
    n = torch.cuda.device_count()
    assert choose_backend("cuda", n + 1) == "gloo"
    if n:
        assert choose_backend("cuda", n) == "nccl"


def _data(root: Path, n: int = 4, size: int = 16):
    from PIL import Image
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (size, size, 3),
                                         dtype=np.uint8), "RGB").save(
                root / sub / f"{i:02d}.png")


def test_two_process_training(tmp_path):
    """rpst tests/test_multihost.py:49: two processes of train_torch.py
    join through the ``distributed`` keys (a file under the test's
    directory as the coordinator), each drawing its share of the batch;
    rank 0 alone logs the losses and writes the metrics and one checkpoint
    tree, which one process then restores."""
    data, out, cfg = tmp_path / "data", tmp_path / "out", tmp_path / "c.yaml"
    _data(data)
    cfg.write_text(json.dumps(dict(
        network="multi_adain", enc_stack_way="constant", rp_blocks=2,
        hidden_dim=8, inception_num=0, attention="none", img_size=16,
        batch_size=2, max_iter=4, test_iter=100, snapshot_save_iter=3,
        log_iter=1, num_workers=0, lr=1e-4, lr_decay=0.0,
        content_weight=1.0, style_weight=1.0,
        content_dir=str(data / "content"), style_dir=str(data / "style"),
        test_dir="", output=str(out), vgg="", distributed=True,
        coordinator_address=f"file://{tmp_path / 'init'}",
        num_processes=2)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "train_torch.py"), "--config", str(cfg),
         "--device", "cpu", "--set", f"process_id={pid}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(REPO)) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    assert "Iterations 1" in outs[0] and "Iterations 1" not in outs[1]
    assert "data parallel" in outs[0]
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["3"]
    records = [json.loads(ln) for ln in
               (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(v) for r in records for k, v in r.items()
               if k != "step")
    # the checkpoint restores in one process
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.train.checkpoint import restore_checkpoint
    from rpst_torch.train.step import create_train_state
    state = create_train_state(build_model(load_config(str(cfg))))
    restore_checkpoint(out / "checkpoints" / "3", state)
    assert state.step == 3
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def _serve(argv):
    """serve_torch.py's ``main`` in this process (it starts a mesh's ranks
    as processes of its own)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("serve_torch",
                                                  REPO / "serve_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


@pytest.fixture
def serve_dir(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    (tmp_path / "c").mkdir()
    for i in range(3):  # a last batch that does not fill the mesh
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8),
                        "RGB").save(tmp_path / "c" / f"c{i}.png")
    Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8),
                    "RGB").save(tmp_path / "s.png")
    (tmp_path / "cfg.yaml").write_text(json.dumps(dict(
        network="multi_adain", rp_blocks=3, hidden_dim=32, img_size=32,
        attention="none", vgg="")))
    return tmp_path


@pytest.mark.parametrize("mesh,extra", [
    ("2", ["--mode", "standard", "--set", "network=adain"]),
    ("data=2,spatial=2", ["--mode", "q8"]),
    ("spatial=2", ["--mode", "folded", "--set", "network=ccam",
                   "shuffle=false"])],
    ids=["data2-adain", "data2-spatial2-flagship-q8-to-folded",
         "spatial2-ccam"])
def test_serve_mesh_matches_one_device(serve_dir, mesh, extra):
    """rpst serve.py:99-133: ``--mesh N`` data parallel for every network,
    a spatial axis the row-sharded folded stylize (q8 gives way to folded,
    as rpst's warning says): the same PNGs as one process serving the
    resolved mode, byte for byte, rank 0 the only writer."""
    from PIL import Image
    base = ["--config", str(serve_dir / "cfg.yaml"), "--content",
            str(serve_dir / "c"), "--style", str(serve_dir / "s.png"),
            "--device", "cpu", "--batch", "2"]
    one_extra = ["folded" if a == "q8" else a for a in extra]
    _serve([*base, "--out", str(serve_dir / "one"), *one_extra])
    _serve([*base, "--out", str(serve_dir / "mesh"), "--mesh", mesh, *extra])
    names = sorted(p.name for p in (serve_dir / "one").iterdir())
    assert len(names) == 3
    assert sorted(p.name for p in (serve_dir / "mesh").iterdir()) == names
    for n in names:
        a = np.asarray(Image.open(serve_dir / "one" / n))
        b = np.asarray(Image.open(serve_dir / "mesh" / n))
        assert np.array_equal(a, b), n


@pytest.mark.parametrize("mesh,extra,err,match", [
    ("spatial=2", ["--mode", "standard", "--set", "network=sanet"],
     ValueError, "multiple of 64"),
    ("spatial=3", ["--mode", "standard"], ValueError,
     "multiple of the spatial axis 3"),
    ("spatial=2", ["--set", "network=mst"], ValueError, "data-only mesh"),
    ("data=2,model=2", [], ValueError, "axes data and spatial"),
    ("2", ["--daemon", "--batch", "3"], ValueError, "divide by the data")],
    ids=["sanet-spatial", "standard-spatial", "mst-spatial", "model-axis",
         "daemon"])
def test_serve_mesh_refusals(serve_dir, mesh, extra, err, match):
    """What serving over a mesh refuses, before any rank starts: sanet on a
    spatial axis at a height without four pools and two relu5_1 rows a row
    share (rpst's assert, fast_path_spatial.py:538-542; 32px here, 64 needed
    on 2 shares), the standard layout of the other networks at a height the
    spatial axis does not divide (rpst's one rule for its GSPMD route,
    serve.py:189-190: 32px on 3 shares), mst on a spatial axis (rpst
    serve.py:189-192), a model axis (rpst's serve.py:132 assert: serving
    takes data and spatial), and a daemon batch the data axis does not
    divide."""
    with pytest.raises(err, match=match):
        _serve(["--config", str(serve_dir / "cfg.yaml"), "--content",
                str(serve_dir / "c"), "--style", str(serve_dir / "s.png"),
                "--out", str(serve_dir / "o"), "--device", "cpu", "--mesh",
                mesh, *extra])
    assert not (serve_dir / "o").exists()
