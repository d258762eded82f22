"""Channel tensor parallelism on the ``model`` mesh axis
(rpst_torch.dist.tp) on gloo ranks on the CPU, against two references:

  * rpst's own TP step, tests/test_dist.py:138
    ``test_tp_channel_sharding_matches_single_device`` ({data: 2, model:
    4}, hidden 16, min_channels 8), and its one-device step, through
    ``tests/fixtures/torch_port_slice8b.npz`` (``python
    tools/make_torch_port_fixture.py --slice8b``): the port's {data: 2,
    model: 2} Adam step on 4 ranks meets both at rpst's limits (loss rtol
    1e-5, parameters rtol 1e-4 / atol 1e-5); each rank stores its shares
    only (rpst's ``_tp_leaf_spec``, ``bridge.tp_shares``), the Adam moments
    too; the checkpoint is the one-device layout and restores onto shares;
  * the port's one-device step: one SGD(1.0) step of every registry network
    and of the flagship variants' folded forms (tests/torch_dist_worker.py
    TP_FAMILIES) on {model: 2} at min_channels 8, so that the tiny widths
    shard. The update is the gradient, so the
    adjoints of the column path (Megatron's f / g pair) are held, not only
    the loss.

Limits, on the update (SGD(1.0): the gradient): float32 at rpst's limits;
where float32 rounding decides at these widths (``FLOAT32_NOISE``: the
channel sums of the column path reorder the backward's additions) the
float64 step holds the network at 1e-6 of its largest update (the sharded
steps meet one device's to ~1e-7 of it in float64), and the SANets, whose
transforms stay float32 as rpst's, at 1e-3 of it in float32 (one device's
own float32 step moves by 3-6e-4 of it between 1 and 4 CPU threads).
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from rpst_torch.bridge import from_flax_params, tp_shares
from rpst_torch.dist import tp
from rpst_torch.train.checkpoint import latest_step, restore_checkpoint
from rpst_torch.train.step import train_step
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_port_slice8b.npz"
IDS = [W.family_id(n, o) for n, o in W.TP_FAMILIES]
F64 = [(n, o) for n, o in W.TP_FAMILIES if n not in W.F32_ONLY]
# the networks whose float32 updates at these widths differ by more than
# rpst's limits between any two summation orders (mst: 2.3e-4 of the
# largest update from one device's with AMX-BF16's oneDNN kernels, 8e-7
# without them; its float64 step 8e-8)
FLOAT32_NOISE = ("src", "sanet", "dynamic_sanet", "ld_adain2", "ld_adain3",
                 "mst")


def _run(suite, world, tmp_path_factory):
    try:
        return W.run_ranks(suite, world, tmp_path_factory.mktemp(suite),
                           timeout=600)
    except RuntimeError as err:
        return err


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the ``tp`` suite (2 ranks), or the error."""
    return _run("tp", 2, tmp_path_factory)


@pytest.fixture(scope="module")
def fx_ranks(tmp_path_factory):
    """The ``tp_fixture`` suite's results (4 ranks), or the error."""
    return _run("tp_fixture", 4, tmp_path_factory)


def _ok(res):
    if isinstance(res, Exception):
        pytest.fail(str(res))
    return res


@functools.lru_cache(maxsize=None)
def one_device(net, over_items, f64=False):
    """(loss, initial state, updated state) of the one-device SGD(1.0)
    step."""
    bundle, vgg, c, s, label = W.dp_case(net, dict(over_items), f64=f64)
    before = {n: t.clone() for n, t in bundle.model.state_dict().items()}
    parts = train_step(W.sgd_state(bundle), vgg, c, s, content_label=label)
    return (float(parts["total_loss"]), before,
            {n: t.clone() for n, t in bundle.model.state_dict().items()})


def _largest_update(before, after):
    return max((before[n] - after[n]).abs().max().item() for n in after
               if after[n].numel() and after[n].is_floating_point())


def _check_family(res, key, ref, bound=None):
    loss, before, after = ref
    np.testing.assert_allclose(float(res[f"{key}/total_loss"]), loss,
                               rtol=1e-5)
    assert int(res[f"{key}/sharded"]) > 4, "the rule sharded nothing"
    stored, whole = res[f"{key}/stored"].tolist()
    assert stored < whole
    scale = _largest_update(before, after)
    for n, t in after.items():
        got = res[f"{key}/state/{n}"]
        if bound is None:
            torch.testing.assert_close(got, t, rtol=1e-4, atol=1e-5, msg=n)
        elif t.numel():
            err = (got - t).abs().max().item()
            assert err <= bound * scale, (n, err / scale)


@pytest.mark.parametrize("net,over", W.TP_FAMILIES, ids=IDS)
def test_tp_train_step_matches_single_device(ranks, net, over):
    """float32: the loss at rtol 1e-5 and the update at rpst's limits, or
    for ``FLOAT32_NOISE`` within 1e-3 of the largest update (those but
    the SANets are held in float64 too, below)."""
    key = W.family_id(net, over)
    bound = 1e-3 if net in FLOAT32_NOISE else None
    _check_family(_ok(ranks)[0], key, one_device(net, tuple(over.items())),
                  bound)


@pytest.mark.parametrize("net,over", F64,
                         ids=[W.family_id(n, o) for n, o in F64])
def test_tp_train_step_float64_matches_single_device(ranks, net, over):
    """float64: every parameter and buffer within 1e-6 of the largest
    update of one device's step."""
    key = f"{W.family_id(net, over)}/f64"
    _check_family(_ok(ranks)[0], key,
                  one_device(net, tuple(over.items()), True), 1e-6)


def test_ranks_hold_the_same_whole(ranks):
    """Both model ranks gather the same full state after every step."""
    r0, r1 = _ok(ranks)
    for k in r0:
        if "/state/" in k:
            assert torch.equal(r0[k], r1[k]), k


def test_column_conv_and_folded_interleave(ranks):
    """A column-parallel conv (standard and folded) against the whole one:
    the output, dx, and this rank's slices of dW and db; the folded share
    gathered by a plain concatenation (the wrong interleave) differs."""
    for r in _ok(ranks):
        for k in [k for k in r if k.startswith("ops/") and
                  k.endswith("/got")]:
            torch.testing.assert_close(r[k], r[k[:-3] + "ref"], rtol=1e-5,
                                       atol=1e-6, msg=k)
        assert (r["ops/folded/concat"] - r["ops/folded/y/ref"]).abs().max() \
            > 1e-2


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_folded_se_bottleneck_is_column_parallel(ranks, f64):
    """Folded sel_multi_adain's SE convs on {model: 2} fold their kernel
    shares, tagged for ``folded_column``: 4 x planes / 2 folded outputs a
    rank (planes 8 at the tiny widths), not the whole kernel."""
    key = W.family_id("sel_multi_adain", {"exec_strategy": "folded"})
    for r in _ok(ranks):
        got = r[key + ("/f64" if f64 else "") + "/se_widths"].tolist()
        assert got == [16, 16, 16]


def _flat_tree(prefix):
    tree = {}
    with np.load(FIXTURE) as npz:
        for k in npz.files:
            if k.startswith(prefix):
                node = tree
                *parents, leaf = k[len(prefix):].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = npz[k]
    return tree


@pytest.mark.parametrize("which", ["one", "mesh"])
def test_data_model_step_matches_rpst(fx_ranks, which):
    """{data: 2, model: 2} against rpst's one-device step and its
    {data: 2, model: 4} TP step: loss rtol 1e-5, every updated parameter
    rtol 1e-4 / atol 1e-5, on every rank."""
    ref = from_flax_params(_flat_tree(f"tp/{which}/params/"))
    with np.load(FIXTURE) as npz:
        loss = float(npz[f"tp/{which}/total_loss"])
    for r in _ok(fx_ranks):
        np.testing.assert_allclose(float(r["total_loss"]), loss, rtol=1e-5)
        for n, t in ref.items():
            torch.testing.assert_close(r[f"state/{n}"], t, rtol=1e-4,
                                       atol=1e-5, msg=n)


def test_each_rank_stores_its_shares(fx_ranks):
    """Each rank's parameters are ``bridge.tp_shares`` of rpst's (its model
    index of 2, min_channels 8), and its Adam moments have their shapes:
    less than the whole model's."""
    tree = _flat_tree("tp/params0/")
    full = sum(t.numel() for t in from_flax_params(tree).values())
    for rank, r in enumerate(_ok(fx_ranks)):
        want = from_flax_params(tp_shares(tree, rank % 2, 2, 8))
        numel = 0
        for n, t in want.items():
            torch.testing.assert_close(r[f"share0/{n}"], t, rtol=0, atol=0,
                                       msg=n)
            numel += t.numel()
        assert numel < full
        assert int(r["moments_numel"]) == 2 * numel


def test_checkpoint_round_trip(fx_ranks, tmp_path):
    """The checkpoint holds full shapes: a one-device state restores it and
    equals the gathered state; restored onto {model: 2} again, every
    rank's shares and moments are its own."""
    r0 = _ok(fx_ranks)[0]
    for r in _ok(fx_ranks):
        for k, v in r.items():
            if k.startswith(("restored/", "restored_moment/")):
                assert float(v) == 0.0, k
        assert int(r["restored_step"]) == 1
    state, _, _, _ = W.tp_fixture_state(None)
    ckpt = _ok_ckpt(fx_ranks)
    restore_checkpoint(ckpt, state)
    for n, t in state.model.state_dict().items():
        torch.testing.assert_close(t, r0[f"state/{n}"], rtol=0, atol=0,
                                   msg=n)
    opt = state.optimizer.state_dict()["state"]
    for i, st in opt.items():
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(st[k], r0[f"full_moment/{i}/{k}"],
                                       rtol=0, atol=0)


def _ok_ckpt(fx_ranks):
    res = _ok(fx_ranks)
    root = Path(res[0]["ckpt_root"].numpy().tobytes().decode())
    step = latest_step(root)
    assert step == 1
    return root / str(step)


def test_refusals_name_a_queued_slice():
    """No refusal of the port names a ROADMAP.md section A slice any more:
    slice 8c, the last one queued, is ported (its training half and the
    model axis beside spatial), and ROADMAP.md lists it among the done."""
    named = set()
    files = [REPO / "train_torch.py", REPO / "serve_torch.py"]
    files += sorted((REPO / "src" / "rpst_torch").rglob("*.py"))
    for path in files:
        named |= set(re.findall(r"section A\s+slice (\d\w*)",
                                path.read_text()))
    assert named == set(), named
    roadmap = (REPO / "ROADMAP.md").read_text()
    assert "slice 8c" in roadmap


def test_leaf_rule_is_rpsts():
    """``dist.tp.flax_leaf_spec`` shards exactly the leaves rpst's
    ``_tp_leaf_spec`` gives a ``model`` spec."""
    from rpst.dist.mesh import _tp_leaf_spec
    for shape in [(3, 3, 8, 32), (3, 3, 32, 3), (1, 1, 64, 48), (32,),
                  (30,), (16,), (4, 8), (3, 3, 16, 16)]:
        x = np.zeros(shape, np.float32)
        for tp_size, mc in ((2, 32), (4, 8), (2, 8)):
            spec = _tp_leaf_spec(x, tp_size, mc)
            dim = tp.flax_leaf_spec(shape, tp_size, mc)
            assert (dim is not None) == ("model" in str(spec)), shape
            if dim is not None:
                assert spec[dim] == "model"


def _main(script, argv):
    import importlib.util
    spec = importlib.util.spec_from_file_location(script[:-3],
                                                  REPO / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


def test_driver_trains_a_data_model_mesh(tmp_path):
    """``train_torch.py`` on {data: 2, model: 2} (the folded flagship at
    hidden 32, whose hidden convs shard at min_channels 32): two logged
    steps and a full-shape checkpoint, which a resume on {model: 2} takes
    up and a one-device ``serve_torch.py --weights`` serves."""
    import json
    from PIL import Image
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (tmp_path / sub).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8),
                            "RGB").save(tmp_path / sub / f"{i}.png")
    cfg = dict(network="multi_adain", rp_blocks=3, hidden_dim=32,
               attention="none", img_size=32, batch_size=2, num_workers=0,
               exec_strategy="folded", max_iter=3, snapshot_save_iter=2,
               vgg="", content_dir=str(tmp_path / "content"),
               style_dir=str(tmp_path / "style"),
               output=str(tmp_path / "out"))
    (tmp_path / "cfg.yaml").write_text(json.dumps(cfg))
    args = ["--config", str(tmp_path / "cfg.yaml"), "--device", "cpu",
            "--set"]
    _main("train_torch.py", [*args, "mesh_shape={data: 2, model: 2}"])
    lines = [json.loads(ln) for ln in (tmp_path / "out" / "logs"
                                       / "metrics.jsonl").read_text()
             .splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln["total_loss"]) for ln in lines)
    saved = torch.load(tmp_path / "out" / "checkpoints" / "2" / "state.pt",
                       weights_only=True)
    whole = build_model(load_config(cfg)).model.state_dict()
    assert {k: tuple(v.shape) for k, v in saved["params"].items()} == \
        {k: tuple(v.shape) for k, v in whole.items()}
    _main("train_torch.py", [*args, "mesh_shape={model: 2}", "resume=true",
                             "max_iter=2"])
    assert sorted(p.name for p in (tmp_path / "out" / "checkpoints")
                  .iterdir()) == ["2", "3"]
    _main("serve_torch.py", [
        "--config", str(tmp_path / "cfg.yaml"), "--content",
        str(tmp_path / "content"), "--style",
        str(tmp_path / "style" / "0.png"), "--out", str(tmp_path / "srv"),
        "--device", "cpu", "--mode", "folded", "--weights",
        str(tmp_path / "out" / "checkpoints" / "3" / "state.pt")])
    assert len(list((tmp_path / "srv").glob("*.png"))) == 4
