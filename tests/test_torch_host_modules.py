"""The port's host modules against rpst's:

  * ``train.metrics.MetricWriter``'s TensorBoard event files hold the same
    (tag, step, value) scalars as rpst's (``tensorboard=True``), read with
    tensorboard's ``EventFileLoader`` as tests/test_train.py reads them;
  * ``train.profiler``: ``trace`` / ``start_trace`` / ``stop_trace`` write a
    ``*.pt.trace.json`` holding the traced ops and ``annotate``'s span;
  * ``ops.groupwise_adain`` against rpst's at float32 1e-5;
  * ``data.FlatFolderDataset`` against rpst's on a temporary tree: the same
    paths in the same order;
  * ``dist.make_mesh`` and ``tools/flops_estimate_torch.py`` take the card
    by default and raise without one.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.data import FlatFolderDataset as JFlatFolderDataset
from rpst.ops import groupwise_adain as jgroupwise_adain
from rpst_torch.data import FlatFolderDataset
from rpst_torch.ops import groupwise_adain
from rpst_torch.train import profiler

REPO = Path(__file__).resolve().parent.parent


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.util import tensor_util
    (events,) = Path(log_dir).glob("events.out.tfevents.*")
    seen = set()
    for ev in EventFileLoader(str(events)).Load():
        for v in getattr(ev.summary, "value", []):
            value = (v.simple_value if v.WhichOneof("value") == "simple_value"
                     else float(tensor_util.make_ndarray(v.tensor)))
            seen.add((v.tag, ev.step, value))
    return seen


def test_tensorboard_scalars_equal_rpsts(tmp_path):
    pytest.importorskip("tensorboard")
    from rpst.train.metrics import MetricWriter as JMetricWriter
    from rpst_torch.train.metrics import MetricWriter
    rows = [(1, {"total_loss": 2.5, "style_loss": 1.25, "skipped": 0.0}),
            (2, {"total_loss": 2.0, "style_loss": 1.0, "skipped": 1.0})]
    ours = MetricWriter(tmp_path / "a")
    ref = JMetricWriter(tmp_path / "b", tensorboard=True)
    for step, scalars in rows:
        ours.write(step, {k: torch.tensor(v) for k, v in scalars.items()})
        ref.write(step, scalars)
    ours.close()
    ref.close()
    got = _scalars(tmp_path / "a" / "logs")
    assert got == _scalars(tmp_path / "b" / "logs")
    assert len(got) == 6
    # the JSONL beside them is unchanged: one line a step
    assert len((tmp_path / "a" / "logs" / "metrics.jsonl").read_text()
               .splitlines()) == 2


def test_metric_writer_without_tensorboard(tmp_path):
    from rpst_torch.train.metrics import MetricWriter
    w = MetricWriter(tmp_path, tensorboard=False)
    w.write(3, {"total_loss": 1.0})
    w.close()
    assert [p.name for p in (tmp_path / "logs").iterdir()] == \
        ["metrics.jsonl"]


def _events(trace_dir):
    (path,) = Path(trace_dir).glob("*.pt.trace.json")
    return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


def test_trace_holds_the_ops_and_spans(tmp_path):
    x, w = torch.randn(1, 3, 8, 8), torch.randn(4, 3, 3, 3)
    with profiler.trace(tmp_path / "ctx", "cpu"):
        with profiler.annotate("rpst_step"):
            torch.nn.functional.conv2d(x, w)
    names = _events(tmp_path / "ctx")
    assert {"aten::convolution", "rpst_step"} <= names

    profiler.start_trace(tmp_path / "span", torch.device("cpu"))
    with pytest.raises(RuntimeError, match="already running"):
        profiler.start_trace(tmp_path / "other", "cpu")
    torch.mm(x[0, 0], x[0, 0])
    profiler.stop_trace()
    assert "aten::mm" in _events(tmp_path / "span")
    assert not (tmp_path / "other").exists()
    from rpst_torch.train.metrics import StepTimer
    assert profiler.StepTimer is StepTimer


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 7, 3)])
def test_groupwise_adain_matches_rpst(shape):
    rng = np.random.default_rng(shape[-1])
    c = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    ref = np.asarray(jgroupwise_adain(jnp.asarray(c), jnp.asarray(s)))
    got = groupwise_adain(torch.from_numpy(c), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("root2", [False, True])
def test_flat_folder_dataset_matches_rpst(tmp_path, root2):
    for rel in ("b/P2.png", "a/P1.png", "a/Q1.png", "a/P0.jpg", "c/x.png",
                "P9.png", "extra/z.png", "extra/a.png"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    kw = {"root2": tmp_path / "extra"} if root2 else {}
    ours = FlatFolderDataset(tmp_path, 16, **kw)
    ref = JFlatFolderDataset(tmp_path, 16, **kw)
    assert ours.paths == ref.paths and len(ours) == len(ref)
    assert [p.name for p in ours.paths][:3] == ["P0.jpg", "P1.png", "P2.png"]


def test_make_mesh_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from rpst_torch.dist import make_mesh
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh({"data": 1})
    assert make_mesh({"data": 1}, torch.device("cpu")).device.type == "cpu"


def test_flops_tool_needs_a_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location(
        "flops_estimate_torch", REPO / "tools" / "flops_estimate_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with pytest.raises(SystemExit, match="is_available"):
        tool.main(["multi_adain", "--img", "16"])
    assert capsys.readouterr().out == ""
