"""A cell is added as data alone: a copy of the manifest with a new mix,
a new cell, or a new configuration, and no file of the harness changed,
runs end to end (on the CPU at 32px)."""

import json
import shutil

import pytest
import torch

import run
from harness.manifest import Manifest


def _checkout(tmp_path, manifest):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.bench, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(manifest.root / "src")
    return root, json.loads(json.dumps(manifest.data))


def _add_cell(root, data, name, config, traffic, like):
    """A workload entry for ``name`` that reports what ``like`` reports,
    with ``like``'s limits as its own."""
    (root / "benchmark" / "cells" / f"{name}.json").write_text(
        (root / "benchmark" / "cells" / f"{like}.json").read_text())
    data["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "a cell added as data"})
    for m in data["end_to_end"] + data["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)


def test_a_new_cell_needs_only_data(tmp_path, manifest):
    root, data = _checkout(tmp_path, manifest)
    mix = dict(manifest.traffic("closed_c16_b4"), clients=4, batch_size=2)
    (root / "benchmark" / "traffic" / "closed_c4_b2.json").write_text(
        json.dumps(mix))
    _add_cell(root, data, "flagship.serve_b2", "rp_adain_flagship",
              "closed_c4_b2", "flagship.serve_b8")
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    new = Manifest(root)
    res, limits = run.drive(new, "flagship.serve_b2", 5, 0.5, False,
                            torch.device("cpu"), overrides={"img_size": 32})
    out, _ = run.result_line(new, "flagship.serve_b2", res, limits, False,
                             {})
    assert set(out["metrics"]) == {"serve_img_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


F32 = "rp_adain_f32"


@pytest.fixture
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _float32_config(root, data, manifest):
    """A float32 configuration: its file (checks in units of TF32's
    rounding, the reference in bfloat16 as its control) and its plain
    reference, a copy of the flagship's."""
    conf = manifest.config("rp_adain_flagship")
    conf["settings"]["compute_dtype"] = "float32"
    conf["own_precision"] = "tf32"
    conf["control"] = {"serve": "bf16", "train": "bf16"}
    (root / "benchmark" / "configs" / f"{F32}.json").write_text(
        json.dumps(conf))
    shutil.copy(root / "benchmark" / "reference" / "rp_adain_flagship.py",
                root / "benchmark" / "reference" / f"{F32}.py")
    entry = dict(manifest.config_entry("rp_adain_flagship"), name=F32,
                 file=f"benchmark/configs/{F32}.json",
                 reduced=["style_weight", "batch_size"])
    data["configs"].append(entry)


@pytest.mark.parametrize("kind,traffic,like,seconds", [
    ("serve", "closed_c16_b4", "flagship.serve_b8", 2.0),
    ("train", "train_b4", "flagship.train_b8", 0.5)])
def test_a_float32_configuration_needs_only_data(tmp_path, manifest, kind,
                                                 traffic, like, seconds,
                                                 two_threads):
    root, data = _checkout(tmp_path, manifest)
    _float32_config(root, data, manifest)
    cell = f"f32.{kind}"
    _add_cell(root, data, cell, F32, traffic, like)
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    new = Manifest(root)
    small = {"img_size": 32}
    verdicts = {}
    for control in (False, True):
        res, limits = run.drive(new, cell, 7, seconds, False,
                                torch.device("cpu"), overrides=small,
                                control=control)
        out, lines = run.result_line(new, cell, res, limits, False, {})
        verdicts[control] = (out["correct"], lines)
    # float32 against the float32 reference in units of TF32's rounding:
    # sound; the reference in bfloat16 in its place: not
    assert verdicts[False][0] is True, verdicts[False][1]
    assert verdicts[True][0] is False, verdicts[True][1]
