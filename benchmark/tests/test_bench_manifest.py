"""``BENCHMARK.json`` against the benchmark's schema, and every name it
gives resolving to a file of its own under the benchmark's folder."""

import re

from harness.manifest import NAME_RE, UNIT_RE
from reference.common import MODES

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _names(d):
    yield from (c["name"] for c in d["configs"])
    yield from (w["name"] for w in d["workloads"])
    for w in d["workloads"]:
        yield w["config"]
        yield w["traffic"]
    yield from (m["name"] for m in d["end_to_end"] + d["per_layer"])
    for c in d["configs"]:
        yield from c["reduced"]


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_names(manifest):
    d = manifest.data
    assert set(d) == TOP
    assert d["command"] == ["python3", "benchmark/run.py"]
    assert d["paths"] == ["benchmark"]
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    for name in _names(d):
        assert NAME_RE.match(name), name
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in d[section]]
        assert len(names) == len(set(names)), section
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT_RE.match(m["unit"]) and m["better"] in ("lower",
                                                            "higher")
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert c["reduced"] == manifest.config(c["name"])["reduced"]
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_end_to_end_bounds_and_setup(manifest):
    d = manifest.data
    names = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in names
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_its_per_layer_metrics_move(manifest):
    d = manifest.data
    for w in d["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(w["name"],
                                                      "end_to_end")}
        per = manifest.metrics_of(w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and per, w["name"]
        for m in per:
            assert m["moves"] in e2e, (w["name"], m["name"])
    layers = {}
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_name_has_its_file(manifest):
    d, bench = manifest.data, manifest.bench
    for w in d["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench / "cells" / f"{w['name']}.json").is_file()
        assert (bench / "reference" / f"{w['config']}.py").is_file()
        limits = manifest.limits(w["name"])["limits"]
        assert limits and all(v > 0 for v in limits.values())
    for m in d["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)
    for c in d["configs"]:
        conf = manifest.config(c["name"])
        assert {"settings", "serve_mode", "control", "own_precision",
                "weights", "flops", "kernel_launches"} <= set(conf)
        # the checks' unit rounds; each control is a path or a precision
        assert conf["own_precision"] in MODES[1:]
        assert conf["control"]["train"] in MODES[1:]
        assert conf["control"]["serve"] in MODES[1:] + ("program_q8",)
    files = [p for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts]
    for p in files:
        assert re.match(r"^[A-Za-z0-9_./-]+$",
                        str(p.relative_to(manifest.root))), p
