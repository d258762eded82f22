"""Find what ``BENCHMARK.json`` names, by name.

Every configuration, traffic mix, cell limit, per-layer reader and plain
reference is a file of its own under the benchmark's folder:

  * ``configs/<config>.json`` (the manifest's ``file`` for it);
  * ``traffic/<mix>.json``;
  * ``cells/<cell>.json`` (the limits that decide ``correct``);
  * ``metrics/<metric>.py`` (a ``read(run)`` that returns a number or None);
  * ``reference/<config>.py`` (the plain PyTorch reference).

A cell is added by adding files and manifest entries only.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Manifest:
    """``BENCHMARK.json`` of the checkout ``root`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> Dict[str, Any]:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        return _json(self.root / self.config_entry(name)["file"])

    def traffic(self, name: str) -> Dict[str, Any]:
        return _json(self.bench / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, Any]:
        return _json(self.bench / "cells" / f"{cell}.json")

    def reference(self, config: str) -> ModuleType:
        """The configuration's plain reference; its shared pieces
        (``reference/common.py``) import by their bare name."""
        ref_dir = str(self.bench / "reference")
        if ref_dir not in sys.path:
            sys.path.insert(0, ref_dir)
        return load_module(self.bench / "reference" / f"{config}.py",
                           f"bench_reference_{config}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           f"bench_metric_{metric.replace('.', '_')}")

    def metrics_of(self, cell: str, section: str) -> List[Dict[str, Any]]:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
        whose ``workloads`` list it, or, without the key, every cell that
        reports the end-to-end metric the entry moves (per-layer) or every
        cell (end-to-end)."""
        e2e = {m["name"] for m in self.data["end_to_end"]
               if cell in m.get("workloads", [cell])}
        out = []
        for m in self.data[section]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def _json(path: Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by its path (names with dots are no package paths)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
