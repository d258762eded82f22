"""No module a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``rpst`` (compared whole: ``rpst_torch`` is the port), and the
references import nothing of the port."""

import subprocess
import sys

from harness.manifest import BENCH

RUN = f"""
import sys, json
sys.argv = ["run.py"]
sys.path.insert(0, {str(BENCH)!r})
import torch
torch.set_num_threads(2)
import run
from harness.manifest import Manifest
m = Manifest()
for cell in {{w["name"] for w in m.data["workloads"]}}:
    res, limits = run.drive(m, cell, 77, 0.5, False, torch.device("cpu"),
                            overrides={{"img_size": 32}})
    run.result_line(m, cell, res, limits, False, {{}})
print(json.dumps(sorted({{k.split(".", 1)[0] for k in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_rpst():
    names = _top_level(RUN)
    assert "rpst_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "rpst"}


def test_forbidden_names_compare_whole(monkeypatch):
    import run
    for name in ("rpst", "rpst.models", "jax", "flax"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "rpst_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rpst.models", sys)
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert run.forbidden_modules() == ["flax", "rpst"]


def test_references_import_nothing_of_the_port():
    code = f"""
import sys, json
sys.path.insert(0, {str(BENCH)!r})
from harness.manifest import Manifest
m = Manifest()
for c in m.data["configs"]:
    m.reference(c["name"])
print(json.dumps(sorted({{k.split(".", 1)[0] for k in sys.modules}})))
"""
    names = _top_level(code)
    assert not names & {"rpst_torch", "jax", "jaxlib", "flax", "rpst"}
