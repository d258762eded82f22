#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (``benchmark/configs/<config>.json``) and a
traffic mix (``benchmark/traffic/<mix>.json``); the mix's ``kind`` picks
the runner (``serve``: a closed loop of clients on ``rpst_torch``'s
``DynamicBatcher``; ``train``: ``train_step`` at the mix's batch). The run
loads, warms up, measures for ``--seconds``, judges what the timed path
produced against the configuration's plain reference
(``benchmark/reference/<config>.py``) within the cell's limits
(``benchmark/cells/<cell>.json``), and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``:
its per-layer metrics, each from ``benchmark/metrics/<metric>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit (also the last lines of standard error).

It exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``rpst`` is loaded once the window has closed. The port's
kernels build into ``build/rpst_torch/`` inside the checkout (the first
run of a cell there compiles them); any Triton or extension cache, and the
bytecode of the modules it imports, go to fixed directories under
``build/`` too.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# fixed cache directories inside the checkout, set before torch loads
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
sys.path.insert(0, str(BENCH))
# the bytecode of every module a run imports, cached inside the checkout:
# where the environment says not to write it (PYTHONDONTWRITEBYTECODE),
# every run would compile PyTorch's modules again in its set-up
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False

FORBIDDEN = ("jax", "jaxlib", "flax", "rpst")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``rpst_torch`` is the port."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def drive(manifest, cell_name: str, seed: int, seconds: float, trace: bool,
          device, overrides=None, fault=None, control=False,
          t_start: float = T_START, marks=()):
    """Run one cell on ``device``: (Result, limits). The tests call it on
    the CPU at a small size; ``main`` on the card."""
    from harness import serve, train
    from harness.context import Ctx
    cell = manifest.cell(cell_name)
    traffic = manifest.traffic(cell["traffic"])
    ctx = Ctx(config_name=cell["config"],
              config=manifest.config(cell["config"]), traffic=traffic,
              seed=seed, seconds=seconds, trace=trace, device=device,
              t_start=t_start, reference=manifest.reference(cell["config"]),
              overrides=dict(overrides or {}), fault=fault, control=control,
              marks=list(marks))
    runner = {"serve": serve, "train": train}[traffic["kind"]]
    return runner.run(ctx), manifest.limits(cell_name)


def result_line(manifest, cell_name: str, res, limits: dict, trace: bool,
                device_info: dict):
    """(the JSON object of the last line, the check lines for stderr)."""
    from harness import check
    ok, checks = check.verdict(res.readings, limits["limits"])
    correct = bool(ok and res.failed == 0 and res.attempted > 0)
    metrics = {}
    if trace:
        for m in manifest.metrics_of(cell_name, "per_layer"):
            value = manifest.reader(m["name"]).read(res.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.metrics_of(cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": res.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": correct, "attempted": res.attempted,
           "failed": res.failed, "metrics": metrics, "device": device_info}
    if trace and res.trace is not None:
        out["device"] = dict(device_info, busy_s=res.trace["busy_s"],
                             window_s=res.trace["window_s"])
        out["breakdown"] = res.trace["breakdown"]
    checks["failed"] = {"value": res.failed, "limit": 0}
    out["checks"] = {k: {n: _finite(v) for n, v in c.items()}
                     for k, c in checks.items()}
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return out, lines


def _finite(v):
    """JSON has no infinity: a reading that could not be taken is null."""
    return v if v == v and v not in (float("inf"), float("-inf")) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness.manifest import Manifest
    manifest = Manifest(ROOT)
    chips = int(manifest.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    res, limits = drive(manifest, args.workload, args.seed, args.seconds,
                        bool(args.trace), device,
                        marks=[("torch_cuda", time.perf_counter())])
    loaded = forbidden_modules()
    if loaded:
        print(f"run.py: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": res.memory_peak_bytes}
    out, lines = result_line(manifest, args.workload, res, limits,
                             bool(args.trace), info)
    for phase, seconds in res.run["setup_phases"]:
        print(f"setup {phase} {seconds!r}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
