#!/usr/bin/env python3
"""Read the numbers that decide a cell's ``correct`` over many seeds in one
process: the program's sound runs (the lower readings) and the
configuration's lower precision in its place (the control: the upper
readings), each through the cell's own runner at the cell's own load and
sizes with a short window.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault half --fault-seeds 7,8,9] \
        [--seconds 3] [--out readings.jsonl]

One JSON line per run: the seed, whether it was the control or which
fault it planted (``harness.faults``), the readings
and the run's end-to-end numbers. The limits in ``cells/<cell>.json`` are
set from these readings; no benchmark run calls this.

With ``--witness-seeds`` (a training cell) it reads, for each seed, the
reference against itself over the check's three steps: its losses from
the seed's weights, from the same weights moved by one ulp, and rounded to
the configuration's ``own_precision``: how far the later steps carry a
difference the size of rounding, with no program in the run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402  (sets the cache directories before torch loads)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="seeds of runs with --fault planted")
    ap.add_argument("--fault", default="", help="a fault of harness.faults")
    ap.add_argument("--witness-seeds", default="",
                    help="seeds of the reference-against-itself reading")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from harness.manifest import Manifest
    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    manifest = Manifest(run.ROOT)
    jobs = [(int(s), False, None) for s in args.seeds.split(",") if s]
    jobs += [(int(s), True, None) for s in args.control_seeds.split(",")
             if s]
    jobs += [(int(s), False, args.fault) for s in args.fault_seeds.split(",")
             if s]
    jobs += [(int(s), None, "witness") for s in args.witness_seeds.split(",")
             if s]
    out = open(args.out, "a") if args.out else None
    for seed, control, fault in jobs:
        line = {"workload": args.workload, "seed": seed,
                "control": control, "fault": fault}
        t = time.perf_counter()
        try:
            if fault == "witness":
                line["witness"] = witness(manifest, args.workload, seed,
                                          device)
            else:
                res, _ = run.drive(manifest, args.workload, seed,
                                   args.seconds, False, device,
                                   control=control, fault=fault, t_start=t)
                line.update(readings=res.readings,
                            end_to_end=res.end_to_end,
                            attempted=res.attempted, failed=res.failed,
                            check_losses=res.run.get("check_losses"))
            line["seconds"] = time.perf_counter() - t
        except Exception as e:  # a control that crashes has failed
            line["error"] = f"{type(e).__name__}: {e}"
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


def witness(manifest, cell: str, seed: int, device) -> dict:
    """The reference's three check steps from the seed's weights (``f32``),
    from the same weights moved by one ulp (``ulp``), and rounded to the
    configuration's own precision (``own``): each step's loss, and each
    step's gap of the other two from ``f32``."""
    import torch
    from harness import inputs, program, train
    c = manifest.cell(cell)
    tr, conf = manifest.traffic(c["traffic"]), manifest.config(c["config"])
    cfg = program.settings(conf, tr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    content, style = inputs.pools(tr, cfg["img_size"], seed, device)
    feed = train._feeder(tr, content, style, seed, device)
    prog = program.build(conf, cfg, seed, device, with_vgg=True)
    names = [k for k, p in prog.bundle.model.named_parameters()
             if p.requires_grad]
    weights, vgg = prog.weights, prog.vgg_weights
    del prog
    torch.cuda.empty_cache()
    batches = [feed(j) for j in range(train.CHECK_STEPS)]
    ref = manifest.reference(c["config"])
    from common import adam_steps
    params = {n: weights[n] for n in names}
    ulp = {n: torch.nextafter(w, torch.full_like(w, float("inf")))
           for n, w in params.items()}
    lr, decay = float(cfg["lr"]), float(cfg["lr_decay"])
    losses = {}
    for name, prec, p in (("f32", "f32", params), ("ulp", "f32", ulp),
                          ("own", conf["own_precision"], params)):
        model = ref.build(cfg, weights, vgg, precision=prec)
        losses[name] = adam_steps(p, model.loss, batches, lr, decay)[0]
    base = losses["f32"]
    gaps = {k: [abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(losses[k], base)] for k in ("ulp", "own")}
    return {"losses": losses, "gaps": gaps}


if __name__ == "__main__":
    sys.exit(main())
