#!/usr/bin/env python
"""Time the static SANet's bfloat16 and int8 (q8) stylize of two checkouts
of the port in one call, on one CUDA card: this checkout and an earlier one
(``--parent``, the root of an unpacked tree), in the order parent, this,
this, parent, each run in a child process of its own. Made to compare the
attention transform in the working type (before) with the transform in
float32 as rpst computes it (after).

    python3 tools/sanet_transform_ab.py --parent build/parent

The parent's tree is unpacked from git beforehand, e.g. ``git archive
<commit> | tar -x -C build/parent``. The kernels built for this checkout
are copied into the parent's build directory first (the libraries are named
by a hash of their source and flags, so only unchanged sources are reused).
Each child prints one JSON line: median ms of 7 CUDA-event-timed calls
after 2 warm-ups at 512px (configs/train_static_sanet.yaml, seeded weights,
a random VGG), batch 1 and 4, with the launches of the bfloat16 (tensor
core) and float32 B6 forward per call. The table ends with the card's name
and power limit.
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
IMG = 512


def time_tree(root: Path) -> dict:
    """The child: times of ``root``'s rpst_torch."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.ops.flash_attention import flash_fwd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = load_config(str(root / "configs" / "train_static_sanet.yaml"),
                      dict(img_size=IMG, vgg="", test_dir="",
                           compute_dtype="bfloat16"))
    bundle = build_model(cfg, dev)
    init_torch_default(bundle.model, cfg.seed)
    bundle.vgg, _ = build_vgg(cfg, dev)
    rng = np.random.default_rng(0)
    out = {}
    for batch in (1, 4):
        c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).to(dev)
                for _ in range(2))
        scales = bundle.calibrate_q8(c, s)
        for path, fn in (("bf16", lambda: bundle.stylize(c, s)),
                         ("q8", lambda: bundle.stylize_q8(c, s, scales))):
            flash_fwd.launches = flash_fwd.launches_bf16 = 0
            fn()
            torch.cuda.synchronize()
            launches = {"f32": flash_fwd.launches - flash_fwd.launches_bf16,
                        "bf16": flash_fwd.launches_bf16}
            for _ in range(2):
                fn()
            times = []
            for _ in range(7):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            out[f"b{batch} {path}"] = {"ms": sorted(times)[3],
                                       "B6 forward launches": launches}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of the earlier tree")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(time_tree(args.tree.resolve())), flush=True)
        return
    if not args.parent:
        ap.error("--parent is required")
    parent = args.parent.resolve()
    built = REPO / "build" / "rpst_torch"
    runs = []
    for label, root in (("parent", parent), ("this", REPO), ("this", REPO),
                        ("parent", parent)):
        if root == parent and built.exists():
            dst = parent / "build" / "rpst_torch"
            dst.mkdir(parents=True, exist_ok=True)
            for lib in built.glob("*.so"):
                shutil.copy2(lib, dst / lib.name)
        proc = subprocess.run([sys.executable, __file__, "--tree", str(root)],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            raise SystemExit(f"{label} tree failed:\n{proc.stderr[-3000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        for key, v in runs[-1][1].items():
            print(f"{label:6s} {key:8s} {v['ms']:9.3f} ms  B6 forward "
                  f"launches {v['B6 forward launches']}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"runs": runs, "card": card}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
