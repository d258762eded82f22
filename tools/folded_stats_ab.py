#!/usr/bin/env python
"""Time the folded flagship's stylize and train step of two checkouts of the
port in one call, on one CUDA card: this checkout and an earlier one
(``--parent``, the root of an unpacked tree), in the order parent, this,
this, parent, each run in a child process of its own. Made to compare the
folded AdaIN statistics (``ops.folded.folded_calc_mean_std``) of two trees.
In this checkout's children it also times the folded CCAM residual
(``models.fast_path._folded_ccam``: rpst's full (4C, 4C) product with its
diagonal blocks kept and the kron(I4, att) recombination) against the same
sums at a quarter of the arithmetic (``quarter_ccam`` below), alone at
ccam's 512px b8 shape and inside ccam's folded stylize, in the order
quarter, this, this, quarter.

    python3 tools/folded_stats_ab.py --parent build/parent

The parent's tree is unpacked from git beforehand, e.g. ``git archive
<commit> | tar -x -C build/parent``. The kernels are built for this
checkout first and copied into the parent's build directory (the libraries
are named by a hash of their source and flags, so only unchanged sources
are reused). Each child prints one JSON line: the median ms of CUDA-event-
timed calls after 2 warm-ups at 512px, seeded weights (the flagship:
multi_adain, constant stack, rp_blocks 5, hidden 32, folded): the stylize
at b8 in float32 and bfloat16 (7 calls), the train step at b4 in float32
and bfloat16 (5 steps). The table ends with the card's name and power
limit.
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
IMG = 512
FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=5,
                hidden_dim=32, inception_num=0, attention="none", seed=0,
                exec_strategy="folded", img_size=IMG)
CCAM_YAML = ("configs/"
             "train_constant_multiscale_rp_adain_channel_attention.yaml")


def median_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def quarter_ccam(x_f, y_f, scale):
    """``models.fast_path._folded_ccam`` at a quarter of the arithmetic: the
    energy as one (C, P) x (P, C) product per sub-position block (strided
    operands), the four added, and the recombination y attᵀ on the
    (N, 4P, C) pixel-row view; the same sums as the full (4C, 4C) form."""
    import torch
    x_f, y_f = x_f.detach(), y_f.detach()
    n, hh, ww, c4 = x_f.shape
    c = c4 // 4
    xs = x_f.reshape(n, hh * ww, 4, c).float()
    ys = y_f.reshape(n, hh * ww, 4, c).float()
    e = sum(torch.bmm(xs[:, :, i].transpose(1, 2), ys[:, :, i])
            for i in range(4))
    att = torch.softmax(e.amax(dim=-1, keepdim=True) - e, dim=-1)
    yr = y_f.reshape(n, hh * ww * 4, c)
    out = torch.bmm(yr, att.transpose(1, 2).to(yr.dtype))
    return x_f + scale * out.reshape(x_f.shape)


def time_ccam(root: Path, out: dict) -> None:
    """The CCAM residual alone and ccam's folded bf16 stylize at b8, the
    quarter-arithmetic form against this tree's."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.models import fast_path
    from rpst_torch.nn.blocks import init_torch_default

    ours = fast_path._folded_ccam
    g = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        x, y = (torch.randn(8, IMG // 2, IMG // 2, 128, generator=g,
                            device="cuda").to(dt) for _ in range(2))
        scale = torch.tensor(0.5, device="cuda", dtype=dt)
        err = (ours(x, y, scale).float()
               - quarter_ccam(x, y, scale).float()).abs().max().item()
        for label, fn in (("quarter", quarter_ccam), ("this", ours),
                          ("this", ours), ("quarter", quarter_ccam)):
            key = f"ccam op b8 {str(dt)[6:]} {label}"
            out.setdefault(key, []).append(
                median_ms(lambda: fn(x, y, scale), 20))
        out[f"ccam op b8 {str(dt)[6:]} max |this - quarter|"] = err
    cfg = load_config(str(root / CCAM_YAML),
                      dict(img_size=IMG, vgg="", test_dir="", shuffle=False,
                           exec_strategy="folded", compute_dtype="bfloat16"))
    bundle = build_model(cfg, "cuda")
    init_torch_default(bundle.model, cfg.seed)
    rng = np.random.default_rng(0)
    c, s = (torch.from_numpy(rng.random((8, IMG, IMG, 3), np.float32)).cuda()
            for _ in range(2))
    for label, fn in (("quarter", quarter_ccam), ("this", ours),
                      ("this", ours), ("quarter", quarter_ccam)):
        fast_path._folded_ccam = fn
        with torch.inference_mode():
            ms = median_ms(lambda: bundle.stylize(c, s), 7)
        out.setdefault(f"ccam stylize b8 bfloat16 {label}", []).append(ms)
    fast_path._folded_ccam = ours


def time_tree(root: Path, ccam: bool) -> dict:
    """The child: times of ``root``'s rpst_torch."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    out = {}
    for batch, train in ((8, False), (4, True)):
        c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).cuda()
                for _ in range(2))
        for dt in ("float32", "bfloat16"):
            cfg = load_config(dict(FLAGSHIP, compute_dtype=dt))
            bundle = build_model(cfg, "cuda")
            init_torch_default(bundle.model, cfg.seed)
            if train:
                vgg, _ = build_vgg(cfg, "cuda")
                state = create_train_state(bundle)
                out[f"step b{batch} {dt}"] = median_ms(
                    lambda: train_step(state, vgg, c, s), 5)
                del state, vgg
            else:
                with torch.inference_mode():
                    out[f"stylize b{batch} {dt}"] = median_ms(
                        lambda: bundle.stylize(c, s), 7)
            del bundle
            torch.cuda.empty_cache()
    if ccam:
        time_ccam(root, out)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of the earlier tree")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--ccam", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(time_tree(args.tree.resolve(), args.ccam)),
              flush=True)
        return
    if not args.parent:
        ap.error("--parent is required")
    parent = args.parent.resolve()
    sys.path.insert(0, str(REPO / "src"))
    from rpst_torch.kernels import build
    build.build_all()
    dst = parent / "build" / "rpst_torch"
    dst.mkdir(parents=True, exist_ok=True)
    for lib in build.BUILD_DIR.glob("*.so"):
        shutil.copy2(lib, dst / lib.name)
    runs = []
    for label, root in (("parent", parent), ("this", REPO), ("this", REPO),
                        ("parent", parent)):
        cmd = [sys.executable, __file__, "--tree", str(root)]
        if root == REPO:
            cmd.append("--ccam")
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1200)
        if proc.returncode != 0:
            raise SystemExit(f"{label} tree failed:\n{proc.stderr[-3000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        for key, v in runs[-1][1].items():
            print(f"{label:6s} {key:40s} {v}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"runs": runs, "card": card}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
