#!/usr/bin/env python
"""Where the device time goes in the port's folded flagship (multi_adain,
constant stack, rp_blocks 5, hidden 32) at 512px with seeded weights, on one
CUDA device: the stylize call at b1 and b8 (default), or with ``--train``
the train step (loss, backward, Adam; B1 + B2 + B3) at b1 and b4; float32
and bfloat16 each. With ``--q8``, the int8 stylize (bfloat16 around the
int8 layers, as served) at b1 and b8, calibrated on the batch, once with B4
alone and once with B7 pairs (``fuse_pairs``). With ``--network adain`` the
adain stylize (rp_blocks 5, hidden 32) at b1 and b4: the standard path in
float32 and bfloat16, or with ``--q8`` its int8 path on B5. With ``--network
sanet`` the static SANet (``configs/train_static_sanet.yaml``, seeded
weights, a seeded 5-stage VGG) at b1 and b4: the standard stylize, with
``--q8`` the int8 stylize (B5 + B6), with ``--train`` the train step (B6's
forward with LSE, dQ and dK/dV). With ``--train
--q8-targets`` the flagship's train step with the int8 VGG loss targets on
B5 (whatever ``rpst_torch.policy.TRAIN_Q8_TARGETS_MIN_BATCH`` says).

For each case it prints one Markdown table row:

  | batch, type | ms per call | B1 [B2 B3] share | other kernels | idle share |

  ms per call   median of CUDA-event-timed calls (20 stylize, 5 train
                steps) after warm-ups, without the profiler
  Bn share      device time of the kernel (B1 and B2 folded_mma_kernel,
                told apart by its BWD template argument; their per-launch
                weight packing, prep_weights_kernel, counts as other; B3
                grad_weight_partial + _reduce, B4
                folded_conv_q8_kernel, B7 folded_conv2_q8_kernel, B5
                conv2d_mma_kernel, B6 flash_fwd_tf32_kernel (float32) and
                flash_fwd_mma_kernel (bfloat16), B6c
                flash_bwd_dq_kernel, B6d flash_bwd_dkv_kernel; the stats'
                finalize_sums counts as other)
                over all device
                time, in the profiled calls
  other         the three next kernels by device time, names shortened
  idle share    1 - (union of device activity) / (first start .. last end)
                over the profiled calls (5 stylize, 3 train steps)

It also writes each case's ``key_averages()`` table to
``chiprun_out/profile_torch[_train|_q8][_adain][_q8targets].txt``. The
card's name and power limit come first, as nvidia-smi gives them. (For
sanet the file name has ``_sanet`` where adain's has ``_adain``.)

    python3 profile_torch.py [--train [--q8-targets] | --q8]
                             [--network adain|sanet]
"""

import argparse
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

import numpy as np
import torch

from rpst_torch.config import load_config
from rpst_torch.models import build_model, build_vgg
from rpst_torch.models.fast_path import stylize_multi_adain_folded
from rpst_torch.nn.blocks import init_torch_default
from rpst_torch.train.step import create_train_state, train_step

FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=5,
                hidden_dim=32, inception_num=0, attention="none", seed=0,
                exec_strategy="folded")
IMG = 512
# report column -> the kernel-name prefixes it sums
KERNELS = {"B1": ("folded_mma_kernel[B1]",),
           "B2": ("folded_mma_kernel[B2]",),
           "B3": ("grad_weight_partial", "grad_weight_reduce"),
           "B4": ("folded_conv_q8_kernel",), "B7": ("folded_conv2_q8_kernel",),
           "B5": ("conv2d_mma_kernel",),
           "B6": ("flash_fwd_tf32_kernel", "flash_fwd_mma_kernel"),
           "B6c": ("flash_bwd_dq_kernel",), "B6d": ("flash_bwd_dkv_kernel",)}
ADAIN = dict(network="adain", rp_blocks=5, hidden_dim=32, seed=0)
SANET_YAML = REPO / "configs" / "train_static_sanet.yaml"


def short_name(name: str) -> str:
    """'void at::native::reduce_kernel<512, 1, ...>(...)' -> 'reduce_kernel';
    B1 and B2's shared kernel 'folded::folded_mma_kernel<T, WIDE, BWD, ...>'
    -> 'folded_mma_kernel[B1]' or '[B2]' by its BWD argument."""
    bwd = re.search(r"folded_mma_kernel<[^,]+,\s*\w+,\s*(\w+)", name)
    if bwd:
        op = "B2" if bwd.group(1) in ("true", "1") else "B1"
        return f"folded_mma_kernel[{op}]"
    name = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
    name = name.split("<")[0].split("(")[0]
    return name.rsplit("::", 1)[-1].strip()


def kernel_of(name: str):
    for col, prefixes in KERNELS.items():
        if name.startswith(prefixes):
            return col
    return None


def cuda_ms(fn, iters=20, warmup=3) -> float:
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
    return statistics.median(times)


def device_breakdown(fn, calls):
    """(device time by short kernel name, idle share, key_averages
    table) over ``calls`` profiled calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type.name == "CUDA")
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    by_name, busy, cur_start, cur_end = {}, 0.0, None, None
    for start, end, name in spans:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (end - start)
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = spans[-1][1] - spans[0][0]
    table = prof.key_averages().table(sort_by="self_device_time_total"
                                      if hasattr(prof.key_averages()[0],
                                                 "self_device_time_total")
                                      else "self_cuda_time_total",
                                      row_limit=15)
    return by_name, 1.0 - busy / window, table


def report(label, fn, cols, iters, calls, card, tables):
    """Time ``fn``, profile it, print its row and keep its table."""
    ms = cuda_ms(fn, iters=iters, warmup=3)
    by_name, idle, table = device_breakdown(fn, calls)
    total = sum(by_name.values())
    share = {col: sum(v for k, v in by_name.items() if kernel_of(k) == col)
             for col in cols}
    others = sorted(((v, k) for k, v in by_name.items()
                     if kernel_of(k) is None), reverse=True)[:3]
    print(f"| {label} | {ms:.3f} | "
          + " | ".join(f"{100 * share[c] / total:.1f}%" for c in cols)
          + " | " + ", ".join(f"{k} {100 * v / total:.1f}%"
                              for v, k in others)
          + f" | {100 * idle:.1f}% |", flush=True)
    tables.append(f"=== {label} ({card})\n{table}")


def main():
    ap = argparse.ArgumentParser(description="device-time shares of the "
                                 "folded flagship on one CUDA device")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile the train step instead of stylize")
    mode.add_argument("--q8", action="store_true",
                      help="profile the int8 stylize instead")
    ap.add_argument("--network", choices=("multi_adain", "adain", "sanet"),
                    default="multi_adain",
                    help="adain: its standard (or with --q8 its int8) "
                    "stylize at b1 and b4; sanet: the same, or with --train "
                    "its train step")
    ap.add_argument("--q8-targets", action="store_true",
                    help="with --train: the int8 VGG loss targets on B5")
    args = ap.parse_args()
    if args.q8_targets and not args.train:
        ap.error("--q8-targets goes with --train")
    adain = args.network == "adain"
    if adain and args.train:
        ap.error("--network adain profiles serving only")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    sanet = args.network == "sanet"
    if sanet and args.q8_targets:
        ap.error("--q8-targets is the flagship's")
    if sanet:
        cfg = load_config(str(SANET_YAML), dict(img_size=IMG, vgg="",
                                                test_dir=""))
    else:
        cfg = load_config(dict(ADAIN if adain else FLAGSHIP, img_size=IMG,
                               train_q8_targets=args.q8_targets))
    rng = np.random.default_rng(0)
    tables = []
    cols = (("B6", "B6c", "B6d") if sanet and args.train
            else ("B6", "B5") if sanet
            else ("B5",) if adain
            else ("B1", "B2", "B3", "B5") if args.q8_targets
            else ("B1", "B2", "B3") if args.train
            else ("B1", "B4", "B7") if args.q8 else ("B1",))
    print("| batch, type | ms per " + ("step" if args.train else "call")
          + " | " + " | ".join(f"{c} share" for c in cols)
          + " | other kernels by share | idle share |")
    print("| --- | --- | " + "--- | " * len(cols) + "--- | --- |")
    for batch in ((1, 4) if args.train or adain or sanet else (1, 8)):
        c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).cuda()
                for _ in range(2))
        for dt in (torch.float32, torch.bfloat16):
            label = f"b{batch} {str(dt)[6:]}"
            if args.train:
                bundle = build_model(cfg.replace(
                    compute_dtype=str(dt)[6:]), "cuda")
                init_torch_default(bundle.model, cfg.seed)
                vgg, _ = build_vgg(cfg, "cuda")
                bundle.vgg = vgg
                if args.q8_targets:
                    from rpst_torch import policy
                    from rpst_torch.models.fast_path_q8_std import (
                        calibrate_vgg_targets_q8)
                    policy.TRAIN_Q8_TARGETS_MIN_BATCH = 1
                    bundle.q8_target_scales = calibrate_vgg_targets_q8(
                        vgg, c, s)
                state = create_train_state(bundle)
                report(label, lambda: train_step(state, vgg, c, s), cols,
                       iters=5, calls=3, card=card, tables=tables)
                del state, bundle
                torch.cuda.empty_cache()
                continue
            bundle = build_model(cfg.replace(compute_dtype=str(dt)[6:]),
                                 "cuda")
            init_torch_default(bundle.model, cfg.seed)
            if sanet:
                bundle.vgg, _ = build_vgg(cfg, "cuda")
            if adain or sanet:
                if args.q8 and dt == torch.bfloat16:
                    scales = bundle.calibrate_q8(c, s)
                    report(f"b{batch} {args.network} q8 B5",
                           lambda: bundle.stylize_q8(c, s, scales), cols,
                           iters=10, calls=3, card=card, tables=tables)
                elif not args.q8:
                    report(f"b{batch} {args.network} standard {str(dt)[6:]}",
                           lambda: bundle.stylize(c, s), cols, iters=10,
                           calls=3, card=card, tables=tables)
                del bundle
                torch.cuda.empty_cache()
                continue
            if args.q8:
                if dt == torch.float32:
                    continue  # q8 serves in bfloat16 around the int8 layers
                scales = bundle.calibrate_q8(c, s)
                for fuse in (False, True):
                    report(f"b{batch} q8 {'B7 pairs' if fuse else 'B4'}",
                           lambda: bundle.stylize_q8(c, s, scales,
                                                     fuse_pairs=fuse),
                           cols, iters=20, calls=5, card=card,
                           tables=tables)
                continue
            w = bundle.folded_weights(dt)
            with torch.inference_mode():
                report(label, lambda: stylize_multi_adain_folded(
                    w, c, s, dtype=dt), cols, iters=20, calls=5, card=card,
                    tables=tables)
    name = ("profile_torch" + ("_train" if args.train else "")
            + ("_q8" if args.q8 else "") + ("_adain" if adain else "")
            + ("_sanet" if sanet else "")
            + ("_q8targets" if args.q8_targets else "") + ".txt")
    out = REPO / "chiprun_out" / name
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(tables))
    print(f"key_averages tables -> {out}")


if __name__ == "__main__":
    main()
