#!/usr/bin/env python
"""Where the device time goes in the port's folded stylize: profiles the
flagship (multi_adain, constant stack, rp_blocks 5, hidden 32) at 512px with
seeded weights, b1 and b8, float32 and bfloat16, on one CUDA device.

For each case it prints one Markdown table row:

  | batch, type | ms per call | B1 share | other kernels by share | idle share |

  ms per call   median of 20 CUDA-event-timed calls after 3 warm-ups,
                without the profiler
  B1 share      device time of the B1 kernel (folded_conv_kernel) over all
                device time, in the profiled calls
  other         the three next kernels by device time, names shortened
  idle share    1 - (union of device activity) / (first start .. last end)
                over 5 profiled calls after 3 warm-ups

It also writes each case's ``key_averages()`` table to
``chiprun_out/profile_torch.txt``. The card's name and power limit come
first, as nvidia-smi gives them.

    python3 profile_torch.py
"""

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
from rpst_torch.models import build_model
from rpst_torch.models.fast_path import stylize_multi_adain_folded
from rpst_torch.nn.blocks import init_torch_default

FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=5,
                hidden_dim=32, inception_num=0, attention="none", seed=0,
                exec_strategy="folded")
IMG, CALLS = 512, 5
B1_KERNEL = "folded_conv_kernel"
OUT = REPO / "chiprun_out" / "profile_torch.txt"


def short_name(name: str) -> str:
    """'void at::native::reduce_kernel<512, 1, ...>(...)' -> 'reduce_kernel'."""
    name = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
    name = name.split("<")[0].split("(")[0]
    return name.rsplit("::", 1)[-1].strip()


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


def device_breakdown(fn):
    """(device time by short kernel name, idle share, key_averages
    table) over CALLS profiled calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    cfg = load_config(dict(FLAGSHIP, img_size=IMG))
    bundle = build_model(cfg, "cuda")
    init_torch_default(bundle.model, cfg.seed)
    rng = np.random.default_rng(0)
    tables = []
    print("| batch, type | ms per call | B1 share | other kernels by share "
          "| idle share |")
    print("| --- | --- | --- | --- | --- |")
    with torch.inference_mode():
        for batch in (1, 8):
            c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                np.float32)).cuda()
                    for _ in range(2))
            for dt in (torch.float32, torch.bfloat16):
                w = bundle.folded_weights(dt)

                def fn():
                    return stylize_multi_adain_folded(w, c, s, dtype=dt)

                ms = cuda_ms(fn)
                by_name, idle, table = device_breakdown(fn)
                total = sum(by_name.values())
                b1 = sum(v for k, v in by_name.items() if B1_KERNEL in k)
                others = sorted(((v, k) for k, v in by_name.items()
                                 if B1_KERNEL not in k), reverse=True)[:3]
                label = f"b{batch} {str(dt)[6:]}"
                print(f"| {label} | {ms:.3f} | {100 * b1 / total:.1f}% | "
                      + ", ".join(f"{k} {100 * v / total:.1f}%"
                                  for v, k in others)
                      + f" | {100 * idle:.1f}% |", flush=True)
                tables.append(f"=== {label} ({card})\n{table}")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(tables))
    print(f"key_averages tables -> {OUT}")


if __name__ == "__main__":
    main()
