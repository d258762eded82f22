#!/usr/bin/env python
"""Compile B5 (``src/rpst_torch/csrc/conv2d_q8.cu``) alone on an NVIDIA
GPU, print what ptxas says (registers, shared memory, spills), run both of
its modes once at small odd shapes and at every shape the adain / wct
stylize and the int8 VGG targets give it, compare each output with the
plain PyTorch version bit for bit, and time kernel and plain version. The
short first call after a change to the kernel; ``chip_smoke.py`` phase 17
repeats the checks with bounds and the library call beside them.

    python3 tools/b5_compile_check.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rpst_torch.kernels import build  # noqa: E402
from rpst_torch.ops.conv2d_q8 import (fused_conv2d_bf16,  # noqa: E402
                                      fused_conv2d_bf16_plain,
                                      fused_conv2d_q8, fused_conv2d_q8_plain)

PATH_SHAPES = [((2, 512, 512, 128, 256), "zero"),
               ((2, 512, 512, 256, 512), "zero"),
               ((2, 512, 512, 512, 256), "zero"),
               ((2, 512, 512, 256, 128), "zero"),
               ((2, 256, 256, 128, 128), "reflect"),
               ((2, 128, 128, 128, 256), "reflect"),
               ((2, 128, 128, 256, 256), "reflect"),
               ((2, 64, 64, 256, 512), "reflect")]


def layer(seed, dev, n, h, w, c, co):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c, co), dtype=np.int8)
    sc = np.stack([rng.uniform(2e-6, 6e-6, co), rng.normal(0, 0.2, co),
                   rng.uniform(10, 40, co)]).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, k, sc)]


def ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bits(t):
    return t if t.dtype == torch.int8 else t.view(torch.int16)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("b5_compile_check: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load("conv2d_q8")
    print(f"built in {time.perf_counter() - t0:.1f} s")
    print("\n".join(ln for ln in build.build_info["conv2d_q8"]["log"]
                    .splitlines() if "registers" in ln or "spill" in ln))
    bad = 0
    for shape in [(2, 13, 37, 128, 128), (1, 2, 2, 4, 4),
                  (2, 9, 19, 36, 260)]:
        x, k, sc = layer(0, dev, *shape)
        for alpha in (0.0, 0.2, 1.0):
            for pad in ("reflect", "zero"):
                for out_int8 in (True, False):
                    got = fused_conv2d_q8(x, k, sc, out_int8, alpha, pad)
                    torch.cuda.synchronize()
                    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, alpha,
                                                pad)
                    if not torch.equal(bits(got), bits(ref)):
                        bad += 1
                        print("MISMATCH", shape, alpha, pad, out_int8,
                              (got != ref).sum().item())
    print(f"small shapes done, {bad} mismatches")
    for shape, pad in PATH_SHAPES:
        x, k, sc = layer(1, dev, *shape)
        for out_int8 in (True, False):
            got = fused_conv2d_q8(x, k, sc, out_int8, 0.0, pad)
            torch.cuda.synchronize()
            ref = fused_conv2d_q8_plain(x, k, sc, out_int8, 0.0, pad)
            diff = (bits(got) != bits(ref)).sum().item()
            bad += int(diff > 0)
            print(shape, pad, "out_int8" if out_int8 else "out_bf16",
                  f"{diff} elements differ; "
                  f"{ms(lambda: fused_conv2d_q8(x, k, sc, out_int8, 0.0, pad)):.4f} ms"
                  f" vs plain "
                  f"{ms(lambda: fused_conv2d_q8_plain(x, k, sc, out_int8, 0.0, pad), 2):.4f}")
            del got, ref
            torch.cuda.empty_cache()
    for pad in ("reflect", "zero"):
        for shape in [(2, 128, 128, 256, 256), (2, 9, 19, 40, 72)]:
            g = torch.Generator().manual_seed(0)
            n, h, w, c, co = shape
            x = torch.randn(n, h, w, c, generator=g).to(dev)
            k = (torch.randn(3, 3, c, co, generator=g) * (9 * c) ** -0.5).to(
                dev)
            b = torch.randn(co, generator=g).to(dev)
            for alpha in (0.0, 0.2, 1.0):
                got = fused_conv2d_bf16(x, k, b, alpha, pad)
                torch.cuda.synchronize()
                ref = fused_conv2d_bf16_plain(x, k, b, alpha, pad)
                ok = torch.allclose(got.float(), ref.float(), rtol=2e-2,
                                    atol=2e-2)
                bad += int(not ok)
                print("bf16 mode", shape, pad, alpha, "max abs err",
                      (got.float() - ref.float()).abs().max().item(),
                      "ok" if ok else "OUT OF TOLERANCE 2e-2")
            print("bf16 mode", shape, pad,
                  f"{ms(lambda: fused_conv2d_bf16(x, k, b, 0.0, pad)):.4f} ms "
                  f"vs plain "
                  f"{ms(lambda: fused_conv2d_bf16_plain(x, k, b, 0.0, pad)):.4f}")
    print("launches", fused_conv2d_q8.launches, fused_conv2d_bf16.launches)
    if bad:
        raise SystemExit(f"b5_compile_check: {bad} checks failed")


if __name__ == "__main__":
    main()
