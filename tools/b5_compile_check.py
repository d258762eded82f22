#!/usr/bin/env python
"""Compile B5 (``src/rpst_torch/csrc/conv2d_q8.cu``) alone on an NVIDIA GPU,
print what ptxas says (registers, shared memory, spills) and how many tensor-
core instructions the library holds (``cuobjdump -sass``: IMMA / HMMA), run
the int8 kernel at the edges of its tilings (C = 4, 36, 48; Co = 4, 132; H or
W = 2; W = 37; both pads, both outputs, three slopes) and at every shape the
paths give it, compare each output bit for bit with the plain PyTorch
version, check the bf16 mode, and time the kernel beside ``F.conv2d`` in
bfloat16. The short first call after a change to the kernel;
``chip_smoke.py`` phase 17 repeats the checks with bounds beside them.
``--k7`` checks the 7x7 form instead (int8 and bf16 out, alpha 0.2 and 0,
at H, W = 4, 5, 17, 33, Co off the tile, and at LD v1's two path shapes,
each bit for bit against the plain version and across two runs), prints
its occupancy from ptxas's registers and its shared memory, and times it
raw, through the wrapper and beside ``F.conv2d`` bf16 7x7; chip_smoke.py
phase 44 repeats it.

    python3 tools/b5_compile_check.py [--parent OLD.cu] [--quick] [--k7]

``--parent`` names an earlier version of the source that takes HWIO weights
(its ``q8_common.cuh`` beside it); it is built by hand and timed in turns
with the kernel (parent, kernel, kernel, parent) at every path shape.
``--quick`` stops after the comparisons.
"""

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import (B5_SHAPES, _b5_layer, b5_7x7_checks,  # noqa: E402
                        card, cuda_ms)
from kernel_check_common import parent_library, sass_counts  # noqa: E402
from rpst_torch.kernels import build  # noqa: E402
from rpst_torch.ops import conv2d_q8 as b5  # noqa: E402

# (N, H, W, C, Co): the k tail (C = 4, 36, 48 of 32-channel steps), Co below
# and past a 64 / 128 channel block, the smallest image, ragged 16-wide tiles
EDGES = [(2, 13, 37, 36, 132), (1, 2, 2, 4, 4), (1, 2, 37, 48, 4),
         (2, 9, 2, 4, 132), (1, 8, 16, 48, 64), (1, 5, 17, 36, 68),
         (3, 16, 33, 128, 192)]


def equal(label, got, ref):
    same = torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16
                       else got, ref.view(torch.int16)
                       if ref.dtype == torch.bfloat16 else ref)
    if not same:
        bad = (got.float() != ref.float())
        print(f"  {label}: {int(bad.sum())} of {bad.numel()} differ, first at "
              f"{bad.nonzero()[0].tolist()}")
    return int(not same)


def compare(rng, dev, shape, pads, alphas):
    x, k, sc = _b5_layer(rng, dev, *shape)
    bad = 0
    for pad in pads:
        for alpha in alphas:
            for out_int8 in (True, False):
                got = b5.fused_conv2d_q8(x, k, sc, out_int8, alpha, pad)
                torch.cuda.synchronize()
                ref = b5.fused_conv2d_q8_plain(x, k, sc, out_int8, alpha, pad)
                bad += equal(f"{shape} {pad} alpha={alpha} out_int8="
                             f"{out_int8}", got, ref)
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--k7", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("b5_compile_check: no CUDA device")
    dev = torch.device("cuda")
    name_power = card()
    t0 = time.perf_counter()
    build.load("conv2d_q8")
    print(f"built in {time.perf_counter() - t0:.1f} s on {name_power}")
    print("\n".join(ln for ln in build.build_info["conv2d_q8"]["log"]
                    .splitlines()
                    if "registers" in ln or "spill" in ln or "warning" in ln))
    print(sass_counts("conv2d_q8", ("IMMA", "HMMA", "LDGSTS", "IDP")))
    if args.k7:
        with torch.inference_mode():
            bad, _ = b5_7x7_checks(dev, name_power, timed=not args.quick)
        if bad:
            raise SystemExit(f"b5_compile_check: {bad} 7x7 checks failed")
        return

    rng = np.random.default_rng(5)
    bad = 0
    with torch.inference_mode():
        for shape in EDGES:
            n = compare(rng, dev, shape, ("reflect", "zero"), (0.0, 0.2, 1.0))
            print(f"edge {shape}: {'ok' if not n else f'{n} FAILED'}")
            bad += n
        g = torch.Generator().manual_seed(6)
        for shape in ((2, 9, 19, 40, 72), (1, 2, 2, 8, 8),
                      (2, 128, 128, 256, 256)):
            n, h, w, c, co = shape
            x = torch.randn(n, h, w, c, generator=g).to(dev)
            k = (torch.randn(3, 3, c, co, generator=g) * (9 * c) ** -0.5).to(
                dev)
            b = torch.randn(co, generator=g).to(dev)
            for pad in ("reflect", "zero"):
                got = b5.fused_conv2d_bf16(x, k, b, 0.2, pad).float()
                ref = b5.fused_conv2d_bf16_plain(x, k, b, 0.2, pad).float()
                ok = torch.allclose(got, ref, rtol=2e-2, atol=2e-2)
                print(f"bf16 mode {shape} {pad}: max abs err "
                      f"{(got - ref).abs().max().item():.3g} "
                      f"{'ok' if ok else 'OUT OF TOLERANCE'}")
                bad += int(not ok)
        if args.quick:
            for label, shape, pad in B5_SHAPES[:2]:
                n = compare(rng, dev, shape, (pad,), (0.0,))
                print(f"{label} {shape}: {'ok' if not n else f'{n} FAILED'}")
                bad += n
        else:
            parent = (parent_library("conv2d_q8", args.parent)
                      if args.parent else None)
            this = build.load("conv2d_q8")
            stream = torch.cuda.current_stream().cuda_stream
            for label, shape, pad in B5_SHAPES:
                n_, h, w, c, co = shape
                x, k, sc = _b5_layer(rng, dev, *shape)
                n = compare(rng, dev, shape, (pad,), (0.0,))
                bad += n
                kp = b5.pack_conv2d_weights(k)
                y = torch.empty((n_, h, w, co), device=dev, dtype=torch.int8)

                # both libraries through the same C interface on the same
                # buffers (the wrapper would allocate a new output per call)
                def raw(lib, weights):
                    err = lib.rpst_conv2d_q8(
                        x.data_ptr(), weights.data_ptr(), sc.data_ptr(),
                        y.data_ptr(), n_, h, w, c, co, 1,
                        int(pad == "reflect"), 0.0, stream)
                    assert err == 0, err

                def new():
                    raw(this, kp)

                def old():
                    raw(parent, k)

                times = {}
                order = ("old", "new", "new", "old") if parent else \
                    ("new", "new")
                for which in order:
                    times.setdefault(which, []).append(
                        cuda_ms(old if which == "old" else new, iters=10))
                if parent:
                    old()
                    torch.cuda.synchronize()
                    bad += equal(f"{label} parent vs plain", y,
                                 b5.fused_conv2d_q8_plain(x, k, sc, True, 0.0,
                                                          pad))
                repack = cuda_ms(lambda: b5.fused_conv2d_q8(
                    x, k, sc, True, 0.0, pad), iters=10)
                xd = (x.float() * 0.01).to(torch.bfloat16).permute(0, 3, 1, 2)
                wd = (k.float() * 0.01).to(torch.bfloat16).permute(
                    3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                lib = cuda_ms(lambda: F.conv2d(xd, wd, sc[1].to(
                    torch.bfloat16), padding=1), iters=10)
                ops = 2 * 9 * n_ * h * w * c * co
                best = min(times["new"])
                print(f"{label} {shape} {pad}: {'ok' if not n else 'FAILED'}; "
                      f"kernel {times['new'][0]:.4f}, {times['new'][1]:.4f} ms"
                      f" ({ops / best / 1e9:.0f} TOP/s; repacking per call "
                      f"{repack:.4f})"
                      + (f"; parent {times['old'][0]:.4f}, "
                         f"{times['old'][1]:.4f} ms ("
                         f"{min(times['old']) / best:.2f}x)" if parent else "")
                      + f"; F.conv2d bf16 {lib:.4f} ms ({name_power})")
                del x, k, sc, xd, wd, y
                torch.cuda.empty_cache()
    print("launches", b5.fused_conv2d_q8.launches)
    if bad:
        raise SystemExit(f"b5_compile_check: {bad} checks failed")


if __name__ == "__main__":
    main()
