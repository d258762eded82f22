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

``--k7`` checks the 7x7 form (``csrc/conv2d_q8_7x7.cu``) instead: its ptxas
lines and SASS counts (GMMA: ``wgmma``; the 3x3 instances' IMMA counts of
``conv2d_q8.cu`` beside them), a one-line L2 bandwidth probe (a sum and a
copy over buffers that stay in the 50 MB L2), then ``chip_smoke.py``'s
phase-44 checks (int8 and bf16 out, alpha 0.2 and 0, at the tile edges and
at LD v1's path shapes, each bit for bit against the plain version and
across two runs; occupancy; the bytes its tiling stages from L2; times raw,
through the wrapper and beside ``F.conv2d`` bf16 7x7). With ``--parent
OLD.cu`` (the 3x3 source of a revision whose 7x7 form was the
``mma.sync`` instance in it, K-major (7, 7, steps, Co, 32) weights: ``git
show 56c9483:src/rpst_torch/csrc/conv2d_q8.cu``) and ``--variant NEW.cu``
(a changed copy of ``conv2d_q8_7x7.cu``, repeatable; headers beside each),
every library is called through the same C interface on the same buffers
at LD v1's two shapes at N = 2 and 8, each output compared bit for bit with
the kernel's, and timed in turns (parent, variants, kernel, kernel,
variants reversed, parent), with the SASS counts of each; with
``--parent``, LD v1's q8 stylize at 512px b1 and b4 is also timed with the
parent's 7x7 form in place of the kernel (parent, kernel, kernel, parent)
and the two outputs compared.

    python3 tools/b5_compile_check.py [--parent OLD.cu] [--quick] [--k7]
        [--variant NEW.cu ...]
    python3 tools/b5_compile_check.py --extract REV DIR

``--parent`` without ``--k7`` names an earlier version of the source that
takes HWIO weights (its ``q8_common.cuh`` beside it); it is built by hand
and timed in turns with the kernel (parent, kernel, kernel, parent) at
every path shape. ``--quick`` stops after the comparisons. ``--extract``
writes ``conv2d_q8.cu`` and the headers of git revision REV into DIR and
exits; it needs the git checkout, so run it before the tree goes to the
card, into a directory the copy includes (``build/`` is git-ignored and
copied).
"""

import argparse
import subprocess
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

from chip_smoke import (B5_7X7_SHAPES, B5_SHAPES, _b5_layer,  # noqa: E402
                        _b5_layer7, b5_7x7_checks, bound_ms, card, cuda_ms)
from kernel_check_common import (device_ms, parent_library,  # noqa: E402
                                 sass_counts)
from rpst_torch.kernels import build  # noqa: E402
from rpst_torch.ops import conv2d_q8 as b5  # noqa: E402
from rpst_torch.ops.folded_conv import pack_k_major  # noqa: E402

SOURCES = ("conv2d_q8.cu", "mma_common.cuh", "q8_common.cuh")

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


def extract(rev, out):
    """B5's source and headers of git revision ``rev`` into ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        proc = subprocess.run(
            ["git", "show", f"{rev}:src/rpst_torch/csrc/{name}"], cwd=REPO,
            capture_output=True, check=True)
        (out / name).write_bytes(proc.stdout)
        print(f"{rev}:{name} -> {out / name}")


def l2_probe():
    """TB/s of a sum over 24 MB and of a 12 MB -> 12 MB copy, each buffer
    resident in the 50 MB L2 after a warm-up (100 calls back to back)."""
    a = torch.ones(24 << 20, dtype=torch.int8, device="cuda")
    src, dst = a[:12 << 20], torch.empty(12 << 20, dtype=torch.int8,
                                         device="cuda")
    f32 = a.view(torch.float32)
    t_sum = device_ms(lambda: f32.sum(), reps=100)
    t_copy = device_ms(lambda: dst.copy_(src), reps=100)
    return (f"L2 probe: sum over 24 MB {24 * 2 ** 20 / t_sum / 1e9:.2f} TB/s "
            f"read; copy 12 MB -> 12 MB {2 * 12 * 2 ** 20 / t_copy / 1e9:.2f} "
            "TB/s read + written")


def k7_ab(parent, variants, dev, name_power):
    """Every library through rpst_conv2d_q8_7x7 at LD v1's shapes, in
    turns; returns the checks that failed and the libraries by name."""
    sig = {"rpst_conv2d_q8_7x7":
           build.SIGNATURES["conv2d_q8_7x7"]["rpst_conv2d_q8_7x7"]}
    libs = {"kernel": build.load("conv2d_q8_7x7")}
    others = []
    if parent:
        libs["parent"] = parent_library("conv2d_q8", parent, signatures=sig)
        print("parent", sass_of(build.BUILD_DIR / "parent_conv2d_q8.so"))
        others.append("parent")
    for v in variants:
        libs[v.stem] = parent_library("conv2d_q8_7x7", v,
                                      tag=f"variant_{v.stem}", signatures=sig)
        print(v.stem, sass_of(build.BUILD_DIR
                              / f"variant_{v.stem}_conv2d_q8_7x7.so"))
        others.append(v.stem)
    order = others + ["kernel", "kernel"] + others[::-1]
    rng = np.random.default_rng(16)
    stream = torch.cuda.current_stream().cuda_stream
    bad = 0
    for label, shape in B5_7X7_SHAPES:
        n, h, w, c, co = shape
        x, k, sc = _b5_layer7(rng, dev, *shape)
        new = b5.pack_conv2d_weights(k)
        ys, times = {}, {}
        for name, lib in libs.items():
            wp = pack_k_major(k) if name == "parent" else new
            y = torch.empty((n, h, w, co), device=dev, dtype=torch.int8)

            def call(lib=lib, wp=wp, y=y):
                err = lib.rpst_conv2d_q8_7x7(
                    x.data_ptr(), wp.data_ptr(), sc.data_ptr(), y.data_ptr(),
                    n, h, w, c, co, 1, 0.2, stream)
                assert err == 0, err
            ys[name] = (call, y)
        for name in order:
            times.setdefault(name, []).append(
                device_ms(ys[name][0], reps=5, iters=3))
        torch.cuda.synchronize()
        for name in others:
            bad += equal(f"{label} {name} vs kernel", ys[name][1],
                         ys["kernel"][1])
        ops = 2 * 49 * n * h * w * c * co
        b_ms, _ = bound_ms(ops, n * h * w * (c + co) + 49 * c * co
                           + 3 * co * 4, "int8")
        best = min(times["kernel"])
        print(f"{label} {shape}: kernel " + ", ".join(
            f"{t:.4f}" for t in times["kernel"]) + f" ms ({100 * b_ms / best:.1f}"
            f"% of the {b_ms:.4f} ms bound)" + "".join(
                f"; {name} " + ", ".join(f"{t:.4f}" for t in times[name])
                + f" ms ({100 * b_ms / min(times[name]):.1f}%, kernel "
                f"{min(times[name]) / best:.2f}x faster)" for name in others)
            + f"; {name_power}", flush=True)
        del x, k, sc, new, ys
        torch.cuda.empty_cache()
    return bad, libs


def ld_path_ab(old_lib, dev, name_power):
    """LD v1's q8 stylize at 512px b1 and b4 (the yaml's widths, phase 48's
    setting) with the parent's 7x7 form in place of the kernel, in turns
    (parent, kernel, kernel, parent); the 3x3 B5 launches are the kernel's
    in both."""
    from chip_smoke import IMG, _ld_bundle
    launch, old_packed = build.launch, {}

    def parent_launch(name, fn, what, x, wp, *rest):
        if fn != "rpst_conv2d_q8_7x7":
            return launch(name, fn, what, x, wp, *rest)
        if wp.data_ptr() not in old_packed:  # HWIO back, then K-major
            c, co = x.shape[3], rest[-3]
            hwio = wp.permute(0, 1, 2, 4, 6, 3, 5).reshape(
                7, 7, wp.shape[2] * 32, wp.shape[3] * 8)[:, :, :c, :co]
            old_packed[wp.data_ptr()] = pack_k_major(hwio.contiguous())
        stream = torch.cuda.current_stream().cuda_stream
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in (x, old_packed[wp.data_ptr()], *rest)]
        err = old_lib.rpst_conv2d_q8_7x7(*args, stream)
        if err:
            raise RuntimeError(f"parent 7x7 launch failed: {err}")

    rng = np.random.default_rng(48)
    for batch in (1, 4):
        c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).to(dev)
                for _ in range(2))
        bundle = _ld_bundle(dev, "ld_adain", IMG, compute_dtype="bfloat16")
        scales = bundle.calibrate_q8(c, s)
        outs, times = {}, {}
        for which in ("parent", "kernel", "kernel", "parent"):
            build.launch = parent_launch if which == "parent" else launch
            try:
                times.setdefault(which, []).append(cuda_ms(
                    lambda: bundle.stylize_q8(c, s, scales), iters=3,
                    warmup=1))
                outs[which] = bundle.stylize_q8(c, s, scales)
            finally:
                build.launch = launch
        same = torch.equal(outs["parent"], outs["kernel"])
        print(f"LD v1 q8 stylize 512px b{batch}: kernel " + ", ".join(
            f"{t:.3f}" for t in times["kernel"]) + " ms; parent's 7x7 "
            + ", ".join(f"{t:.3f}" for t in times["parent"]) + " ms "
            f"(outputs {'equal' if same else 'DIFFER'}; {name_power})",
            flush=True)
        del bundle, c, s
        torch.cuda.empty_cache()
    return int(not same)


def sass_of(lib_path):
    """SASS counts of a library: wgmma (GMMA) in all, IMMA of the 3x3 and
    7x7 instances of ``conv2d_mma_kernel`` where it has them."""
    return "; ".join([
        sass_counts("", ("GMMA", "IMMA", "UBLKCP", "LDGSTS"), lib=lib_path),
        "3x3 " + sass_counts("", ("IMMA", "HMMA"), "conv2d_mma_kernelILi3E",
                             lib=lib_path),
        "7x7 " + sass_counts("", ("IMMA",), "conv2d_mma_kernelILi7E",
                             lib=lib_path)])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--k7", action="store_true")
    ap.add_argument("--extract", nargs=2, metavar=("REV", "DIR"))
    args = ap.parse_args()
    if args.extract:
        extract(args.extract[0], Path(args.extract[1]))
        return
    if not torch.cuda.is_available():
        raise SystemExit("b5_compile_check: no CUDA device")
    dev = torch.device("cuda")
    name_power = card()
    t0 = time.perf_counter()
    build.load("conv2d_q8")
    if args.k7:
        build.load("conv2d_q8_7x7")
    print(f"built in {time.perf_counter() - t0:.1f} s on {name_power}")
    for lib in ("conv2d_q8", "conv2d_q8_7x7") if args.k7 else ("conv2d_q8",):
        print("\n".join(ln for ln in build.build_info[lib]["log"]
                        .splitlines() if "registers" in ln or "spill" in ln
                        or "warning" in ln))
    print("conv2d_q8:", sass_of(build.build("conv2d_q8")))
    if args.k7:
        print("conv2d_q8_7x7:", sass_of(build.build("conv2d_q8_7x7")))
        print(l2_probe(), f"({name_power})", flush=True)
        with torch.inference_mode():
            bad, _ = b5_7x7_checks(dev, name_power, timed=not args.quick)
            if not args.quick and (args.parent or args.variant):
                n_bad, libs = k7_ab(args.parent, args.variant, dev,
                                    name_power)
                bad += n_bad
                if args.parent:
                    bad += ld_path_ab(libs["parent"], dev, name_power)
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
