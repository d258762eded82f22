#!/usr/bin/env python
"""Compile B1 (``src/rpst_torch/csrc/folded_conv.cu``) and B2 (the
``folded_conv_bwd.cu`` half that includes ``folded_mma.cuh``) on an NVIDIA
GPU, print what ptxas says (registers, shared memory, spills) and the
instruction mix of the tensor-core kernel in both libraries (``cuobjdump
-sass``: HMMA, FFMA, LDGSTS), run both kernels at the edges of their tilings
with folded and dense kernels in both types against the plain versions, and
time them. The short first call after a change to the kernels;
``chip_smoke.py`` phase 2 repeats the checks with bounds beside them.

    python3 tools/b1_compile_check.py [--parent OLD.cu] [--parent-bwd
        OLD_BWD.cu] [--quick]

``--parent`` / ``--parent-bwd`` name earlier versions of ``folded_conv.cu``
/ ``folded_conv_bwd.cu`` with the C interface before the tensor-core kernels
(HWIO weights, no block table; their headers beside them). Each is built by
hand and timed in turns with the kernel (parent, kernel, kernel, parent)
through the raw C interface on the same buffers, at (1, 256, 256, 128 ->
128) and (1, 128, 128, 512 -> 512), both types, folded and dense kernels,
ten calls back to back per timing (device time, not launch latency).
``--variant DIR/folded_conv.cu`` or ``DIR/folded_conv_bwd.cu``
(repeatable) is a changed copy with today's C interface (its headers beside
it in DIR), timed and checked in the same turns. ``--quick`` stops after
the comparisons.
"""

import argparse
import ctypes
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import torch  # noqa: E402

from chip_smoke import (BF16_TOL, F32_TOL, card, check_close,  # noqa: E402
                        folded_bound)
from kernel_check_common import parent_library, sass_counts  # noqa: E402
from rpst_torch.kernels import build  # noqa: E402
from rpst_torch.ops import folded_conv as fc  # noqa: E402
from rpst_torch.ops.folded import fold_bias, fold_conv_kernel  # noqa: E402

# (N, Hf, Wf, C, Co) of a folded layer (4C -> 4Co channels): the 12-wide
# image sides (K steps across the four blocks; the narrow tiling), Co = 5
# (the wide dense tiling) and Co = 8 (blocked, 3 of 4 n-tiles past Co), two
# channel tiles, ragged 8 x 16 tiles with rows / columns H-2, H-1 in two
# tiles, the smallest foldable image
EDGES = [(2, 38, 22, 3, 32), (2, 9, 17, 32, 3), (1, 3, 5, 4, 5),
         (1, 10, 18, 16, 8), (1, 2, 3, 2, 64), (1, 9, 17, 32, 32),
         (2, 2, 2, 32, 32), (2, 2, 2, 3, 3), (1, 17, 33, 128, 128)]
# the C interface before the tensor-core kernels (PR 8's e61f459): HWIO
# weights and no block table
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_B1 = {f"rpst_folded_conv_{s}": ([_P] * 5 + [_I] * 5 + [_F, _P], _I)
             for s in ("f32", "bf16")}
PARENT_B2 = {f"rpst_folded_conv_grad_input_{s}": ([_P] * 3 + [_I] * 5 + [_P],
                                                  _I)
             for s in ("f32", "bf16")}


def layer(g, n, h, w, c, co, dense, dev):
    """x, gz, a folded (or dense) kernel, its khat and the folded bias."""
    x = torch.randn(n, h, w, 4 * c, generator=g)
    gz = torch.randn(n, h, w, 4 * co, generator=g)
    k = fold_conv_kernel(torch.randn(3, 3, c, co, generator=g)
                         * (9 * c) ** -0.5)
    if dense:
        k = torch.randn(3, 3, 4 * c, 4 * co, generator=g) * (36 * c) ** -0.5
    b = fold_bias(torch.randn(co, generator=g) * 0.1)
    khat = k.flip(0, 1).transpose(2, 3).contiguous()
    return [t.to(dev) for t in (x, gz, k.contiguous(), khat, b)]


def offset_copy(t, elems):
    """``t`` copied into a buffer ``elems`` elements in: contiguous, with a
    data pointer off 16-byte alignment for elems * size % 16 != 0."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


def device_ms(fn, reps=10, iters=5):
    """Median ms of one ``fn()`` over ``iters`` timings of ``reps`` calls
    back to back between two CUDA events, so that the card, not the host's
    launch latency, sets the time (``chip_smoke.cuda_ms`` times one call from
    an idle card)."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[iters // 2]


def compare(label, got, ref, dt):
    try:
        err, _ = check_close(label, got, ref,
                             F32_TOL if dt == torch.float32 else BF16_TOL)
        return 0, err
    except AssertionError as e:
        print(f"  {e}")
        return 1, float("nan")


def check_prep(op, k, packed, bits):
    """The launch's packing and block table against pack_k_major and
    block_table: 1 if either differs."""
    table = torch.stack([(bits.cpu() >> i) & 1 for i in range(16)], -1)
    ok = (torch.equal(packed, fc.pack_k_major(k).flatten())
          and torch.equal(table.view(3, 3, 4, 4).to(torch.uint8),
                          fc.block_table(k).cpu()))
    if not ok:
        print(f"  {op}: the launch's packed weights or block table differ "
              "from pack_k_major / block_table")
    return int(not ok)


def edges(dev):
    g = torch.Generator().manual_seed(7)
    bad = 0
    with torch.inference_mode():
        for shape in EDGES:
            for dense in (False, True):
                x, gz, k, khat, b = layer(g, *shape, dense, dev)
                rings = torch.rand(x.shape[0], 2, x.shape[2], x.shape[3],
                                   generator=None, device=dev)
                for dt in (torch.float32, torch.bfloat16):
                    xd, gd, kd, hd, bd = (t.to(dt) for t in (x, gz, k, khat,
                                                             b))
                    rd = rings.to(dt)
                    errs = []
                    for alpha in (0.2, 0.0):
                        y = fc.fused_folded_conv(xd, kd, bd, alpha)
                        torch.cuda.synchronize()
                        ref = fc.fused_folded_conv_plain(
                            xd.float(), kd.float(), bd.float(), alpha)
                        n_bad, e = compare(f"B1 {shape} {alpha}", y,
                                           ref.to(dt), dt)
                        bad += n_bad
                        errs.append(e)
                    y = fc.fused_folded_conv(xd, kd, bd, 0.2, rd)
                    ref = fc.fused_folded_conv_plain(
                        xd.float(), kd.float(), bd.float(), 0.2, rd.float())
                    n_bad, e = compare(f"B1 {shape} rings", y, ref.to(dt), dt)
                    bad += n_bad
                    errs.append(e)
                    # x off 16-byte alignment: the element-by-element loads
                    y = fc.fused_folded_conv(offset_copy(xd, 2), kd, bd, 0.2)
                    ref = fc.fused_folded_conv_plain(xd.float(), kd.float(),
                                                     bd.float(), 0.2)
                    n_bad, e = compare(f"B1 {shape} unaligned", y,
                                       ref.to(dt), dt)
                    bad += n_bad
                    errs.append(e)
                    dx = fc.fused_folded_conv_grad_input(gd, hd)
                    torch.cuda.synchronize()
                    n_bad, e = compare(
                        f"B2 {shape}", dx,
                        fc.fused_folded_conv_grad_input_plain(
                            gd.float(), hd.float()).to(dt), dt)
                    bad += n_bad
                    errs.append(e)
                    print(f"edge {shape} {'dense' if dense else 'folded'} "
                          f"{str(dt)[6:]}: max abs err B1 "
                          f"{max(errs[:4]):.3g}, B2 {errs[4]:.3g}")
    return bad


def timing(dev, name_power, libs):
    """B1 and B2 through the raw C interface (weights packed once) on the
    same buffers. ``libs`` maps "B1" / "B2" to [(label, library, old C
    interface?)], the kernel's first; they run in turns, forward then
    back (parent, kernel, kernel, parent), each output held to plain."""
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(8)
    bad = 0
    for n, h, w, c4, c4o in ((1, 256, 256, 128, 128),
                             (1, 128, 128, 512, 512)):
        for dense in (False, True):
            x, gz, k, khat, b = layer(g, n, h, w, c4 // 4, c4o // 4, dense,
                                      dev)
            for dt in (torch.float32, torch.bfloat16):
                sfx = "f32" if dt == torch.float32 else "bf16"
                size = 4 if dt == torch.float32 else 2
                xd, gd, kd, hd, bd = (t.to(dt) for t in (x, gz, k, khat, b))
                scratch = {"B1": fc._scratch(kd), "B2": fc._scratch(hd)}
                out = {"B1": torch.empty(n, h, w, c4o, dtype=dt, device=dev),
                       "B2": torch.empty(n, h, w, c4, dtype=dt, device=dev)}
                ref = {"B1": fc.fused_folded_conv_plain(xd, kd, bd, 0.2),
                       "B2": fc.fused_folded_conv_grad_input_plain(gd, hd)}

                def call(op, lib, old):
                    y = out[op].data_ptr()
                    w_args = [(kd if op == "B1" else hd).data_ptr()]
                    if not old:  # the launch's packing and table scratch
                        w_args += [t.data_ptr() for t in scratch[op]]
                    if op == "B1":
                        # the old interface takes the ring rows, this
                        # one reads them from x (rings null)
                        rings = fc._ring_rows(xd).data_ptr() if old else None
                        err = getattr(lib, f"rpst_folded_conv_{sfx}")(
                            xd.data_ptr(), rings, *w_args,
                            bd.data_ptr(), y, n, h, w, c4, c4o, 0.2, stream)
                    else:
                        err = getattr(lib,
                                      f"rpst_folded_conv_grad_input_{sfx}")(
                            gd.data_ptr(), *w_args, y, n, h, w, c4o, c4,
                            stream)
                    assert err == 0, err

                bounds = [folded_bound(n, h, w, c4, c4o, sfx, size, s)[0]
                          for s in (False, True)]
                listed = bounds[0] if dense else bounds[1]
                for op, comps in libs.items():
                    errs = {}
                    for label, lib, old in comps:
                        call(op, lib, old)
                        torch.cuda.synchronize()
                        n_bad, errs[label] = compare(f"{op} {label}",
                                                     out[op], ref[op], dt)
                        bad += n_bad
                        if label == "kernel":
                            bad += check_prep(op, kd if op == "B1" else hd,
                                              *scratch[op])
                    order = comps[1:] + comps[:1] + comps[:1] + comps[:0:-1]
                    times = {}
                    for label, lib, old in order:
                        times.setdefault(label, []).append(device_ms(
                            lambda: call(op, lib, old)))
                    best = min(times["kernel"])
                    others = "".join(
                        f"; {label} " + ", ".join(f"{t:.4f}" for t in ts)
                        + f" ms ({min(ts) / best:.2f}x, max abs err "
                        f"{errs[label]:.3g})"
                        for label, ts in times.items() if label != "kernel")
                    print(f"{op} ({n},{h},{w},{c4}->{c4o}) {sfx} "
                          f"{'dense' if dense else 'folded'}: kernel "
                          + ", ".join(f"{t:.4f}" for t in times["kernel"])
                          + f" ms ({100 * listed / best:.1f}% of the listed "
                          f"blocks' bound {listed:.4f}; max abs err "
                          f"{errs['kernel']:.3g}){others} ({name_power})")
                del xd, gd, kd, hd, bd, scratch, out, ref
                torch.cuda.empty_cache()
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--parent-bwd", type=Path, default=None)
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("b1_compile_check: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # the plain convs in full f32
    dev = torch.device("cuda")
    name_power = card()
    t0 = time.perf_counter()
    libs = ("folded_conv", "folded_conv_bwd")
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        list(pool.map(build.build, libs))
    print(f"built in {time.perf_counter() - t0:.1f} s on {name_power}")
    for lib in libs:
        build.load(lib)
        print(f"{lib}.cu:")
        print("\n".join(ln for ln in build.build_info[lib]["log"]
                        .splitlines()
                        if "registers" in ln or "spill" in ln
                        or "warning" in ln or "Compiling" in ln))
        print("  folded_mma_kernel "
              + sass_counts(lib, ("HMMA", "FFMA", "LDGSTS", "LDS"),
                            "folded_mma_kernel"))
        print("  whole library " + sass_counts(lib, ("HMMA", "FFMA")))
    bad = edges(dev)
    if not args.quick:
        libs = {"B1": [("kernel", build.load("folded_conv"), False)],
                "B2": [("kernel", build.load("folded_conv_bwd"), False)]}
        if args.parent:
            libs["B1"].append(("parent", parent_library(
                "folded_conv", args.parent, signatures=PARENT_B1), True))
        if args.parent_bwd:
            libs["B2"].append(("parent", parent_library(
                "folded_conv_bwd", args.parent_bwd, signatures=PARENT_B2),
                True))
        for i, path in enumerate(args.variant):
            name = "folded_conv_bwd" if path.name == "folded_conv_bwd.cu" \
                else "folded_conv"
            libs["B2" if name == "folded_conv_bwd" else "B1"].append(
                (f"variant {path.parent.name}", parent_library(
                    name, path, tag=f"variant{i}"), False))
        bad += timing(dev, name_power, libs)
    print("launches B1", fc.fused_folded_conv.launches, "B2",
          fc.fused_folded_conv_grad_input.launches)
    if bad:
        raise SystemExit(f"b1_compile_check: {bad} checks failed")


if __name__ == "__main__":
    main()
