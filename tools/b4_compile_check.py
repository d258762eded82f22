#!/usr/bin/env python
"""Compile B4 (``src/rpst_torch/csrc/folded_conv_q8.cu``) and B7
(``folded_conv2_q8.cu``) on an NVIDIA GPU, print what ptxas says
(registers, shared memory, spills) and their instruction mix
(``cuobjdump -sass``: IMMA, IDP, LDGSTS), run them at the edges of their
tilings with folded and dense kernels (B4 against its plain version: int8
identical, bf16 within one ulp, sums within ``Q8_STATS_*``, the launch's
packing and block table against ``pack_k_major`` / ``block_table``; B7's
six outputs equal to two B4 launches), and time them. The short first call
after a change to the kernels; ``chip_smoke.py`` phase 12 repeats the
checks at the path's shape with bounds beside them.

    python3 tools/b4_compile_check.py [--parent DIR] [--quick]
    python3 tools/b4_compile_check.py --extract REV DIR

``--extract`` writes the B4 / B7 sources of git revision REV
(``folded_conv_q8.cu``, ``folded_conv2_q8.cu`` and their headers) into DIR
and exits; it needs the git checkout, so run it before copying the tree to
the card, into a directory the copy includes (``build/`` is git-ignored and
copied). ``--parent DIR`` builds those sources by hand into a separate
library each and times them in turns with the kernels (parent, kernel,
kernel, parent) through the raw C interface on the same buffers, at (1,
256, 256, 128 -> 128) and (8, 256, 256, 128 -> 128), int8 out with stats and
bf16 out, folded and dense kernels, ten calls back to back per timing; B7
also beside two B4 launches of the kernel. The parents' C interface is the
one before the tensor-core B4 / B7 (no packing scratch: commit
``d1d1656``). ``--variant DIR/folded_conv_q8.cu`` or
``DIR/folded_conv2_q8.cu`` (repeatable) is a changed copy with today's C
interface (its headers beside it in DIR), timed in the same turns.
``--quick`` stops after the comparisons.
"""

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

SOURCES = ("folded_conv_q8.cu", "folded_conv2_q8.cu", "q8_common.cuh",
           "folded_mma.cuh", "mma_common.cuh")


def extract(rev, out):
    """The B4 / B7 sources of ``rev`` into ``out`` (those it has)."""
    out.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        proc = subprocess.run(
            ["git", "show", f"{rev}:src/rpst_torch/csrc/{name}"], cwd=REPO,
            capture_output=True)
        if proc.returncode == 0:
            (out / name).write_bytes(proc.stdout)
            print(f"{rev}:{name} -> {out / name}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--extract", nargs=2, metavar=("REV", "DIR"))
    args = ap.parse_args()
    if args.extract:
        extract(args.extract[0], Path(args.extract[1]))
        return
    run(args)


# B4 (N, H, W, 4C, 4Co) at the edges of its tilings: N = 3 and ragged 8 x
# 16 tiles (W = 33, 37; H = 2), 4C = 16 and 48 (a K step of 32 channels
# spans several input blocks), 4Co = 4 and 16 (the narrow tiling), 64
# (blocked, half of each block's 32 channels), 132 and 260 (contiguous
# channels, two and three channel tiles)
B4_EDGES = [(3, 10, 33, 128, 128), (1, 2, 37, 16, 132), (2, 9, 17, 128, 4),
            (1, 3, 5, 48, 64), (2, 2, 2, 16, 16), (2, 9, 17, 32, 260),
            (1, 17, 37, 64, 128)]
# B7 (N, H, W, 4C, 4Cm, 4Co): each tiling pair, ragged tiles, H or W = 2
B7_EDGES = [(2, 19, 21, 128, 128, 128), (1, 2, 2, 16, 32, 4),
            (1, 9, 33, 32, 16, 8), (3, 10, 37, 16, 48, 128),
            (1, 2, 37, 128, 16, 12), (1, 17, 2, 64, 128, 64)]
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interfaces before the tensor-core kernels (commit d1d1656)
PARENT_B4 = {"rpst_folded_conv_q8": ([_P] * 7 + [_I] * 7 + [_P], _I),
             "rpst_folded_conv_q8_tiles": ([_I, _I], _I)}
PARENT_B7 = {"rpst_folded_conv2_q8": ([_P] * 12 + [_I] * 8 + [_P], _I),
             "rpst_folded_conv2_q8_tiles": ([_I, _I], _I)}


def run(args):
    import numpy as np
    import torch
    from chip_smoke import card
    from kernel_check_common import parent_library, sass_counts
    from rpst_torch.kernels import build
    from rpst_torch.ops import folded_conv_q8 as b4
    from rpst_torch.ops import folded_conv2_q8 as b7

    if not torch.cuda.is_available():
        raise SystemExit("b4_compile_check: no CUDA device")
    dev = torch.device("cuda")
    name_power = card()
    t0 = time.perf_counter()
    libs = ("folded_conv_q8", "folded_conv2_q8")
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        list(pool.map(build.build, libs))
    print(f"built in {time.perf_counter() - t0:.1f} s on {name_power}")
    bad = 0
    for lib in libs:
        build.load(lib)
        print(f"{lib}.cu:")
        print("\n".join(ln for ln in build.build_info[lib]["log"]
                        .splitlines()
                        if "registers" in ln or "spill" in ln
                        or "warning" in ln or "Compiling" in ln))
        sass = sass_counts(lib, ("IMMA", "IDP", "LDGSTS", "LDS"),
                           f"{lib}_kernel")
        print(f"  {lib}_kernel {sass}")
        counts = dict(part.split()[::-1] for part in
                      sass.removeprefix("SASS: ").split(", ")) \
            if sass.startswith("SASS") else {}
        if counts and (int(counts["IMMA"]) == 0 or int(counts["IDP"])):
            print(f"  {lib}: expected IMMA and no IDP")
            bad += 1

    rng = np.random.default_rng(4)
    with torch.inference_mode():
        for shape in B4_EDGES:
            for dense in (False, True):
                bad += check_b4(rng, dev, shape, dense)
        for shape in B7_EDGES:
            for dense in (False, True):
                bad += check_b7(rng, dev, shape, dense)
        if not args.quick:
            bad += timing(rng, dev, name_power, args.parent, args.variant)
    print("launches B4", b4.fused_folded_conv_q8.launches, "B7",
          b7.fused_folded_conv2_q8.launches)
    if bad:
        raise SystemExit(f"b4_compile_check: {bad} checks failed")


def check_b4(rng, dev, shape, dense):
    """B4 in its four modes against plain, and the launch's scratch."""
    import torch
    from chip_smoke import _q8_case, _q8_compare
    from kernel_check_common import check_prep
    from rpst_torch.kernels.build import launch
    from rpst_torch.ops import folded_conv as fc
    from rpst_torch.ops import folded_conv_q8 as b4
    x, k, sc = _q8_case(rng, dev, *shape, dense)
    bad, msg = 0, []
    for out_int8 in (True, False):
        for stats in (False, True):
            got = b4.fused_folded_conv_q8(x, k, sc, out_int8, stats)
            torch.cuda.synchronize()
            ref = b4.fused_folded_conv_q8_plain(x, k, sc, out_int8, stats)
            got, ref = (got, ref) if stats else ((got,), (ref,))
            for i, (gt, r) in enumerate(zip(got, ref)):
                try:
                    msg.append(_q8_compare(f"[{i}]", gt, r)[1])
                except AssertionError as e:
                    print(f"  B4 {shape} out_int8={out_int8} stats={stats} "
                          f"{e}")
                    bad += 1
    # the launch's packing and block table, as the wrapper passes them
    wp, bits = fc._scratch(k)
    n, h, w, c4, c4o = shape
    y = torch.empty((n, h, w, c4o), dtype=torch.int8, device=dev)
    launch("folded_conv_q8", "rpst_folded_conv_q8", "B4", x, k, wp, bits, sc,
           y, None, None, None, n, h, w, c4, c4o, 1, 0)
    torch.cuda.synchronize()
    bad += check_prep(f"B4 {shape}", k, wp, bits)
    listed = int(fc.block_table(k).sum())
    print(f"B4 edge {shape} {'dense' if dense else 'folded'} ({listed} "
          f"blocks): {'ok' if not bad else f'{bad} FAILED'} "
          f"({'; '.join(sorted(set(msg)))})")
    return bad


def check_b7(rng, dev, shape, dense):
    """B7's six outputs torch.equal to two B4 launches, both outputs."""
    import torch
    from chip_smoke import _q8_case
    from rpst_torch.ops import folded_conv2_q8 as b7
    from rpst_torch.ops import folded_conv_q8 as b4
    n, h, w, c4, c4m, c4o = shape
    x, k1, sc1 = _q8_case(rng, dev, n, h, w, c4, c4m, dense)
    _, k2, sc2 = _q8_case(rng, dev, n, h, w, c4m, c4o, dense, 0.02)
    bad = 0
    for out_int8 in (True, False):
        got = b7.fused_folded_conv2_q8(x, k1, sc1, k2, sc2, out_int8, True)
        y1, s11, s12 = b4.fused_folded_conv_q8(x, k1, sc1, True, True)
        y2, s21, s22 = b4.fused_folded_conv_q8(y1, k2, sc2, out_int8, True)
        plain = b7.fused_folded_conv2_q8_plain(x, k1, sc1, k2, sc2,
                                               out_int8)
        no_stats = b7.fused_folded_conv2_q8(x, k1, sc1, k2, sc2, out_int8)
        torch.cuda.synchronize()
        for i, (gt, r) in enumerate(zip(got, (y1, y2, s11, s12, s21, s22))):
            if not torch.equal(gt, r):
                diff = (gt.float() - r.float()).abs()
                print(f"  B7 {shape} out_int8={out_int8} [{i}]: "
                      f"{int((diff > 0).sum())} elements differ from two B4 "
                      f"launches (max {diff.max().item():.3g})")
                bad += 1
        if not (torch.equal(got[0], plain[0]) and torch.equal(
                no_stats[0], plain[0]) and torch.equal(
                no_stats[1], got[1])):
            print(f"  B7 {shape} out_int8={out_int8}: y1 differs from plain "
                  "or the run without stats")
            bad += 1
    print(f"B7 edge {shape} {'dense' if dense else 'folded'}: "
          f"{'six outputs equal to two B4 launches' if not bad else f'{bad} FAILED'}")
    return bad


def kernel_split(fn, reps=20):
    """Device ms per call of each kernel ``fn`` launches (torch.profiler:
    the packing, the main kernel, the sums)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            rows.append((us / reps / 1e3, e.key))
    return "; ".join(f"{name[:48]} {ms:.4f}" for ms, name in sorted(
        rows, reverse=True))


def timing(rng, dev, name_power, parent, variants):
    """B4 and B7 through the raw C interface on the same buffers, in turns
    with the parents and the variants (parent, kernel, variants, variants
    reversed, kernel, parent)."""
    import torch
    from chip_smoke import _q8_case, _q8_compare, q8_bound
    from kernel_check_common import device_ms, parent_library
    from rpst_torch.kernels import build
    from rpst_torch.ops import folded_conv as fc
    from rpst_torch.ops import folded_conv_q8 as b4
    stream = torch.cuda.current_stream().cuda_stream
    new4, new7 = build.load("folded_conv_q8"), build.load("folded_conv2_q8")
    old4 = old7 = None
    if parent:
        old4 = parent_library("folded_conv_q8", parent / "folded_conv_q8.cu",
                              signatures=PARENT_B4)
        old7 = parent_library("folded_conv2_q8",
                              parent / "folded_conv2_q8.cu",
                              signatures=PARENT_B7)
    var = {"folded_conv_q8": [], "folded_conv2_q8": []}
    for i, path in enumerate(variants):
        name = path.stem
        var[name].append((f"variant {path.parent.name}",
                          parent_library(name, path, tag=f"variant{i}")))
    bad = 0
    for n in (1, 8):
        h = w = 256
        c4 = c4o = 128
        tiles = new4.rpst_folded_conv_q8_tiles(h, w)
        f32 = dict(dtype=torch.float32, device=dev)
        for dense in (False, True):
            x, k, sc = _q8_case(rng, dev, n, h, w, c4, c4o, dense)
            _, k2, sc2 = _q8_case(rng, dev, n, h, w, c4o, c4o, dense, 0.02)
            wp, bits = fc._scratch(k)
            wp2 = torch.empty(2 * wp.numel(), dtype=torch.int8, device=dev)
            bits2 = torch.empty(18, dtype=torch.int32, device=dev)
            s = [torch.empty(n, c4o, **f32) for _ in range(4)]
            part = torch.empty(n * tiles * 4 * c4o, **f32)
            y1 = torch.empty(n, h, w, c4o, dtype=torch.int8, device=dev)
            for out_int8 in (True, False):
                stats = int(out_int8)  # int8 + stats, bf16 without
                y = torch.empty(n, h, w, c4o, device=dev, dtype=torch.int8
                                if out_int8 else torch.bfloat16)
                ys = torch.empty_like(y)

                def new_b4(src=x, kk=k, ss=sc, out=y, o8=int(out_int8),
                           lib=new4):
                    err = lib.rpst_folded_conv_q8(
                        src.data_ptr(), kk.data_ptr(), wp.data_ptr(),
                        bits.data_ptr(), ss.data_ptr(), out.data_ptr(),
                        s[0].data_ptr(), s[1].data_ptr(), part.data_ptr(), n,
                        h, w, c4, c4o, o8, stats, stream)
                    assert err == 0, err

                def old_b4():
                    err = old4.rpst_folded_conv_q8(
                        x.data_ptr(), k.data_ptr(), sc.data_ptr(),
                        y.data_ptr(), s[0].data_ptr(), s[1].data_ptr(),
                        part.data_ptr(), n, h, w, c4, c4o, int(out_int8),
                        stats, stream)
                    assert err == 0, err

                def new_b7(lib=new7):
                    err = lib.rpst_folded_conv2_q8(
                        x.data_ptr(), k.data_ptr(), sc.data_ptr(),
                        k2.data_ptr(), sc2.data_ptr(), wp2.data_ptr(),
                        bits2.data_ptr(), y1.data_ptr(), ys.data_ptr(),
                        *[t.data_ptr() for t in s], part.data_ptr(), n, h,
                        w, c4, c4o, c4o, int(out_int8), stats, stream)
                    assert err == 0, err

                def old_b7():
                    err = old7.rpst_folded_conv2_q8(
                        x.data_ptr(), k.data_ptr(), sc.data_ptr(),
                        k2.data_ptr(), sc2.data_ptr(), y1.data_ptr(),
                        ys.data_ptr(), *[t.data_ptr() for t in s],
                        part.data_ptr(), n, h, w, c4, c4o, c4o,
                        int(out_int8), stats, stream)
                    assert err == 0, err

                def two_b4():
                    new_b4(out=y1, o8=1)
                    new_b4(src=y1, kk=k2, ss=sc2, out=ys)

                ref = b4.fused_folded_conv_q8_plain(x, k, sc, out_int8)
                for label, fn in (("kernel", new_b4), ("parent", old_b4)):
                    if label == "parent" and old4 is None:
                        continue
                    fn()
                    torch.cuda.synchronize()
                    try:
                        _q8_compare(f"B4 {label}", y, ref)
                    except AssertionError as e:
                        print(f"  {e}")
                        bad += 1
                fns = {"kernel": new_b4, "parent": old_b4}
                fns.update({lb: (lambda lib=lib: new_b4(lib=lib))
                            for lb, lib in var["folded_conv_q8"]})
                fns7 = {"B7": new_b7, "2xB4": two_b4, "parent": old_b7}
                fns7.update({lb: (lambda lib=lib: new_b7(lib=lib))
                             for lb, lib in var["folded_conv2_q8"]})
                t, t7 = {}, {}
                for times, order in (
                        (t, ["kernel"] + [lb for lb, _ in
                                          var["folded_conv_q8"]]
                         + (["parent"] if old4 else [])),
                        (t7, ["B7", "2xB4"] + [lb for lb, _ in
                                               var["folded_conv2_q8"]]
                         + (["parent"] if old7 else []))):
                    table = fns if times is t else fns7
                    for which in order[::-1] + order:
                        times.setdefault(which, []).append(
                            device_ms(table[which]))
                kind = "int8+stats" if out_int8 else "bf16 out"
                listed = "dense" if dense else "folded"
                bnd = q8_bound(n, h, w, c4, c4o, not dense,
                               1 if out_int8 else 2)
                best = min(t["kernel"])
                fmt = ", ".join
                line = (f"B4 ({n},{h},{w},{c4}->{c4o}) {kind} {listed}: "
                        f"kernel {fmt(f'{v:.4f}' for v in t['kernel'])} ms "
                        f"({100 * bnd[0] / best:.1f}% of the bound "
                        f"{bnd[0]:.4f})")
                for lb, ts in t.items():
                    if lb != "kernel":
                        line += (f"; {lb} {fmt(f'{v:.4f}' for v in ts)} ms "
                                 f"({min(ts) / best:.2f}x)")
                print(line + f" ({name_power})")
                line = (f"B7 ({n},{h},{w},{c4}->{c4o}->{c4o}) {kind} "
                        f"{listed}: pair {fmt(f'{v:.4f}' for v in t7['B7'])}"
                        f" ms vs two B4 "
                        f"{fmt(f'{v:.4f}' for v in t7['2xB4'])} "
                        f"({min(t7['B7']) / min(t7['2xB4']):.2f}x)")
                for lb, ts in t7.items():
                    if lb not in ("B7", "2xB4"):
                        line += (f"; {lb} {fmt(f'{v:.4f}' for v in ts)} ms")
                print(line + f" ({name_power})")
                if out_int8 and not dense:
                    for label, fn in (("B4", new_b4), ("B7", new_b7)):
                        print(f"  {label} ({n},{h},{w},{c4}->{c4o}) by "
                              f"kernel: {kernel_split(fn)}")
            del x, k, sc, k2, sc2, part, y1
            torch.cuda.empty_cache()
    return bad


if __name__ == "__main__":
    main()
