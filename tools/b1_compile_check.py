#!/usr/bin/env python
"""Compile B1 (``src/rpst_torch/csrc/folded_conv.cu``), B2 and B3 (the two
halves of ``folded_conv_bwd.cu``) on an NVIDIA GPU, print what ptxas says
(registers, shared memory, spills) and the instruction mix of the
tensor-core kernels (``cuobjdump -sass``: HMMA, FFMA, LDGSTS; B1 / B2's
``folded_mma_kernel``, B3's ``grad_weight_mma``), run the kernels at the
edges of their tilings against the plain versions (B1 and B2 with folded
and dense kernels, B3 dense and listed, on aligned and unaligned inputs),
in both types, and time them. The short first call after a change to the
kernels; ``chip_smoke.py`` phase 2 repeats the checks with bounds beside
them.

    python3 tools/b1_compile_check.py [--parent OLD.cu] [--parent-bwd
        OLD_BWD.cu] [--parent-b3 OLD_BWD.cu] [--quick | --b3-only]

``--parent`` / ``--parent-bwd`` name earlier versions of ``folded_conv.cu``
/ ``folded_conv_bwd.cu`` with the C interface before the tensor-core B1 and
B2 (HWIO weights, no block table: ``git show e61f459:<path>``);
``--parent-b3`` a ``folded_conv_bwd.cu`` with the CUDA-core B3 (a rings
argument, no work list: ``git show d224cea:<path>``); their headers beside
them. Each is built by hand and timed in turns with the kernel (parent,
kernel, kernel, parent) through the raw C interface on the same buffers, at
(1, 256, 256, 128 -> 128) and (1, 128, 128, 512 -> 512), both types, folded
and dense kernels (B3: dense and listed modes beside the parent's dense
B3), ten calls back to back per timing (device time, not launch
latency). ``--variant DIR/folded_conv.cu`` or ``DIR/folded_conv_bwd.cu``
(repeatable) is a changed copy with today's C
interface (its headers beside it in DIR), timed and checked in the same
turns. B3's wrapper is then timed on the host, whole and by parts
(``host_b3``). ``--quick`` stops after the comparisons.
"""

import argparse
import ctypes
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import torch  # noqa: E402

from chip_smoke import (BF16_TOL, DK_ATOL_512, F32_TOL, card,  # noqa: E402
                        check_close, folded_bound)
from kernel_check_common import parent_library, sass_counts  # noqa: E402
from rpst_torch.kernels import build  # noqa: E402
from rpst_torch.ops import folded_conv as fc  # noqa: E402
from rpst_torch.ops.folded import (_row_ring, fold_bias,  # noqa: E402
                                   fold_conv_kernel)

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
# B3 on the CUDA cores (up to PR 9's d224cea): x, rings, gz, dk, db,
# dk_part, db_part, N, H, W, C4, C4o, seg_len, stream
PARENT_B3 = {f"rpst_folded_conv_grad_weight_{s}": ([_P] * 7 + [_I] * 6 + [_P],
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


def ring_rows(x_f):
    """The reflect ring rows (N, 2, W, 4C) the parents' interfaces take: row
    0 above x_f, row 1 below."""
    return torch.cat([_row_ring(x_f, True), _row_ring(x_f, False)], dim=1)


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


def check_b3(shape, xd, gd):
    """B3 dense and listed against plain (rtol 1e-4, atol DK_ATOL_512
    sqrt(N H W / 512)), also on unaligned copies of x and gz (the element
    by element staging): (failures, max abs err)."""
    n, h, w = shape[:3]
    atol = DK_ATOL_512 * (n * h * w / 512) ** 0.5
    bad, worst = 0, 0.0
    for listed in (False, True):
        ref = fc.fused_folded_conv_grad_weight_plain(xd, gd, listed)
        for how, args in (("aligned", (xd, gd)),
                          ("unaligned", (offset_copy(xd, 2),
                                         offset_copy(gd, 2)))):
            got = fc.fused_folded_conv_grad_weight(*args, listed)
            torch.cuda.synchronize()
            for name, a, r in zip(("dk", "db"), got, ref):
                err = (a - r).abs().max().item()
                worst = max(worst, err)
                if not (torch.isfinite(a).all()
                        and torch.allclose(a, r, rtol=1e-4, atol=atol)):
                    print(f"  B3 {shape} {'listed' if listed else 'dense'} "
                          f"{how} {name}: max abs err {err} (atol {atol:.3g})")
                    bad += 1
    return bad, worst


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
                    # B3 reads no kernel: its two modes once a shape, and
                    # with x and gz off 16-byte alignment
                    e3 = float("nan")
                    if not dense:
                        n_bad, e3 = check_b3(shape, xd, gd)
                        bad += n_bad
                    print(f"edge {shape} {'dense' if dense else 'folded'} "
                          f"{str(dt)[6:]}: max abs err B1 "
                          f"{max(errs[:4]):.3g}, B2 {errs[4]:.3g}, B3 "
                          f"{e3:.3g}")
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
                        rings = ring_rows(xd).data_ptr() if old else None
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


def parent_b3_segment(n, h, w, c4, c4o):
    """The parent's segment length (its wrapper's ``_b3_segment``: 128-wide
    tiles, 16 for a 12-wide side, 4 blocks per SM, 32-position chunks)."""
    def cdiv(a, b):
        return -(-a // b)
    tiles = cdiv(c4, 16 if c4 <= 16 else 128) \
        * cdiv(c4o, 16 if c4o <= 16 else 128) * 9
    p = n * h * w
    s = max(1, min(cdiv(4 * 132, tiles), cdiv(p, 256)))
    return cdiv(cdiv(p, s), 32) * 32


def timing_b3(dev, name_power, libs):
    """B3 through the raw C interface on the same buffers, dense and
    listed, in turns with ``libs`` [(label, library, old C interface?)],
    the kernel's first: the parent (dense only; its ring rows built once,
    outside the timing) runs beside both modes. Each output is held to
    plain."""
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(9)
    bad = 0
    for n, h, w, c4, c4o in ((1, 256, 256, 128, 128),
                             (1, 128, 128, 512, 512)):
        x = torch.randn(n, h, w, c4, generator=g).to(dev)
        gz = torch.randn(n, h, w, c4o, generator=g).to(dev)
        p = n * h * w
        atol = DK_ATOL_512 * (p / 512) ** 0.5
        for dt in (torch.float32, torch.bfloat16):
            sfx = "f32" if dt == torch.float32 else "bf16"
            size = 4 if dt == torch.float32 else 2
            xd, gd = x.to(dt), gz.to(dt)
            rings = ring_rows(xd)
            fn = f"rpst_folded_conv_grad_weight_{sfx}"
            for listed in (False, True):
                ref = fc.fused_folded_conv_grad_weight_plain(xd, gd, listed)
                items = fc._b3_items_on(c4, c4o, listed, dev)
                seg = fc.b3_segment(p, items.shape[0],
                                    fc.B3_CHUNK[xd.element_size()])
                pseg = parent_b3_segment(n, h, w, c4, c4o)
                f32 = dict(dtype=torch.float32, device=dev)
                dk = torch.empty(3, 3, c4, c4o, **f32)
                db = torch.empty(c4o, **f32)
                part = (torch.empty(-(-p // seg), items.shape[0] * fc.B3_TILE,
                                    **f32), torch.empty(-(-p // seg), c4o,
                                                        **f32))
                ppart = (torch.empty(-(-p // pseg), 9 * c4 * c4o, **f32),
                         torch.empty(-(-p // pseg), c4o, **f32))

                def call(lib, old):
                    if old:
                        err = getattr(lib, fn)(
                            xd.data_ptr(), rings.data_ptr(), gd.data_ptr(),
                            dk.data_ptr(), db.data_ptr(), ppart[0].data_ptr(),
                            ppart[1].data_ptr(), n, h, w, c4, c4o, pseg,
                            stream)
                    else:
                        if listed:  # as the wrapper's torch.zeros
                            dk.zero_()
                        err = getattr(lib, fn)(
                            xd.data_ptr(), gd.data_ptr(), items.data_ptr(),
                            dk.data_ptr(), db.data_ptr(), part[0].data_ptr(),
                            part[1].data_ptr(), items.shape[0], n, h, w, c4,
                            c4o, seg, stream)
                    assert err == 0, err

                errs = {}
                for label, lib, old in libs:
                    call(lib, old)
                    torch.cuda.synchronize()
                    # the parent is dense: held to the dense plain version
                    want = ref if not old else \
                        fc.fused_folded_conv_grad_weight_plain(xd, gd)
                    errs[label] = max((dk - want[0]).abs().max().item(),
                                      (db - want[1]).abs().max().item())
                    if not (torch.allclose(dk, want[0], rtol=1e-4, atol=atol)
                            and torch.allclose(db, want[1], rtol=1e-4,
                                               atol=atol)):
                        print(f"  B3 {label} {sfx} listed={listed}: max abs "
                              f"err {errs[label]} (atol {atol:.3g})")
                        bad += 1
                order = libs[1:] + libs[:1] + libs[:1] + libs[:0:-1]
                times = {}
                for label, lib, old in order:
                    times.setdefault(label, []).append(device_ms(
                        lambda: call(lib, old)))
                best = min(times["kernel"])
                bnd = folded_bound(n, h, w, c4, c4o, sfx, size, listed)[0]
                others = "".join(
                    f"; {label} " + ", ".join(f"{t:.4f}" for t in ts)
                    + f" ms ({min(ts) / best:.2f}x, max abs err "
                    f"{errs[label]:.3g})"
                    for label, ts in times.items() if label != "kernel")
                print(f"B3 ({n},{h},{w},{c4}->{c4o}) {sfx} "
                      f"{'listed' if listed else 'dense'}: kernel "
                      + ", ".join(f"{t:.4f}" for t in times["kernel"])
                      + f" ms ({100 * bnd / best:.1f}% of the bound "
                      f"{bnd:.4f}; {items.shape[0]} items x "
                      f"{-(-p // seg)} segments; max abs err "
                      f"{errs['kernel']:.3g}){others} ({name_power})")
            del xd, gd, rings
            torch.cuda.empty_cache()
    return bad


def host_b3(dev, name_power, calls=100, iters=5):
    """Host ms per call of B3's wrapper and of its parts at (1, 256, 256,
    128 -> 128), the training path's width: ``calls`` calls back to back with
    no synchronisation (the card's queue takes the launches, so the host's
    own time is read), median of ``iters``. The parts: the wrapper with its
    launch stubbed out (checks, work list lookup, allocations), the
    allocations alone, ``_launch`` alone (``build.launch``: library lookup,
    device context, stream, ctypes) and the bare ctypes call (ints ready;
    cudaFuncSetAttribute and the kernels' launches)."""
    g = torch.Generator().manual_seed(11)
    n, h, w, c4, c4o = 1, 256, 256, 128, 128
    p = n * h * w
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.load("folded_conv_bwd")

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
            torch.cuda.synchronize()
        return sorted(times)[iters // 2]

    for dt in (torch.float32, torch.bfloat16):
        sfx = "f32" if dt == torch.float32 else "bf16"
        x = torch.randn(n, h, w, c4, generator=g).to(dev, dt)
        gz = torch.randn(n, h, w, c4o, generator=g).to(dev, dt)
        for listed in (False, True):
            items = fc._b3_items_on(c4, c4o, listed, dev)
            seg = fc.b3_segment(p, items.shape[0],
                                fc.B3_CHUNK[x.element_size()])
            segs = -(-p // seg)
            f32 = dict(dtype=torch.float32, device=dev)
            dk = torch.zeros(3, 3, c4, c4o, **f32)
            db = torch.empty(c4o, **f32)
            part = (torch.empty(segs, items.shape[0] * fc.B3_TILE, **f32),
                    torch.empty(segs, c4o, **f32)) if segs > 1 \
                else (None, None)
            fn = f"rpst_folded_conv_grad_weight_{sfx}"
            args = (x, gz, items, dk, db, *part, items.shape[0], n, h, w, c4,
                    c4o, seg)
            ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in args]
            cfn = getattr(lib, fn)

            def allocs():
                (torch.zeros if listed else torch.empty)(3, 3, c4, c4o, **f32)
                torch.empty(c4o, **f32)
                if segs > 1:
                    torch.empty(segs, items.shape[0] * fc.B3_TILE, **f32)
                    torch.empty(segs, c4o, **f32)

            whole = host_ms(
                lambda: fc.fused_folded_conv_grad_weight(x, gz, listed))
            with mock.patch.object(fc, "_launch", lambda *a: None):
                stub = host_ms(
                    lambda: fc.fused_folded_conv_grad_weight(x, gz, listed))
            alloc = host_ms(allocs)
            launch = host_ms(lambda: fc._launch(fn, "B3", *args))
            raw = host_ms(lambda: cfn(*ptrs, stream))
            print(f"B3 host ms per call ({n},{h},{w},{c4}->{c4o}) {sfx} "
                  f"{'listed' if listed else 'dense'}: wrapper {whole:.4f}; "
                  f"wrapper without its launch {stub:.4f} (of which "
                  f"allocations {alloc:.4f}); _launch {launch:.4f} (of which "
                  f"bare ctypes call {raw:.4f}); {segs} segments "
                  f"({name_power})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--parent-bwd", type=Path, default=None)
    ap.add_argument("--parent-b3", type=Path, default=None)
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--b3-only", action="store_true",
                    help="time B3 only (B1 and B2 are still checked)")
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
        if lib == "folded_conv_bwd":
            print("  B3 grad_weight_mma "
                  + sass_counts(lib, ("HMMA", "FFMA", "LDGSTS", "LDSM"),
                                "grad_weight_mma"))
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
        if not args.b3_only:
            bad += timing(dev, name_power, libs)
        b3 = [("kernel", libs["B2"][0][1], False)]
        if args.parent_b3:
            b3.append(("parent", parent_library(
                "folded_conv_bwd", args.parent_b3, tag="parent_b3",
                signatures=PARENT_B3), True))
        # B3 lives in folded_conv_bwd.cu: its variants are B2's
        b3 += [c for c in libs["B2"][1:] if c[0].startswith("variant")]
        bad += timing_b3(dev, name_power, b3)
        host_b3(dev, name_power)
    print("launches B1", fc.fused_folded_conv.launches, "B2",
          fc.fused_folded_conv_grad_input.launches, "B3",
          fc.fused_folded_conv_grad_weight.launches)
    if bad:
        raise SystemExit(f"b1_compile_check: {bad} checks failed")


if __name__ == "__main__":
    main()
