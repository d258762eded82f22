#!/usr/bin/env python
"""Compile B6 (``src/rpst_torch/csrc/flash_attention.cu``) alone on an NVIDIA
GPU, print what ptxas says (registers, shared memory, spills), run the four
kernels (forward, forward + LSE, dQ, dK/dV) in float32 and bfloat16 at small
ragged shapes, with inputs x 30, and at the shapes a 512px SANet stylize
gives them, compare each output with its plain PyTorch version, run dK/dV
twice for bit-equal results, and time kernel and plain version. The short
first call after a change to the kernel; ``chip_smoke.py`` phase 23 repeats
the checks with bounds and the library call beside them.

    python3 tools/b6_compile_check.py [--min-blocks 1|2] [--quick]
                                      [--parent OLD.cu]

The backward kernels B6c and B6d are built for 1 and for 2 blocks per SM
(255 or 128 registers a thread) and each launch picks by its block count;
``--min-blocks`` forces one of the two for every launch
(``-DB6_MIN_BLOCKS``), to compare them (both forward kernels are built for
one block per SM). ``--quick`` stops after the comparisons at the small
shapes, one path shape and the two x 30 cases. ``--parent`` names an earlier
version of the source (or a variant of it) with the same C interface; after
the checks it is built by hand, its float32 O is read at the ragged and
relu5_1 shapes, x 1 and x 30, under the limits below (a reading, not a
check), and each of its kernels is timed in turns with this one's (parent,
kernel, kernel, parent) at the path shapes and the float32 forward's tile
edges, both through the raw C interface on the same buffers; with
``--quick`` at (1, 4096, 4096, 512) only. The tensor-core instructions of
each forward kernel are counted with ``cuobjdump -sass`` (HMMA: bf16 in
``flash_fwd_mma_kernel``, TF32 in ``flash_fwd_tf32_kernel``).

The float32 forward's O is held to its plain version (1e-4), and at inputs
x 1 also to its own size, at x 30 to a float64 oracle computed on the card
from the same inputs: the limits of ``rpst_torch.ops.flash_attention``
(``F32_O_REL``, ``F32_O_MEAN_REL``, ``f32_oracle_limit``), which say why.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kernel_check_common import parent_library, sass_counts  # noqa: E402
from rpst_torch.kernels import build  # noqa: E402
from rpst_torch.ops import flash_attention as fa  # noqa: E402

# (N, Nq, Nk, C): ragged and tiny ones, then relu5_1 and relu4_1 at 512px
SMALL = [(2, 20, 12, 128), (1, 1, 1, 128), (3, 33, 130, 256),
         (1, 160, 97, 512), (2, 64, 64, 384)]
# the bfloat16 forward's tiles are 32 query rows x 64 keys, the float32
# forward's 32 x 32: one below, at and one above each, at every width, N = 3
FWD_EDGES = [(3, nq, nk, c) for c in (128, 256, 384)
             for nq, nk in ((31, 63), (32, 64), (33, 65))] + \
    [(3, 33, 127, 512), (3, 64, 129, 512)]
FWD_EDGES_F32 = [(3, nq, nk, c) for c in (128, 256, 384, 512)
                 for nq, nk in fa.F32_FWD_EDGES]
PATH = [(1, 1024, 1024, 512), (1, 4096, 4096, 512), (4, 1024, 1024, 512),
        (4, 4096, 4096, 512)]
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# the bfloat16 forward's O (an average over Nk keys, far below O(1)) is also
# held to its own size: max and mean abs err as shares of max |ref|
BF16_O_REL, BF16_O_MEAN_REL = 2e-2, 2e-3


def inputs(seed, dev, dtype, n, nq, nk, c, scale=1.0):
    rng = np.random.default_rng(seed)
    # unit-norm-ish rows: logits of order `scale`^2, as mean-variance
    # normalized features through a 1x1 conv give
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * scale / c ** 0.25).to(dev).to(dtype)
    return t(n, nq, c), t(n, nk, c), t(n, nk, c), t(n, nq, c)


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


def scaled_errors(got, ref):
    """(max, mean) abs err as shares of max |ref|."""
    err, size = (got.float() - ref.float()).abs(), ref.float().abs().max()
    return (err.max() / size).item(), (err.mean() / size).item()


def check(label, got, ref, dtype, scale=1.0, ref64=None):
    """``got`` against the plain version ``ref`` (the forward's float32 O at
    x 30: against the float64 oracle ``ref64`` by ``f32_oracle_limit``);
    returns 1 if out of tolerance."""
    rtol, atol = TOL[dtype]
    got, ref = got.float(), ref.float()
    err, size = (got - ref).abs(), ref.abs().max().item()
    finite = bool(torch.isfinite(got).all())
    extra = ""
    if label.endswith(" o") and dtype == torch.float32 and scale != 1.0:
        e_k = (got.double() - ref64).abs().max().item()
        e_p = (ref.double() - ref64).abs().max().item()
        limit = fa.f32_oracle_limit(ref, ref64)
        ok = finite and e_k <= limit
        extra = (f", vs float64 oracle {e_k:.3g} against plain's {e_p:.3g} "
                 f"({e_k / e_p:.2f}x), limit {limit:.3g}")
    else:
        ok = finite and torch.allclose(got, ref, rtol=rtol, atol=atol)
    if label.endswith(" o") and scale == 1.0:
        lim = {torch.float32: (fa.F32_O_REL, fa.F32_O_MEAN_REL),
               torch.bfloat16: (BF16_O_REL, BF16_O_MEAN_REL)}[dtype]
        rel, mean_rel = scaled_errors(got, ref)
        ok = ok and rel <= lim[0] and mean_rel <= lim[1]
        extra = f", of max |ref|: max {rel:.3g}, mean {mean_rel:.3g}"
    print(f"  {label}: max abs err {err.max().item():.3g} (max |ref| "
          f"{size:.3g}{extra}) {'ok' if ok else 'OUT OF TOLERANCE'}")
    return int(not ok)


def fwd_case(shape, dtype):
    """The forward kernels alone against their plain version."""
    dev = torch.device("cuda")
    q, k, v, _ = inputs(sum(shape), dev, dtype, *shape)
    o = fa.flash_fwd(q, k, v)
    o2, lse = fa.flash_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_fwd_lse_plain(q, k, v)
    print(f"{shape} {str(dtype)[6:]} forward")
    return (check("B6a o", o, ro, dtype) + check("B6b o", o2, ro, dtype)
            + check("B6b lse", lse, rlse, torch.float32)
            + int(not torch.equal(o, o2)))


def parent_readings(parent):
    """``parent_reading`` at the ragged and relu5_1 shapes, x 1 and x 30."""
    for shape, scale in (((2, 100, 70, 512), 1.0), ((1, 1024, 1024, 512), 1.0),
                         ((2, 100, 70, 512), 30.0),
                         ((1, 1024, 1024, 512), 30.0)):
        parent_reading(parent, shape, scale)


def parent_reading(parent, shape, scale):
    """The float32 O of the parent's and of this source's B6a under the
    limits above, both through the raw C interface."""
    dev = torch.device("cuda")
    q, k, v, _ = inputs(sum(shape), dev, torch.float32, *shape, scale=scale)
    ro = fa.flash_fwd_lse_plain(q, k, v)[0]
    ref64 = fa.attention_f64(q, k, v) if scale != 1.0 else None
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in (("parent", parent),
                      ("kernel", build.load("flash_attention"))):
        o = torch.empty_like(q)
        err = lib.rpst_flash_fwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), None, *shape, stream)
        assert err == 0, err
        torch.cuda.synchronize()
        print(f"{shape} f32 x{scale:g} {name}")
        check("B6a o", o, ro, torch.float32, scale, ref64)


def parent_turns(parent, shape, dtype, keys=("B6a", "B6b", "B6c", "B6d")):
    """ms of the kernels ``keys``, parent and this source in turns."""
    dev = torch.device("cuda")
    q, k, v, d_o = inputs(sum(shape), dev, dtype, *shape)
    o, lse = fa.flash_fwd_lse(q, k, v)
    delta = (d_o.float() * o.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    n, nq, nk, c = shape
    entry = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [t.data_ptr() for t in (q, k, v, d_o, lse, delta)]

    def call(lib, fn, *args):
        err = getattr(lib, f"rpst_flash_{fn}_{entry}")(*args, n, nq, nk, c,
                                                        stream)
        assert err == 0, err

    # both libraries through the same C interface on the same buffers (the
    # wrappers would allocate a new output per call)
    calls = {"B6a": ("fwd", *ptr[:3], o.data_ptr(), None),
             "B6b": ("fwd", *ptr[:3], o.data_ptr(), lse.data_ptr()),
             "B6c": ("bwd_dq", *ptr, dq.data_ptr()),
             "B6d": ("bwd_dkv", *ptr, dk.data_ptr(), dv.data_ptr())}
    this = build.load("flash_attention")
    pairs = {key: (lambda a=args: call(parent, *a),
                   lambda a=args: call(this, *a))
             for key, args in calls.items()}
    for key in keys:
        old, new = pairs[key]
        t = [ms(old), ms(new), ms(new), ms(old)]
        print(f"  {shape} {entry} {key}: parent {t[0]:.4f}, {t[3]:.4f} ms; "
              f"kernel {t[1]:.4f}, {t[2]:.4f} ms "
              f"({min(t[0], t[3]) / min(t[1], t[2]):.2f}x)")
    if "B6c" in keys:
        import torch.nn.functional as F
        sd = ms(lambda: F.scaled_dot_product_attention(
            q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1), scale=1.0))
        print(f"  {shape} {entry} SDPA forward {sd:.4f} ms")


def run_case(shape, dtype, scale, timed):
    dev = torch.device("cuda")
    q, k, v, d_o = inputs(sum(shape), dev, dtype, *shape, scale=scale)
    print(f"{shape} {str(dtype)[6:]} x{scale}")
    bad = 0
    o = fa.flash_fwd(q, k, v)
    o2, lse = fa.flash_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_fwd_lse_plain(q, k, v)
    ref64 = fa.attention_f64(q, k, v) if scale != 1.0 else None
    bad += check("B6a o", o, ro, dtype, scale, ref64)
    bad += check("B6b o", o2, ro, dtype, scale, ref64)
    bad += check("B6b lse", lse, rlse, torch.float32)
    delta = (d_o.float() * ro.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, d_o, rlse, delta)
    dk, dv = fa.flash_bwd_dkv(q, k, v, d_o, rlse, delta)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, d_o, rlse, delta)
    torch.cuda.synchronize()
    bad += check("B6c dq", dq, fa.flash_bwd_dq_plain(q, k, v, d_o, rlse,
                                                     delta), dtype)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, d_o, rlse, delta)
    bad += check("B6d dk", dk, rdk, dtype)
    bad += check("B6d dv", dv, rdv, dtype)
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        bad += 1
        print("  B6d NOT deterministic across two runs")
    if timed:
        t = {"B6a": ms(lambda: fa.flash_fwd(q, k, v)),
             "B6b": ms(lambda: fa.flash_fwd_lse(q, k, v)),
             "B6c": ms(lambda: fa.flash_bwd_dq(q, k, v, d_o, rlse, delta)),
             "B6d": ms(lambda: fa.flash_bwd_dkv(q, k, v, d_o, rlse, delta)),
             "plain fwd": ms(lambda: fa.flash_fwd_lse_plain(q, k, v), 2),
             "plain dq": ms(lambda: fa.flash_bwd_dq_plain(q, k, v, d_o, rlse,
                                                          delta), 2),
             "plain dkv": ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, d_o,
                                                            rlse, delta), 2)}
        print("  ms: " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in t.items()))
    del q, k, v, d_o
    torch.cuda.empty_cache()
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--min-blocks", type=int, choices=(1, 2), default=None)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("b6_compile_check: no CUDA device")
    if args.min_blocks is not None:
        build.NVCC_FLAGS.append(f"-DB6_MIN_BLOCKS={args.min_blocks}")
    t0 = time.perf_counter()
    build.load("flash_attention")
    print(f"built in {time.perf_counter() - t0:.1f} s "
          f"(min blocks {args.min_blocks or 'per launch'})")
    print("\n".join(ln for ln in build.build_info["flash_attention"]["log"]
                    .splitlines()
                    if "registers" in ln or "spill" in ln or "warning" in ln))
    print(sass_counts("flash_attention", ("HMMA", "LDSM", "LDGSTS")))
    for kernel in ("flash_fwd_tf32_kernel", "flash_fwd_mma_kernel"):
        print(f"{kernel}: " + sass_counts("flash_attention", ("HMMA", "LDS.128",
                                                              "LDGSTS"), kernel))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    bad = 0
    for shape in FWD_EDGES:
        bad += fwd_case(shape, torch.bfloat16)
    for shape in FWD_EDGES_F32:
        bad += fwd_case(shape, torch.float32)
    for shape in SMALL:
        for dtype in (torch.float32, torch.bfloat16):
            bad += run_case(shape, dtype, 1.0, False)
    bad += run_case((2, 100, 70, 512), torch.bfloat16, 1.0, False)
    bad += run_case((2, 100, 70, 512), torch.float32, 30.0, False)
    bad += run_case((1, 1024, 1024, 512), torch.float32, 30.0, False)
    if args.quick:
        bad += run_case(PATH[1], torch.bfloat16, 1.0, True)
        bad += run_case(PATH[1], torch.float32, 1.0, False)
    else:
        for shape in PATH:
            for dtype in (torch.float32, torch.bfloat16):
                bad += run_case(shape, dtype, 1.0, True)
    if args.parent is not None:
        parent = parent_library("flash_attention", args.parent)
        parent_readings(parent)
        for shape in PATH[1:2] if args.quick else PATH:
            for dtype in (torch.float32, torch.bfloat16):
                parent_turns(parent, shape, dtype)
        for shape in [] if args.quick else FWD_EDGES_F32[::4]:
            parent_turns(parent, shape, torch.float32, ("B6a", "B6b"))
    print("launches", fa.launch_counts())
    if bad:
        raise SystemExit(f"b6_compile_check: {bad} checks failed")


if __name__ == "__main__":
    main()
