#!/usr/bin/env python
"""Compile B6 (``src/rpst_torch/csrc/flash_attention.cu``) alone on an NVIDIA
GPU, print what ptxas says (registers, shared memory, spills), run the four
kernels (forward, forward + LSE, dQ, dK/dV) in float32 and bfloat16 at small
ragged shapes, with inputs x 30, and at the shapes a 512px SANet stylize
gives them, compare each output with its plain PyTorch version, run dK/dV
twice for bit-equal results, and time kernel and plain version. The short
first call after a change to the kernel; ``chip_smoke.py`` phase 23 repeats
the checks with bounds and the library call beside them.

    python3 tools/b6_compile_check.py [--min-blocks 1|2] [--parent OLD.cu]
                                      [--quick]

The float32 forward and the backward kernels are built for 1 and for 2
blocks per SM (255 or 128 registers a thread) and each launch picks by its
block count; ``--min-blocks`` forces one of the two for every launch
(``-DB6_MIN_BLOCKS``), to compare them. ``--parent`` names an earlier
version of the source with the same C interface; it is built by hand and
each of its kernels is timed in turns with this one's (parent, kernel,
kernel, parent) at the path shapes. ``--quick`` stops after the comparisons
at the small shapes and one path shape. The library's tensor-core
instructions are counted with ``cuobjdump -sass`` (HMMA).
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
# the bfloat16 forward's tiles are 32 query rows x 64 keys: one below, at and
# one above each, at every width, N = 3
FWD_EDGES = [(3, nq, nk, c) for c in (128, 256, 384)
             for nq, nk in ((31, 63), (32, 64), (33, 65))] + \
    [(3, 33, 127, 512), (3, 64, 129, 512)]
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


def check(label, got, ref, dtype):
    rtol, atol = TOL[dtype]
    got, ref = got.float(), ref.float()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, ref, rtol=rtol,
                                                            atol=atol)
    err, size = (got - ref).abs(), ref.abs().max().item()
    scaled = ""
    if dtype == torch.bfloat16 and label.endswith(" o"):
        rel, mean_rel = err.max().item() / size, err.mean().item() / size
        ok = ok and rel <= BF16_O_REL and mean_rel <= BF16_O_MEAN_REL
        scaled = f", of max |ref|: max {rel:.3g}, mean {mean_rel:.3g}"
    print(f"  {label}: max abs err {err.max().item():.3g} (max |ref| "
          f"{size:.3g}{scaled}) {'ok' if ok else 'OUT OF TOLERANCE'}")
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


def parent_turns(parent, shape, dtype):
    """ms of every kernel, parent and this source in turns."""
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
    for key, (old, new) in pairs.items():
        t = [ms(old), ms(new), ms(new), ms(old)]
        print(f"  {shape} {entry} {key}: parent {t[0]:.4f}, {t[3]:.4f} ms; "
              f"kernel {t[1]:.4f}, {t[2]:.4f} ms "
              f"({min(t[0], t[3]) / min(t[1], t[2]):.2f}x)")
    if dtype == torch.bfloat16:
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
    bad += check("B6a o", o, ro, dtype)
    bad += check("B6b o", o2, ro, dtype)
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    bad = 0
    for shape in FWD_EDGES:
        bad += fwd_case(shape, torch.bfloat16)
    for shape in SMALL:
        for dtype in (torch.float32, torch.bfloat16):
            bad += run_case(shape, dtype, 1.0, False)
    bad += run_case((2, 100, 70, 512), torch.bfloat16, 1.0, False)
    if args.quick:
        bad += run_case(PATH[1], torch.bfloat16, 1.0, True)
    else:
        bad += run_case((2, 100, 70, 512), torch.float32, 30.0, False)
        bad += run_case((1, 1024, 1024, 512), torch.float32, 30.0, False)
        for shape in PATH:
            for dtype in (torch.float32, torch.bfloat16):
                bad += run_case(shape, dtype, 1.0, True)
        if args.parent is not None:
            parent = parent_library("flash_attention", args.parent)
            for shape in PATH:
                for dtype in (torch.float32, torch.bfloat16):
                    parent_turns(parent, shape, dtype)
    print("launches", fa.launch_counts())
    if bad:
        raise SystemExit(f"b6_compile_check: {bad} checks failed")


if __name__ == "__main__":
    main()
