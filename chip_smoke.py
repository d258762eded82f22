#!/usr/bin/env python
"""Quickest proof that the PyTorch/CUDA port runs on the GPU: builds the
port's CUDA kernels from this checkout, checks each against its plain
PyTorch version, drives the flagship's folded and int8 serving and training
paths, adain's and wct's serving and the static SANet's serving and training
at 512px through the user's entry points, and times them. Needs one NVIDIA
Hopper card; run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own line; any failed check raises, exit code != 0):
  1. build     nvcc-build every kernel of the paths, one nvcc per source, all
               at once (B1 folded_conv.cu; B2, B3 folded_conv_bwd.cu; B4
               folded_conv_q8.cu; B7 folded_conv2_q8.cu; B5 conv2d_q8.cu; B6
               flash_attention.cu)
  2. kernels   B1, B2, B3 vs their plain versions at the paths' shapes, f32 +
               bf16, B1 and B2 with folded (36 of 144 blocks non-zero) and
               dense kernels; B1 and B2 timed at (1,256,256,128->128) and
               (1,128,128,512->512), both types and both kernel kinds,
               beside plain, the library call on the folded layout
               (F.conv2d on the ring-padded tensor; conv2d_input), the
               unfolded conv the standard path runs (reflect pad + F.conv2d
               on (N, C, 2H, 2W); conv2d_input) and the dense and
               structured bounds; B3 dense and listed (the fold's 36
               blocks) at every case, each bit-equal across two runs, the
               listed one's unfolded-kernel gradient equal to the dense
               one's, and timed in both modes beside plain, conv2d_weight
               on the ring-padded folded tensor and on the reflect-padded
               unfolded image, and the dense and structured bounds
  3. fixture   folded stylize on the card vs rpst's JAX output
               (tests/fixtures/torch_port_flagship.npz)
  4. parity    512px: folded (B1) vs the port's standard path; bf16 vs f32;
               launches == folded conv layers run
  5. serve     the serving main path: 8 requests through build_model ->
               resolve_mode -> make_run_impl -> DynamicBatcher, launch
               counts reset before and read after; then serve_torch.py's
               folder sweep as a subprocess
  6. daemon    serve_torch.py --daemon: 6 requests + stats + shutdown
  7. timing    512px stylize b1/b8, f32/bf16: folded B1 and standard in
               both orders (folded, standard, folded plain, standard,
               folded), with CUDA events
  8. train fixture  the folded train step on the card (B1/B2/B3) vs rpst's
               JAX loss, gradients and 3-step trajectory
               (tests/fixtures/torch_port_train.npz)
  9. train parity   512px b2 f32: loss and gradients of the kernel path vs
               the plain path (autograd through B1's plain version) and vs
               exec_strategy standard; bf16 vs f32 gradient cosines
 10. train     the training main path: train_torch.py on a synthetic 512px
               corpus (b4, f32, folded), 3 steps as a subprocess, then a
               resume for 2 more in this process with the counts reset
               before and read after; exact B1/B2/B3 launches per step
 11. train timing  the 512px train step, b1/b4, f32/bf16: folded with the
               B-kernels, folded plain, standard, with CUDA events
 12. q8 kernels    B4 vs its plain version at the path's shape (1,256,256,
               128->128), a ragged one and the tilings' edges (N = 3; W =
               33, 37; H = 2; 4C = 16; 4Co = 4, 132), each with a quantized
               fold (36 listed blocks) and a dense kernel, all four
               (out_int8, with_stats) modes: int8 identical, bf16 within one
               ulp, s1/s2 within rtol 1e-4 / atol 1e-3; B7's six outputs
               (float32 sums included) equal to two B4 launches; each timed
               against its plain version, folded and dense, beside B1 bf16
               at the same shape
 13. q8 fixture    the q8 stylize on the card with rpst's act scales vs
               rpst's JAX output (tests/fixtures/torch_port_q8.npz), f32 and
               bf16, exact B1/B4 (and B1/B4/B7 with fuse_pairs) launches
 14. q8 parity     512px b2: q8 vs the port's folded f32 path (PSNR > 30
               dB); fuse_pairs bit-equal to unfused
 15. q8 serve      the int8 main path: 8 requests through build_model ->
               resolve_mode("q8") -> calibrate_scales -> make_run_impl ->
               DynamicBatcher, counts reset before and read after, once
               unfused (B1 + B4) and once with fuse_pairs (B1 + B4 + B7);
               then serve_torch.py --mode q8 as a subprocess
 16. q8 timing     512px stylize b1/b8 in bfloat16: q8 with B4, q8 with B7
               pairs, folded B1 and standard, in both orders (the policy's
               A/B), beside phase 7's rows

 17. B5 kernels    B5 vs its plain version (float64 conv: exact integer
               sums) at every shape the adain / wct stylize and the int8 VGG
               targets give it (the 512px ones at 2N = 2), int8 and bf16 out:
               int8 identical, bf16 within one ulp compared numerically (the
               -0.0 of alpha = 0 equals +0.0; the bits are compared too and
               reported); alpha {0, 0.2, 1} x pad {reflect, zero} x out at an
               odd shape, and both pads x both outputs at the edges of the
               tensor-core tilings (C = 4, 36, 48; Co = 4, 132; H or W = 2;
               W = 33, 37); the bf16 mode vs plain (2e-2); each path shape
               timed (weights packed once, as the paths keep them) against
               plain and against F.conv2d in bfloat16 on the dequantized
               values
 18. wide fixtures  adain and wct on the card vs rpst's JAX output
               (tests/fixtures/torch_port_{adain,wct}.npz, 64px, hidden 32):
               standard f32, and q8 with rpst's scales (float32: PSNR >= 40
               dB, MAE < 2e-3; bfloat16: PSNR >= 30 dB, MAE < 1e-2), exact
               B5 launches
 19. q8 targets fixture  vgg_target_taps_q8 and
               perceptual_rp_losses_q8targets on the card vs rpst's JAX
               (tests/fixtures/torch_port_q8_targets.npz, 64px b4): the
               int8 taps PSNR >= 40 dB, loss parts rtol 5e-3, 6 B5 launches
 20. wide serve    the adain / wct main path: 8 requests through build_model
               -> resolve_mode("q8") -> calibrate_scales -> make_run_impl ->
               DynamicBatcher(b4) at hidden 32, counts reset before and read
               after (4 B5 per stylize); serve_torch.py --mode q8 as a
               subprocess for adain (hidden 32, and the repository's
               configs/train_deeper_rp_adain.yaml at hidden 16: 2 B5 per
               stylize) and for wct
 21. q8-targets train  train_torch.py, flagship, train_q8_targets=true, b4
               f32 folded, 3 steps in this process, counts reset before and
               read after: exact B1/B2/B3/B5 launches per step
 22. wide timing   512px: adain b1/b4 standard f32/bf16 vs q8, wct b1; the
               flagship train step b1/b4 with and without int8 targets

 23. B6 kernels    B6a-d (forward, forward + LSE, dQ, dK/dV) vs their plain
               versions at the shapes of a 512px SANet stylize, relu4_1 (N,
               4096, 4096, 512) and relu5_1 (N, 1024, 1024, 512) at N = 1
               and 4, f32 (1e-4) and bf16 (2e-2), LSE 1e-4, a ragged
               rectangular case and inputs x 30; both forwards' O also
               against its own size at x 1 (f32 1e-5 of max |ref|, mean
               1e-6; bf16 2e-2, 2e-3), and the f32 forward's O at x 30
               against a float64 oracle (at most 3x the plain version's
               error, or 3 x 2^-20 of max |O| where that is more:
               rpst_torch.ops.flash_attention.f32_oracle_limit); the f32
               dQ, dK, dV at x 1 also within 1e-5 (mean 1e-6) of max |ref|
               from the float64 oracle of their own function
               (attention_grads_f64 of the same LSE and Delta), at x 30
               against it in place of plain (f32_oracle_limit); the
               bf16 dQ, dK, dV within 2e-2 (mean 2e-3) of max |plain|
               (rpst_torch.ops.flash_attention.check_backward); each
               forward (a tensor-core kernel per type) also
               around its tiles, bf16 32 x 64 at C = 128, 256, 384, f32
               32 x 32 at C = 128-512, N = 3; the backward in both types
               around its 16 x 32 tiles at C = 128-512, N = 3; dQ, dK, dV
               bit-equal across two runs; each timed against plain and
               against
               F.scaled_dot_product_attention(scale=1.0) and its autograd
               backward; B5 at the SANet path's six new shapes is in phase 17
 24. sanet fixture  the static SANet on the card vs rpst's JAX output
               (tests/fixtures/torch_port_sanet.npz, 64px b2): standard f32
               (1e-4), q8 with rpst's scales (f32 PSNR >= 35 dB, bf16 >= 30),
               loss parts (rtol 1e-4) and gradients (rtol 5e-3, atol 1e-4 x
               max), exact B5 / B6 launches
 25. sanet parity   512px b2: the model on B6 vs the same model on the plain
               attention, f32 and bf16
 26. sanet serve    the SANet main path: 8 requests through build_model ->
               build_vgg -> resolve_mode -> [calibrate_scales ->] make_run_impl
               -> DynamicBatcher(b4), standard and q8, counts reset before and
               read after (2 B6 per stylize; q8 16 B5 + 2 B6); serve_torch.py
               --mode standard and --mode q8 as subprocesses
 27. sanet train    train_torch.py on configs/train_static_sanet.yaml's
               settings (512px, batch 4, f32): 3 steps as a subprocess, then a
               resume for 2 more in this process with the counts reset before
               and read after: exact 6 / 6 / 6 B6 fwd / dQ / dK/dV per step;
               then 2 steps in bfloat16 the same way (the forward is then the
               tensor-core kernel)
 28. sanet timing   512px stylize b1 / b4 standard f32, bf16 and q8, and the
               train step b1 / b4 f32 and bf16, each with B6, with the plain
               attention and with the SDPA call in B6's place (in this script
               only)

The last lines: the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. Without a CUDA device, or away from the
repository, it exits non-zero and prints no result.
"""

import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=5,
                hidden_dim=32, inception_num=0, attention="none", seed=0)
IMG = 512
F32_TOL = 1e-4   # rtol = atol: K = 9*128 products summed in another order
BF16_TOL = 2e-2  # rtol = atol: about two bf16 ulps at O(1) values
# the bfloat16 attention forward's O is an average over Nk keys, far below
# O(1) (max |O| ~0.03 at Nk = 4096), so BF16_TOL alone would pass half of O
# or a dropped V tile: O is also held to the data's own size, max abs err <=
# 2e-2 x max |ref| (a few bf16 ulps of the largest value) and mean abs err
# <= 2e-3 x max |ref| (a half-ulp rounding of typical values is ~3e-4)
BF16_O_REL, BF16_O_MEAN_REL = 2e-2, 2e-3
# B3's dk/db: rtol 1e-4 and an atol that grows with the summed length L =
# N*H*W as f32 rounding of a sum of L O(1) products does: 2e-3 at L = 512,
# the bound of tests/test_folded.py:406-411 at 16x16, batch 2
DK_ATOL_512 = 2e-3
# train parity (tests/test_folded.py:133-138): loss rtol 1e-4; gradients
# rtol 5e-3 with atol 1e-4 x the tensor's max; bf16 vs f32 gradients by
# cosine, the gate of tests/test_q8_targets.py:100
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL, BF16_COS = 1e-4, 5e-3, 1e-4, 0.98
# B1 / B2 / B3 launches of one folded flagship train step with separate
# encodes: B1 runs 15 RP layers (5 per encode of content and style, 5
# decoder) + 4 folded VGG layers on the stylized image + 4 on the 2N
# style/content targets = 23; B2 runs on every layer whose input needs a
# gradient: 13 RP (not the two first encoder layers, whose input is an
# image) + the 4 VGG layers of the stylized pass = 17; B3 on the 15 RP
# layers and never on the frozen VGG = 15
PER_STEP = (23, 17, 15)
# with train_q8_targets the 2N style/content target pass leaves the folded
# VGG (4 B1 launches fewer) for the int8 chain: 6 B5 launches (conv_4 ..
# conv_9 of the encoder); B2 and B3 never ran on the targets
PER_STEP_Q8T = (PER_STEP[0] - 4, PER_STEP[1], PER_STEP[2])
B5_PER_TARGET_PASS = 6
# published dense peaks of one H100 SXM (operations per second by operand
# type; float32 data is held to the TF32 tensor-core rate) and its memory
# rate, for the kernels line's bound_ms
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check_close(name, got, ref, tol, mae_max=None):
    """Raise unless |got - ref| <= tol + tol*|ref| everywhere (and the mean
    abs error is below mae_max); return the max abs error."""
    import torch
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite output")
    err = (got - ref).abs()
    max_err, mae = err.max().item(), err.mean().item()
    if not torch.allclose(got, ref, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: max abs err {max_err} > tol {tol}")
    if mae_max is not None and not mae < mae_max:
        raise AssertionError(f"{name}: MAE {mae} >= {mae_max}")
    return max_err, mae


def check_scaled(name, got, ref, rel, mean_rel):
    """Raise unless max |got - ref| <= rel * max |ref| and mean |got - ref|
    <= mean_rel * max |ref|; return (max abs err, mean abs err) / max |ref|."""
    got, ref = got.float(), ref.float()
    err, size = (got - ref).abs(), ref.abs().max().item()
    max_err, mae = err.max().item(), err.mean().item()
    if not (max_err <= rel * size and mae <= mean_rel * size):
        raise AssertionError(
            f"{name}: max abs err {max_err}, mean {mae} against max |ref| "
            f"{size} (limits {rel} and {mean_rel} of it)")
    return max_err / size, mae / size


def check_oracle(name, got, ref64, limit):
    """Raise unless max |got - ref64| <= limit, ref64 a float64 oracle;
    return that max abs err."""
    import torch
    if got.shape != ref64.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref64.shape)} or non-finite output")
    err = (got.double() - ref64).abs().max().item()
    if not err <= limit:
        raise AssertionError(f"{name}: max abs err from the float64 oracle "
                             f"{err} > {limit}")
    return err


def cuda_ms(fn, iters=20, warmup=3):
    """Median ms of ``fn()`` over ``iters`` runs, each timed with CUDA
    events after ``warmup`` untimed runs."""
    import torch
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


def bound_ms(ops, nbytes, kind):
    """(least ms the card could take, which limit binds): the larger of
    ``ops`` over the peak rate of ``kind`` and ``nbytes`` (each input read
    once, each output written once) over the memory rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def conv_bound(n, h, w, c, co, kind, in_size, out_sizes, extra_bytes=0,
               layers=1):
    """bound_ms of a 3x3 conv layer (or ``layers`` chained ones of one
    width): 2 * 9 * C * Co operations per output pixel; the input, the
    weights (of the input's type), the per-channel rows and every output
    moved once. Sizes are bytes per element."""
    px = n * h * w
    ops = layers * 2 * 9 * px * c * co
    nbytes = (px * c * in_size + layers * 9 * c * co * in_size
              + sum(px * co * sz for sz in out_sizes) + extra_bytes)
    return bound_ms(ops, nbytes, kind)


def q8_bound(n, h, w, c4, c4o, structured, out_size=1, layers=1):
    """bound_ms of B4 (``layers`` 1) or B7 (2: 4C -> 4Co -> 4Co) at (N, Hf,
    Wf): the listed blocks' operations (the 36 of a folded kernel, the
    unfolded conv's; all 144 of a dense one) at the int8 peak; x, each
    layer's int8 output (the last one ``out_size`` bytes an element), the
    kernels, the per-channel rows and the sums moved once."""
    px = n * h * w
    ops = layers * 2 * 9 * px * c4 * c4o // (4 if structured else 1)
    nbytes = (px * c4 + (layers - 1) * px * c4o + px * c4o * out_size
              + layers * (9 * c4 * c4o + 3 * 4 * c4o + 2 * 4 * n * c4o))
    return bound_ms(ops, nbytes, "int8")


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on an NVIDIA GPU")
    sys.path.insert(0, str(REPO / "src"))
    from rpst_torch.bridge import load_weights
    from rpst_torch.config import load_config
    from rpst_torch.data import load_image
    from rpst_torch.kernels import build
    from rpst_torch.models import build_model
    from rpst_torch.models.fast_path import stylize_multi_adain_folded
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.ops.folded import fold_bias, fold_conv_kernel
    from rpst_torch.ops.folded_conv import (fused_folded_conv,
                                            fused_folded_conv_plain)
    from rpst_torch.serving import DynamicBatcher, make_run_impl, resolve_mode

    torch.backends.cudnn.allow_tf32 = False  # F.conv2d in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name_power = card()
    log("card", f"{name_power} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    for lib in build.SIGNATURES:
        build.load(lib)
        info = build.build_info[lib]
        regs = [ln.replace("ptxas info    :", "").strip()
                for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log("1 build", f"{lib}.cu built in {info['seconds']:.2f}s; ptxas: "
            f"{regs}")
    log("1 build", f"all built and loaded in {time.perf_counter() - t0:.2f}s")

    # ---- 2. kernel vs plain -----------------------------------------------
    g = torch.Generator().manual_seed(0)

    def layer(n, h, w, c, co, dense=False):
        """x, a folded kernel (or a dense one: every block non-zero) and
        the folded bias of a c -> co layer."""
        bound = (9 * c) ** -0.5
        x = torch.rand(n, h, w, 4 * c, generator=g) * 2 - 0.5
        k = fold_conv_kernel((torch.rand(3, 3, c, co, generator=g) * 2 - 1)
                             * bound)
        if dense:
            k = (torch.rand(k.shape, generator=g) * 2 - 1) * bound / 2
        b = fold_bias((torch.rand(co, generator=g) * 2 - 1) * bound)
        return x.to(dev), k.to(dev).contiguous(), b.to(dev)

    cases = [("12->128", (1, 256, 256, 3, 32), 0.2, False),
             ("128->128", (1, 256, 256, 32, 32), 0.2, False),
             ("128->128 relu", (1, 256, 256, 32, 32), 0.0, False),
             ("128->12", (1, 256, 256, 32, 3), 0.2, False),
             ("VGG relu1_1 12->256", (1, 256, 256, 3, 64), 0.0, False),
             ("VGG relu1_2 256->256", (1, 256, 256, 64, 64), 0.0, False),
             ("VGG relu2_1 256->512", (1, 128, 128, 64, 128), 0.0, False),
             ("VGG relu2_2 512->512", (1, 128, 128, 128, 128), 0.0, False),
             ("ragged 2x38x22", (2, 38, 22, 32, 32), 0.2, False),
             ("rings override", (1, 64, 64, 32, 32), 0.2, True),
             ("2x2", (2, 2, 2, 32, 32), 0.2, False)]
    # the same function on dense kernels (all 144 blocks listed)
    cases += [(f"{label} dense", shape, alpha, rings, True)
              for label, shape, alpha, rings in cases
              if label in ("12->128", "128->128", "128->12",
                           "VGG relu2_2 512->512", "ragged 2x38x22",
                           "rings override", "2x2")]
    fused_folded_conv.launches = 0
    f32_err = 0.0
    with torch.inference_mode():
        for label, shape, alpha, with_rings, *dense in cases:
            x, k, b = layer(*shape, *dense)
            rings = None
            if with_rings:
                rings = (torch.rand(x.shape[0], 2, x.shape[2], x.shape[3],
                                    generator=g)).to(dev)
            for dt, tol in ((torch.float32, F32_TOL),
                            (torch.bfloat16, BF16_TOL)):
                xd, kd, bd = x.to(dt), k.to(dt), b.to(dt)
                rd = None if rings is None else rings.to(dt)
                y = fused_folded_conv(xd, kd, bd, alpha, rd)
                torch.cuda.synchronize()
                ref = fused_folded_conv_plain(
                    xd.float(), kd.float(), bd.float(), alpha,
                    None if rd is None else rd.float()).to(dt)
                err, _ = check_close(f"B1 {label} {dt}", y, ref, tol)
                if dt == torch.float32:
                    f32_err = max(f32_err, err)
                log("2 kernels", f"{label} x{tuple(x.shape)}->4Co "
                    f"{k.shape[3]} {str(dt)[6:]}: max abs err {err:.3g} "
                    f"(tol {tol})")
    log("2 kernels", f"{fused_folded_conv.launches} comparison launches")
    bwd = _check_backward_kernels(dev, name_power)
    b12 = _b1_b2_timing(dev, name_power)

    # ---- 3. slice vs the JAX reference fixture ----------------------------
    fx_path = REPO / "tests" / "fixtures" / "torch_port_flagship.npz"
    with np.load(fx_path) as fx:
        content, style, ref = (torch.from_numpy(fx[k]).to(dev)
                               for k in ("content", "style", "out"))
    fx_cfg = load_config(dict(FLAGSHIP, img_size=content.shape[1],
                              exec_strategy="folded"))
    fx_bundle = build_model(fx_cfg, dev)
    fx_bundle.load_state_dict(load_weights(fx_path))
    fused_folded_conv.launches = 0
    out = fx_bundle.stylize(content, style)
    torch.cuda.synchronize()
    err, mae = check_close("fixture", out, ref, F32_TOL, mae_max=1e-5)
    if fused_folded_conv.launches != 15:
        raise AssertionError(f"fixture: {fused_folded_conv.launches} B1 "
                             "launches, expected 15")
    log("3 fixture", f"folded f32 on the card vs rpst JAX (64px, rp5 h32): "
        f"max abs err {err:.3g}, MAE {mae:.3g}; 15 B1 launches")

    # ---- 4. 512px folded (B1) vs standard, bf16 vs f32 --------------------
    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    bundle = build_model(cfg, dev)
    init_torch_default(bundle.model, cfg.seed)
    std_bundle = build_model(cfg.replace(exec_strategy="standard"), dev)
    std_bundle.load_state_dict(bundle.model.state_dict())
    rng = np.random.default_rng(0)
    c512 = torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
    s512 = torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
    fused_folded_conv.launches = 0
    folded = bundle.stylize(c512, s512)
    n_sep = fused_folded_conv.launches
    folded_2n = bundle.stylize(c512, s512, batch_encode=True)
    n_2n = fused_folded_conv.launches - n_sep
    standard = std_bundle.stylize(c512, s512)
    torch.cuda.synchronize()
    if (n_sep, n_2n) != (15, 10):
        raise AssertionError(f"B1 launches {n_sep} (separate encodes) / "
                             f"{n_2n} (2N encode), expected 15 / 10")
    err, mae = check_close("512 folded vs standard", folded, standard,
                           F32_TOL, mae_max=1e-5)
    err2, _ = check_close("512 2N encode", folded_2n, folded, F32_TOL,
                          mae_max=1e-5)
    with torch.inference_mode():
        folded_bf16 = stylize_multi_adain_folded(
            bundle.folded_weights(torch.bfloat16), c512, s512,
            dtype=torch.bfloat16)
    bf16_mae = (folded_bf16.float() - folded).abs().mean().item()
    if not (torch.isfinite(folded_bf16).all() and bf16_mae < 1e-2):
        raise AssertionError(f"bf16 folded vs f32 folded MAE {bf16_mae}")
    log("4 parity", f"512px b2 f32 folded(B1) vs standard: max abs err "
        f"{err:.3g}, MAE {mae:.3g}; 2N encode max err {err2:.3g}; bf16 vs "
        f"f32 MAE {bf16_mae:.3g}; launches 15 / 10")

    # ---- 5. the main path: serving through the user's entry points --------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        from PIL import Image
        for sub in ("content", "style"):
            (tmp / sub).mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        cfg_path = tmp / "cfg.yaml"
        cfg_path.write_text(json.dumps(dict(FLAGSHIP, img_size=IMG)))

        main_cfg = load_config(str(cfg_path), {"exec_strategy": "folded"})
        main_bundle = build_model(main_cfg, dev)
        init_torch_default(main_bundle.model, main_cfg.seed)
        run = make_run_impl(main_bundle, resolve_mode(main_bundle, "folded"))
        batcher = DynamicBatcher(run, batch_size=4, max_wait_ms=50.0,
                                 device=dev)
        imgs = [load_image(tmp / "content" / f"c{i}.png", IMG)
                for i in range(8)]
        style_img = load_image(tmp / "style" / "s.png", IMG)
        fused_folded_conv.launches = 0  # the main path's count starts here
        try:
            outs = [f.result(timeout=300) for f in
                    [batcher.submit(im, style_img) for im in imgs]]
        finally:
            batcher.close()
        main_launches = fused_folded_conv.launches
        if main_launches < 30 or main_launches % 15:
            raise AssertionError(f"main path: {main_launches} B1 launches "
                                 "for 8 requests in batches of 4")
        for o in outs:
            if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                raise AssertionError(f"main path output {o.shape} bad")
        log("5 serve", f"8 requests via DynamicBatcher(b4): "
            f"{batcher.stats()}, {main_launches} B1 launches")

        env = dict(os.environ)
        swept = tmp / "swept"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / "serve_torch.py"),
             "--config", str(cfg_path), "--content", str(tmp / "content"),
             "--style", str(tmp / "style" / "s.png"), "--out", str(swept),
             "--mode", "folded", "--batch", "4", "--device", "cuda"],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=str(REPO))
        out_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise AssertionError(f"serve_torch sweep rc {proc.returncode}:\n"
                                 f"{out_log[-3000:]}")
        pngs = sorted(swept.glob("*.png"))
        sweep_launches = _logged_launches(out_log)
        if len(pngs) != 8 or not sweep_launches > 0:
            raise AssertionError(f"sweep: {len(pngs)} PNGs, launches "
                                 f"{sweep_launches}:\n{out_log[-3000:]}")
        sweep_line = [ln for ln in out_log.splitlines() if "Stylized" in ln]
        log("5 serve", f"serve_torch.py sweep: 8 PNGs, {sweep_launches} B1 "
            f"launches in the child, {time.perf_counter() - t0:.1f}s wall; "
            f"{sweep_line[-1].split(' - ')[-1] if sweep_line else ''}")

        # ---- 6. daemon ----------------------------------------------------
        replies, stats = _daemon_round_trip(cfg_path, tmp, env)
        log("6 daemon", f"6/6 ok replies, stats {stats}")

    # ---- 7. timing --------------------------------------------------------
    def plain_lrelu(x, k, b):
        return fused_folded_conv_plain(x, k, b, 0.2)

    rows = []
    with torch.inference_mode():
        for batch in (1, 8):
            c = torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).to(dev)
            s = torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).to(dev)
            for dt in (torch.float32, torch.bfloat16):
                w = bundle.folded_weights(dt)
                paths = {
                    "folded B1": lambda: stylize_multi_adain_folded(
                        w, c, s, dtype=dt),
                    "folded plain": lambda: stylize_multi_adain_folded(
                        w, c, s, dtype=dt, conv=plain_lrelu),
                    "standard": lambda: _standard(std_bundle, c, s, dt),
                }
                # folded B1 against standard in both orders (the A/B of the
                # serving policy), plain between them
                for path in ("folded B1", "standard", "folded plain",
                             "standard", "folded B1"):
                    ms = cuda_ms(paths[path])
                    rows.append((batch, str(dt)[6:], path, ms))
                    log("7 timing", f"512px b{batch} {str(dt)[6:]:8s} "
                        f"{path:12s}: {ms:8.3f} ms  "
                        f"{batch * 1e3 / ms:8.2f} img/s  ({name_power})")

    # ---- 8-11. training ---------------------------------------------------
    _train_fixture(dev)
    _train_parity(dev, rng)
    train_launches = _train_main_path(dev)
    _train_timing(dev, rng, name_power)

    # ---- 12-16. int8 (q8) serving -----------------------------------------
    q8k = _q8_kernels(dev, name_power)
    _q8_fixture(dev)
    _q8_parity(dev, rng)
    q8_launches = _q8_serve(dev, rng)
    _q8_timing(dev, rng, name_power, rows)

    # ---- 17-22. the wide standard-layout path (B5) ------------------------
    b5k = _b5_kernels(dev, name_power)
    _wide_fixtures(dev)
    _q8_targets_fixture(dev)
    b5_serve = _wide_serve(dev, rng)
    q8t_launches = _q8_targets_train(dev)
    _wide_timing(dev, rng, name_power)

    # ---- 23-28. the static SANet on B6 -----------------------------------
    b6k = _b6_kernels(dev, name_power)
    _sanet_fixture(dev)
    _sanet_parity(dev, rng)
    sanet_serve = _sanet_serve(dev, rng)
    sanet_train = _sanet_train(dev)
    _sanet_timing(dev, rng, name_power)

    # bounds at the shapes the times were taken at (phases 2, 12, 17)
    bnd = {
        # B1 and B2 at the timed folded kernel: its 36 listed blocks
        "B1": b12["B1"]["bound"],
        "B2": b12["B2"]["bound"],
        # B3 at the timed listed mode: the 36 blocks a fold lists
        "B3": bwd["B3"]["bound"],
        # B4 and B7 at the timed quantized folds: their 36 listed blocks
        "B4": q8_bound(1, 256, 256, 128, 128, True),
        "B7": q8_bound(1, 256, 256, 128, 128, True, layers=2),
    }
    bwd_src = "src/rpst_torch/csrc/folded_conv_bwd.cu"
    kernels = {"kernels": [
        {"name": "fused_folded_conv", "route": "cuda",
         "source": "src/rpst_torch/csrc/folded_conv.cu",
         "replaces": "src/rpst/ops/pallas/folded_conv.py:650",
         "launches": (main_launches + train_launches[0] + q8_launches["B1"]
                      + q8t_launches[0]),
         "max_abs_err": f32_err, "ms": b12["B1"]["ms"],
         "plain_ms": b12["B1"]["plain_ms"], "bound_ms": bnd["B1"][0],
         "bound_by": bnd["B1"][1], "library_ms": b12["B1"]["library_ms"]},
        {"name": "fused_folded_conv_grad_input", "route": "cuda",
         "source": bwd_src,
         "replaces": "src/rpst/ops/pallas/folded_conv.py:339",
         "launches": train_launches[1] + q8t_launches[1],
         "max_abs_err": bwd["B2"]["err"], "ms": b12["B2"]["ms"],
         "plain_ms": b12["B2"]["plain_ms"], "bound_ms": bnd["B2"][0],
         "bound_by": bnd["B2"][1], "library_ms": b12["B2"]["library_ms"]},
        {"name": "fused_folded_conv_grad_weight", "route": "cuda",
         "source": bwd_src,
         "replaces": "src/rpst/ops/pallas/folded_conv.py:468",
         "launches": train_launches[2] + q8t_launches[2],
         "max_abs_err": bwd["B3"]["err"], "ms": bwd["B3"]["ms"],
         "plain_ms": bwd["B3"]["plain_ms"], "bound_ms": bnd["B3"][0],
         "bound_by": bnd["B3"][1], "library_ms": bwd["B3"]["library_ms"]},
        {"name": "fused_folded_conv_q8", "route": "cuda",
         "source": "src/rpst_torch/csrc/folded_conv_q8.cu",
         "replaces": "src/rpst/ops/pallas/folded_conv_q8.py:281",
         "launches": q8_launches["B4"], "max_abs_err": q8k["B4"]["err"],
         "ms": q8k["B4"]["ms"], "plain_ms": q8k["B4"]["plain_ms"],
         "bound_ms": bnd["B4"][0], "bound_by": bnd["B4"][1],
         "library_ms": None},
        {"name": "fused_folded_conv2_q8", "route": "cuda",
         "source": "src/rpst_torch/csrc/folded_conv2_q8.cu",
         "replaces": "src/rpst/ops/pallas/folded_conv2_q8.py:254",
         "launches": q8_launches["B7"], "max_abs_err": q8k["B7"]["err"],
         "ms": q8k["B7"]["ms"], "plain_ms": q8k["B7"]["plain_ms"],
         "bound_ms": bnd["B7"][0], "bound_by": bnd["B7"][1],
         "library_ms": None},
        # B5's numbers at the widest shape of the adain path (phase 17);
        # library_ms is F.conv2d in bfloat16 on the dequantized values
        {"name": "fused_conv2d_q8", "route": "cuda",
         "source": "src/rpst_torch/csrc/conv2d_q8.cu",
         "replaces": "src/rpst/ops/pallas/conv2d_q8.py:220",
         "launches": b5_serve + q8t_launches[3] + sanet_serve["B5"],
         "max_abs_err": b5k["err"], "ms": b5k["ms"],
         "plain_ms": b5k["plain_ms"], "bound_ms": b5k["bound_ms"],
         "bound_by": b5k["bound_by"], "library_ms": b5k["library_ms"]}]}
    # B6's numbers at relu4_1 of a 512px stylize, (1, 4096, 4096, 512) f32
    # (phase 23); library_ms is F.scaled_dot_product_attention(scale=1.0)
    # forward for B6a / B6b and its autograd backward, which yields dQ, dK
    # and dV together, for B6c and B6d. Each bfloat16 kernel is a kernel of
    # its own (tensor cores, one bf16 product a fragment): the forward's
    # launches are the q8 serving path's and the bfloat16 train run's, the
    # backward's the bfloat16 train run's; the float32 kernels' are the
    # others
    b6_launches = {"B6a": sanet_serve["B6a"] - sanet_serve["B6a_bf16"],
                   "B6b": sanet_train[0],
                   "B6c": sanet_train[1], "B6d": sanet_train[2],
                   "B6a_bf16": sanet_serve["B6a_bf16"],
                   "B6b_bf16": sanet_train[3], "B6c_bf16": sanet_train[4],
                   "B6d_bf16": sanet_train[5]}
    for key, fn_name, line in (("B6a", "flash_fwd", 260),
                               ("B6b", "flash_fwd_lse", 109),
                               ("B6c", "flash_bwd_dq", 220),
                               ("B6d", "flash_bwd_dkv", 240),
                               ("B6a_bf16", "flash_fwd_bf16", 260),
                               ("B6b_bf16", "flash_fwd_lse_bf16", 109),
                               ("B6c_bf16", "flash_bwd_dq_bf16", 220),
                               ("B6d_bf16", "flash_bwd_dkv_bf16", 240)):
        kernels["kernels"].append(
            {"name": fn_name, "route": "cuda",
             "source": "src/rpst_torch/csrc/flash_attention.cu",
             "replaces": f"src/rpst/ops/pallas/flash_attention.py:{line}",
             "launches": b6_launches[key], **b6k[key]})
    for k in kernels["kernels"]:
        if not k["launches"] > 0:
            raise AssertionError(f"{k['name']} was launched no time on the "
                                 "main paths")
    print(json.dumps(kernels), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _grad_case(g, dev, n, h, w, c4, c4o, folded=False):
    """x, gz and khat of a layer: khat of a dense random kernel, or of one
    from fold_conv_kernel (36 of 144 blocks non-zero)."""
    import torch
    from rpst_torch.ops.folded import fold_conv_kernel
    x = torch.randn(n, h, w, c4, generator=g)
    gz = torch.randn(n, h, w, c4o, generator=g)
    kf = torch.randn(3, 3, c4, c4o, generator=g) * 0.1
    if folded:
        kf = fold_conv_kernel(torch.randn(3, 3, c4 // 4, c4o // 4,
                                          generator=g) * 0.2)
    return (x.to(dev), gz.to(dev),
            kf.flip(0, 1).transpose(2, 3).contiguous().to(dev))


def _plain_act(x_f, folded_kernel, folded_bias, alpha, listed=False):
    """B1's plain version as a ``conv_act`` (autograd of plain PyTorch
    computes every block; ``listed`` changes nothing there)."""
    from rpst_torch.ops.folded_conv import fused_folded_conv_plain
    return fused_folded_conv_plain(x_f, folded_kernel, folded_bias, alpha)


def _unfolded_kernel_grad(dk):
    """The image kernel's gradient (3, 3, C, Co) that a folded kernel's
    gradient dk (3, 3, 4C, 4Co) sends back through fold_conv_kernel: each
    tap's four placements summed (the einsum's backward)."""
    import torch
    from rpst_torch.ops.folded import _fold_placement
    c, co = dk.shape[2] // 4, dk.shape[3] // 4
    p = _fold_placement(torch.float32, dk.device)
    k = torch.einsum("abstk,absito->kio", p, dk.reshape(3, 3, 4, c, 4, co))
    return k.reshape(3, 3, c, co)


def _check_b3(label, xd, gd, dk_atol):
    """B3 in both modes against its plain version (rtol 1e-4, atol
    dk_atol), each bit-equal across two runs, and the listed mode's
    unfolded-kernel gradient against the dense mode's (the same limits);
    returns the max abs error."""
    import torch
    from rpst_torch.ops.folded_conv import (
        fused_folded_conv_grad_weight, fused_folded_conv_grad_weight_plain)

    def close(name, got, ref):
        if not (torch.isfinite(got).all() and torch.allclose(
                got, ref, rtol=1e-4, atol=dk_atol)):
            raise AssertionError(
                f"B3 {label} {name}: max abs err "
                f"{(got - ref).abs().max().item()} (rtol 1e-4, atol "
                f"{dk_atol:.3g})")
        return (got - ref).abs().max().item()

    err, out = 0.0, {}
    for mode, listed in (("dense", False), ("listed", True)):
        dk, db = fused_folded_conv_grad_weight(xd, gd, listed)
        dk2, db2 = fused_folded_conv_grad_weight(xd, gd, listed)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dk2) and torch.equal(db, db2)):
            raise AssertionError(f"B3 {label} {mode}: two runs differ")
        rdk, rdb = fused_folded_conv_grad_weight_plain(xd, gd, listed)
        err = max(err, close(f"{mode} dk", dk, rdk), close(f"{mode} db", db,
                                                          rdb))
        out[mode] = dk
    close("listed vs dense, unfolded kernel gradient",
          _unfolded_kernel_grad(out["listed"]),
          _unfolded_kernel_grad(out["dense"]))
    return err


def _check_backward_kernels(dev, name_power):
    """Phase 2, backward: B2 and B3 against their plain versions at every
    width of the training path, f32 and bf16, B2 with dense and with folded
    kernels, B3 dense and listed (``_check_b3``); B3 timed in both modes
    against plain, torch.nn.grad.conv2d_weight on the ring-padded folded
    tensor and on the reflect-padded unfolded image (what the standard path
    runs) at (1,256,256,128->128) and (1,128,128,512->512). Returns the f32
    max abs errors and B3's listed 128->128 f32 times for the kernels
    JSON."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight
    from rpst_torch.ops.folded import folded_reflect_pad, unfold
    from rpst_torch.ops.folded_conv import (
        fused_folded_conv_grad_input, fused_folded_conv_grad_input_plain,
        fused_folded_conv_grad_weight, fused_folded_conv_grad_weight_plain)
    g = torch.Generator().manual_seed(1)
    # (label, (N, H, W, 4C, 4Co)): the RP stack at 512px, the folded VGG
    # layers relu1_1/1_2 at 256x256 and relu2_1/2_2 at 128x128, a ragged
    # batch and the smallest foldable image
    cases = [("RP 12->128", (1, 256, 256, 12, 128)),
             ("RP 128->128", (1, 256, 256, 128, 128)),
             ("RP 128->12", (1, 256, 256, 128, 12)),
             ("VGG relu1_1 12->256", (1, 256, 256, 12, 256)),
             ("VGG relu1_2 256->256", (1, 256, 256, 256, 256)),
             ("VGG relu2_1 256->512", (1, 128, 128, 256, 512)),
             ("VGG relu2_2 512->512", (1, 128, 128, 512, 512)),
             ("ragged 2x38x22", (2, 38, 22, 128, 128)),
             ("2x2", (2, 2, 2, 12, 12))]
    # khat of folded kernels: B2 takes their 36 listed blocks
    cases += [(f"{label} folded", shape, True) for label, shape in cases
              if label in ("RP 12->128", "RP 128->128", "RP 128->12",
                           "VGG relu2_2 512->512", "ragged 2x38x22", "2x2")]
    err = {"B2": 0.0, "B3": 0.0}
    for label, shape, *folded in cases:
        x, gz, khat = _grad_case(g, dev, *shape, *folded)
        n, h, w = shape[:3]
        dk_atol = DK_ATOL_512 * (n * h * w / 512) ** 0.5
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xd, gd, kd = x.to(dt), gz.to(dt), khat.to(dt)
            dx = fused_folded_conv_grad_input(gd, kd)
            torch.cuda.synchronize()
            e2, _ = check_close(f"B2 {label} {dt}", dx,
                                fused_folded_conv_grad_input_plain(gd, kd),
                                tol)
            e3 = _check_b3(f"{label} {dt}", xd, gd, dk_atol)
            if dt == torch.float32:
                err["B2"], err["B3"] = max(err["B2"], e2), max(err["B3"], e3)
            log("2 kernels", f"{label} {tuple(shape)} {str(dt)[6:]}: B2 dx "
                f"max abs err {e2:.3g} (tol {tol}), B3 dk/db dense and "
                f"listed {e3:.3g} (atol {dk_atol:.3g}; bit-equal across two "
                f"runs; listed = dense through the fold)")
    out = {"B2": {"err": err["B2"]}, "B3": {"err": err["B3"]}}
    for shape in ((1, 256, 256, 128, 128), (1, 128, 128, 512, 512)):
        n, h, w, c4, c4o = shape
        x, gz, _ = _grad_case(g, dev, *shape)
        for dt in (torch.float32, torch.bfloat16):
            kind, size = ("f32", 4) if dt == torch.float32 else ("bf16", 2)
            xd, gd = x.to(dt), gz.to(dt)
            # the library calls: the kernel gradient of one conv over the
            # ring-padded folded tensor (all 144 blocks), and of the
            # unfolded conv over the reflect-padded image
            xp = folded_reflect_pad(xd).permute(0, 3, 1, 2)
            gp = gd.permute(0, 3, 1, 2)
            xu = F.pad(unfold(xd).permute(0, 3, 1, 2), (1, 1, 1, 1),
                       mode="reflect")
            gu = unfold(gd).permute(0, 3, 1, 2)
            lib = {"folded": cuda_ms(lambda: conv2d_weight(
                       xp, (c4o, c4, 3, 3), gp)),
                   "unfolded": cuda_ms(lambda: conv2d_weight(
                       xu, (c4o // 4, c4 // 4, 3, 3), gu))}
            for mode, listed in (("dense", False), ("listed", True)):
                t = {"B3": cuda_ms(lambda: fused_folded_conv_grad_weight(
                         xd, gd, listed)),
                     "B3 plain": cuda_ms(
                         lambda: fused_folded_conv_grad_weight_plain(
                             xd, gd, listed))}
                bnd = folded_bound(n, h, w, c4, c4o, kind, size, listed)
                tf3 = ""
                if kind == "f32":  # three TF32 products: 3x the operations
                    ops = 2 * 9 * n * h * w * c4 * c4o // (4 if listed else 1)
                    tf3 = (f", 3xTF32 ceiling "
                           f"{3 * ops / PEAK_OPS['f32'] * 1e3:.4f}")
                log("2 kernels", f"B3 {tuple(shape)} {kind} {mode}: "
                    f"{t['B3']:.4f} ms vs plain {t['B3 plain']:.4f}, "
                    f"conv2d_weight on the ring-padded tensor "
                    f"{lib['folded']:.4f}, on the unfolded image "
                    f"{lib['unfolded']:.4f}; bound {bnd[0]:.4f} ms by "
                    f"{bnd[1]}{tf3} ({100 * bnd[0] / t['B3']:.1f}% of it; "
                    f"{name_power})")
                if (c4, kind, mode) == (128, "f32", "listed"):
                    out["B3"].update(ms=t["B3"], plain_ms=t["B3 plain"],
                                     library_ms=lib["folded"], bound=bnd)
    return out


def folded_bound(n, h, w, c4, c4o, kind, size, structured):
    """bound_ms of B1 / B2 at (N, Hf, Wf, 4C -> 4Co): the operations of the
    listed blocks (all 144 of a dense kernel; the 36 of a folded one, the
    unfolded conv's) at the peak of ``kind``; the input, the kernel and the
    output moved once, ``size`` bytes each."""
    px = n * h * w
    ops = 2 * 9 * px * c4 * c4o // (4 if structured else 1)
    return bound_ms(ops, (px * (c4 + c4o) + 9 * c4 * c4o) * size, kind)


def _b1_b2_timing(dev, name_power):
    """Phase 2, timing: B1 and B2 at (1,256,256,128->128) and
    (1,128,128,512->512), f32 and bf16, with a folded kernel and a dense
    one, beside the plain version, the library call on the folded layout
    (F.conv2d on the ring-padded tensor; torch.nn.grad.conv2d_input on it),
    the unfolded conv the standard path runs for a folded kernel (reflect
    pad + F.conv2d on (N, C, 2H, 2W); conv2d_input there) and the dense and
    structured bounds. The kernels' times include each launch's packing
    and block table (a small kernel ahead of the main one). Returns the
    kernels JSON numbers: f32, 128->128, folded."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input
    from rpst_torch.ops.folded import (fold_bias, fold_conv_kernel,
                                       folded_reflect_pad, unfold)
    from rpst_torch.ops.folded_conv import (
        fused_folded_conv, fused_folded_conv_grad_input,
        fused_folded_conv_grad_input_plain, fused_folded_conv_plain)
    g = torch.Generator().manual_seed(2)
    cl = torch.channels_last
    out = {}
    for n, h, w, c4, c4o in ((1, 256, 256, 128, 128),
                             (1, 128, 128, 512, 512)):
        c, co = c4 // 4, c4o // 4
        x = torch.randn(n, h, w, c4, generator=g)
        gz = torch.randn(n, h, w, c4o, generator=g)
        k3 = torch.randn(3, 3, c, co, generator=g) * (9 * c) ** -0.5
        b = torch.randn(co, generator=g) * 0.1
        kinds = {"folded": fold_conv_kernel(k3),
                 "dense": torch.randn(3, 3, c4, c4o, generator=g)
                 * (9 * c4) ** -0.5}
        for dt in (torch.float32, torch.bfloat16):
            kind, size = ("f32", 4) if dt == torch.float32 else ("bf16", 2)
            xd, gd = x.to(dev, dt), gz.to(dev, dt)
            bu = b.to(dev, dt)
            bd = fold_bias(bu)
            xp = folded_reflect_pad(xd).permute(0, 3, 1, 2)
            gp = gd.permute(0, 3, 1, 2)
            # the unfolded layer: (N, C, 2H, 2W) channels-last views
            xu = unfold(xd).permute(0, 3, 1, 2)
            gu = unfold(gd).permute(0, 3, 1, 2)
            wu = k3.to(dev, dt).permute(3, 2, 0, 1).contiguous(
                memory_format=cl)
            unfolded = {
                "B1": cuda_ms(lambda: F.conv2d(
                    F.pad(xu, (1, 1, 1, 1), mode="reflect"), wu, bu)),
                "B2": cuda_ms(lambda: conv2d_input(
                    (n, c, 2 * h + 2, 2 * w + 2), wu, gu))}
            for kname, kf in kinds.items():
                kd = kf.to(dev, dt).contiguous()
                khat = kd.flip(0, 1).transpose(2, 3).contiguous()
                wf = kd.permute(3, 2, 0, 1).contiguous(memory_format=cl)
                t = {"B1": cuda_ms(lambda: fused_folded_conv(xd, kd, bd, 0.2)),
                     "B1 plain": cuda_ms(
                         lambda: fused_folded_conv_plain(xd, kd, bd, 0.2)),
                     "B1 lib": cuda_ms(lambda: F.conv2d(xp, wf, bd)),
                     "B2": cuda_ms(
                         lambda: fused_folded_conv_grad_input(gd, khat)),
                     "B2 plain": cuda_ms(
                         lambda: fused_folded_conv_grad_input_plain(gd, khat)),
                     "B2 lib": cuda_ms(lambda: conv2d_input(xp.shape, wf, gp))}
                bounds = [folded_bound(n, h, w, c4, c4o, kind, size, s)
                          for s in (False, True)]
                listed = bounds[1] if kname == "folded" else bounds[0]
                tf3 = ""
                if kind == "f32":  # three TF32 products: 3x the operations
                    ops = 2 * 9 * n * h * w * c4 * c4o \
                        // (4 if kname == "folded" else 1)
                    tf3 = (f", 3xTF32 ceiling "
                           f"{3 * ops / PEAK_OPS['f32'] * 1e3:.4f}")
                for op in ("B1", "B2"):
                    unf = (f", unfolded {unfolded[op]:.4f}"
                           if kname == "folded" else "")
                    log("2 kernels", f"{op} ({n},{h},{w},{c4}->{c4o}) "
                        f"{kind} {kname}: {t[op]:.4f} ms vs plain "
                        f"{t[op + ' plain']:.4f}, lib {t[op + ' lib']:.4f}"
                        f"{unf}; bound dense {bounds[0][0]:.4f} / "
                        f"structured {bounds[1][0]:.4f} ms{tf3} "
                        f"({100 * listed[0] / t[op]:.1f}% of the listed "
                        f"blocks' bound; {name_power})")
                if (c4, kind, kname) == (128, "f32", "folded"):
                    for op in ("B1", "B2"):
                        out[op] = {"ms": t[op], "plain_ms": t[op + " plain"],
                                   "library_ms": t[op + " lib"],
                                   "bound": bounds[1]}
    return out


def _counters():
    from rpst_torch.ops.folded_conv import (fused_folded_conv,
                                            fused_folded_conv_grad_input,
                                            fused_folded_conv_grad_weight)
    from rpst_torch.ops.folded_conv2_q8 import fused_folded_conv2_q8
    from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8
    from rpst_torch.ops.flash_attention import (flash_bwd_dkv, flash_bwd_dq,
                                                flash_fwd, flash_fwd_lse)
    from rpst_torch.ops.folded_conv_q8 import fused_folded_conv_q8
    return {"B1": fused_folded_conv, "B2": fused_folded_conv_grad_input,
            "B3": fused_folded_conv_grad_weight, "B4": fused_folded_conv_q8,
            "B7": fused_folded_conv2_q8, "B5": fused_conv2d_q8,
            "B6a": flash_fwd, "B6b": flash_fwd_lse, "B6c": flash_bwd_dq,
            "B6d": flash_bwd_dkv}


def _reset_counts():
    for c in _counters().values():
        c.launches = 0
        if hasattr(c, "launches_bf16"):
            c.launches_bf16 = 0


def _bf16_fwd_counts():
    """(B6a, B6b) launches of the bfloat16 (tensor-core) forward kernel."""
    c = _counters()
    return c["B6a"].launches_bf16, c["B6b"].launches_bf16


def _counts(names=("B1", "B2", "B3")):
    """The launch counts of ``names``: the train step's kernels by default,
    a dict of the q8 path's with ``Q8_KERNELS``."""
    c = _counters()
    if names == Q8_KERNELS:
        return {k: c[k].launches for k in names}
    return tuple(c[k].launches for k in names)


def _grad_dict(model):
    return {n: p.grad.detach().float().clone()
            for n, p in model.named_parameters()}


def _check_grads(label, got, ref):
    """Raise unless every gradient is within GRAD_RTOL and GRAD_ATOL_REL x
    its reference's max; return the worst max abs err / max |ref|."""
    import torch
    worst = 0.0
    for name, r in ref.items():
        a = got[name]
        scale = r.abs().max().item()
        if not (torch.isfinite(a).all() and torch.allclose(
                a, r, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale)):
            raise AssertionError(f"{label} {name}: max abs err "
                                 f"{(a - r).abs().max().item()} vs max |ref| "
                                 f"{scale}")
        worst = max(worst, (a - r).abs().max().item() / max(scale, 1e-30))
    return worst


def _train_fixture(dev):
    """Phase 8: the card's folded train step vs rpst's JAX loss, gradients
    and 3-step trajectory in tests/fixtures/torch_port_train.npz."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (flax_tree_from_npz, from_flax_params,
                                   vgg_from_flax, vgg_weights_from_seed)
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.vgg import VGG19Encoder
    from rpst_torch.train.step import create_train_state, train_step

    with np.load(REPO / "tests" / "fixtures" / "torch_port_train.npz") as npz:
        tree = flax_tree_from_npz(npz)
        fx = {k: npz[k] for k in npz.files if "/" not in k}
    ref_grads = {k: v.to(dev) for k, v in
                 from_flax_params(tree.pop("grads")).items()}
    cfg = load_config(dict(FLAGSHIP, img_size=fx["content"].shape[1],
                           exec_strategy="folded", lr=float(fx["lr"]),
                           lr_decay=float(fx["lr_decay"])))
    bundle = build_model(cfg, dev)
    bundle.load_state_dict(from_flax_params(tree))
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    vgg = vgg.to(dev)
    c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
    _reset_counts()
    total, parts = bundle.loss(vgg, c, s)
    total.backward()
    torch.cuda.synchronize()
    if _counts() != PER_STEP:
        raise AssertionError(f"train fixture: B1/B2/B3 launches {_counts()}, "
                             f"expected {PER_STEP}")
    for k in ("content_loss", "style_loss", "total_loss"):
        got, want = float(parts[k].detach()), float(fx[k])
        if not abs(got - want) <= LOSS_RTOL * abs(want):
            raise AssertionError(f"train fixture {k}: {got} vs rpst {want}")
    worst = _check_grads("train fixture grad", _grad_dict(bundle.model),
                         ref_grads)
    bundle.model.zero_grad(set_to_none=True)
    state = create_train_state(bundle)
    traj = [float(train_step(state, vgg, c, s)["total_loss"])
            for _ in range(len(fx["trajectory"]))]
    if not np.allclose(traj, fx["trajectory"], rtol=LOSS_RTOL, atol=0):
        raise AssertionError(f"train trajectory {traj} vs rpst "
                             f"{fx['trajectory'].tolist()}")
    log("8 train fixture", f"64px b2 f32 vs rpst JAX: loss "
        f"{float(parts['total_loss'].detach()):.7g} vs {float(fx['total_loss']):.7g}; "
        f"worst grad err / max {worst:.3g}; trajectory {traj} vs "
        f"{fx['trajectory'].tolist()}; B1/B2/B3 {PER_STEP} per step")


def _train_parity(dev, rng):
    """Phase 9: 512px b2 f32 loss and gradients, kernel path vs plain path
    vs standard; bf16 vs f32 gradient cosines."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default

    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    vgg, _ = build_vgg(cfg, dev)
    c, s = (torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
            for _ in range(2))
    runs = {}
    for label, over, conv_act in (
            ("kernels", {}, None), ("plain", {}, _plain_act),
            ("standard", {"exec_strategy": "standard"}, None),
            ("bf16", {"compute_dtype": "bfloat16"}, None)):
        bundle = build_model(cfg.replace(**over), dev)
        init_torch_default(bundle.model, cfg.seed)
        kw = {} if conv_act is None else {"conv_act": conv_act}
        _reset_counts()
        total, _ = bundle.loss(vgg, c, s, **kw)
        total.backward()
        torch.cuda.synchronize()
        runs[label] = (float(total.detach()), _grad_dict(bundle.model),
                       _counts())
    if runs["kernels"][2] != PER_STEP or runs["plain"][2] != (0, 0, 0):
        raise AssertionError(f"launches kernels {runs['kernels'][2]}, plain "
                             f"{runs['plain'][2]}")
    loss, grads, _ = runs["kernels"]
    msg = []
    for label in ("plain", "standard"):
        ref_loss, ref_grads, _ = runs[label]
        if not abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss):
            raise AssertionError(f"{IMG}px train loss {loss} vs {label} "
                                 f"{ref_loss}")
        worst = _check_grads(f"{IMG}px train grad vs {label}", grads,
                             ref_grads)
        msg.append(f"vs {label}: loss {loss:.7g} / {ref_loss:.7g}, worst "
                   f"grad err / max {worst:.3g}")
    cos = {}
    for name, a in grads.items():
        b = runs["bf16"][1][name]
        cos[name] = float((a * b).sum() / (a.norm() * b.norm()))
    worst_name = min(cos, key=cos.get)
    if not cos[worst_name] > BF16_COS:
        raise AssertionError(f"bf16 vs f32 gradient cosine {cos[worst_name]} "
                             f"at {worst_name} <= {BF16_COS}")
    log("9 train parity", f"{IMG}px b2 f32 kernels {'; '.join(msg)}; bf16 vs "
        f"f32 worst gradient cosine {cos[worst_name]:.6f} ({worst_name}, "
        f"bound > {BF16_COS}); launches {runs['kernels'][2]}")


def _train_main_path(dev):
    """Phase 10: train_torch.py on a 512px synthetic corpus, b4 f32 folded:
    3 steps as a subprocess, then 2 resumed steps through the same entry
    point in this process, counts reset before and read after. Returns the
    resumed run's B1/B2/B3 launches."""
    import importlib.util
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        out = tmp / "run"
        cfg_path = tmp / "train.yaml"
        cfg_path.write_text(json.dumps(dict(
            FLAGSHIP, img_size=IMG, exec_strategy="folded", batch_size=4,
            max_iter=4, snapshot_save_iter=2, log_iter=1, num_workers=4,
            content_dir=str(tmp / "corpus" / "content"),
            style_dir=str(tmp / "corpus" / "style"), output=str(out))))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / "train_torch.py"), "--config",
             str(cfg_path), "--device", "cuda"], capture_output=True,
            text=True, timeout=600, cwd=str(REPO))
        text = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise AssertionError(f"train_torch.py rc {proc.returncode}:\n"
                                 f"{text[-3000:]}")
        child = [tuple(int(v) for v in ln.rsplit(":", 1)[1].split("/"))
                 for ln in text.splitlines() if "B1/B2/B3 launches:" in ln]
        if child != [tuple(3 * n for n in PER_STEP)]:
            raise AssertionError(f"train_torch.py launches {child}, expected "
                                 f"3 steps x {PER_STEP}:\n{text[-3000:]}")
        rates = [ln.split("img/s ")[1].split(",")[0]
                 for ln in text.splitlines() if "img/s" in ln]
        log("10 train", f"train_torch.py b4 512px f32 folded, 3 steps in "
            f"{time.perf_counter() - t0:.1f}s wall (img/s per step "
            f"{rates}); child launches {child[0]}")

        spec = importlib.util.spec_from_file_location(
            "train_torch", REPO / "train_torch.py")
        driver = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(driver)
        _reset_counts()  # the main path's count starts here
        driver.main(["--config", str(cfg_path), "--device", "cuda", "--set",
                     "resume=true", "max_iter=3"])
        launches = _counts()
        if launches != tuple(2 * n for n in PER_STEP):
            raise AssertionError(f"resumed run launches {launches}, expected "
                                 f"2 steps x {PER_STEP}")
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        steps = [ln["step"] for ln in lines]
        losses = [ln["total_loss"] for ln in lines]
        if steps != [1, 2, 3, 4, 5] or not np.isfinite(losses).all() \
                or any(ln["skipped"] for ln in lines):
            raise AssertionError(f"metrics.jsonl: {lines}")
        ckpts = sorted(int(p.name) for p in (out / "checkpoints").iterdir())
        if ckpts != [2, 3, 5]:
            raise AssertionError(f"checkpoints {ckpts}, expected [2, 3, 5]")
    log("10 train", f"resumed at step 3 for steps 4-5; metrics steps {steps}, "
        f"total_loss {[round(v, 6) for v in losses]}; checkpoints {ckpts}; "
        f"B1/B2/B3 launches {launches} (2 steps x {PER_STEP})")
    return launches


def _train_timing(dev, rng, name_power):
    """Phase 11: the 512px train step (loss, backward, Adam) in img/s at b1
    and b4, f32 and bf16, on three paths, timed with CUDA events."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step

    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    vgg, _ = build_vgg(cfg, dev)
    for batch in (1, 4):
        c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).to(dev)
                for _ in range(2))
        for dt in ("float32", "bfloat16"):
            for path, strategy, kw in (
                    ("folded B1/B2/B3", "folded", {}),
                    ("folded plain", "folded", {"conv_act": _plain_act}),
                    ("standard", "standard", {})):
                bundle = build_model(cfg.replace(exec_strategy=strategy,
                                                 compute_dtype=dt), dev)
                init_torch_default(bundle.model, cfg.seed)
                state = create_train_state(bundle)
                ms = cuda_ms(lambda: train_step(state, vgg, c, s, **kw),
                             iters=5, warmup=2)
                log("11 train timing", f"{IMG}px b{batch} {dt:8s} {path:16s}: "
                    f"{ms:9.3f} ms/step {batch * 1e3 / ms:8.2f} img/s "
                    f"({name_power})")
                del state, bundle
                torch.cuda.empty_cache()


# ---------------------------------------------------------------- q8

Q8_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_q8.npz"
# the q8 gates: stats at rpst's tests/test_q8.py:213-218; the stylize vs
# rpst at PSNR >= 40 dB and MAE < 1e-3 (a one-ulp AdaIN difference can move
# a decoder requantization by one step); vs folded f32 at rpst's
# tests/test_q8.py:74 PSNR > 30 dB
Q8_STATS_RTOL, Q8_STATS_ATOL = 1e-4, 1e-3
Q8_FIXTURE_PSNR, Q8_FIXTURE_MAE, Q8_VS_FOLDED_PSNR = 40.0, 1e-3, 30.0
Q8_KERNELS = ("B1", "B4", "B7")  # the kernels a q8 stylize launches


def _psnr(got, ref):
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mse = float(np.mean((got - ref) ** 2))
    span = float(ref.max() - ref.min()) or 1.0
    return 10 * np.log10(span * span / max(mse, 1e-30))


def _q8_plan(bundle, fuse_pairs):
    """The scales and B1/B4/B7 launches one q8 stylize derives from the
    bundle's layers (``fast_path_q8.q8_plan``)."""
    import torch
    from rpst_torch.models.fast_path_q8 import q8_plan
    enc, dec = bundle.folded_weights(torch.float32)
    return q8_plan([k for k, _ in enc], [k for k, _ in dec], fuse_pairs)


def _q8_layer(rng, dev, n, h, w, c4, c4o, out_scale=0.05):
    import numpy as np
    import torch
    x = rng.integers(-127, 128, (n, h, w, c4), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c4, c4o), dtype=np.int8)
    sc = np.stack([rng.uniform(2e-6, 6e-6, c4o), rng.normal(0, 0.2, c4o),
                   np.full(c4o, 1.0 / out_scale)]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, k, sc))


def _bf16_ulps(a, b):
    """Max distance in bf16 steps between two bf16 tensors (bit patterns
    mapped to a monotonic integer order, -0 == +0)."""
    import torch

    def order(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (order(a) - order(b)).abs().max().item()


def _q8_compare(label, got, ref):
    """int8: identical; bf16: within one ulp; float32 sums: Q8_STATS_*.
    Returns (max abs err, detail)."""
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    if got.dtype == torch.int8:
        ndiff = (got != ref).sum().item()
        if ndiff:
            raise AssertionError(f"{label}: {ndiff} int8 elements differ")
        return err, "int8 identical"
    if got.dtype == torch.bfloat16:
        ulps = _bf16_ulps(got, ref)
        if ulps > 1:
            raise AssertionError(f"{label}: bf16 {ulps} ulps apart")
        return err, f"bf16 within {ulps} ulp"
    if not (torch.isfinite(got).all() and torch.allclose(
            got, ref, rtol=Q8_STATS_RTOL, atol=Q8_STATS_ATOL)):
        raise AssertionError(f"{label}: max abs err {err}")
    return err, f"sums err {err:.3g}"


def _q8_case(rng, dev, n, h, w, c4, c4o, dense, out_scale=0.05):
    """x_q, w_q and scales of a (4C -> 4Co) int8 layer (``_q8_layer``), w_q
    dense random int8 or a quantized ``fold_conv_kernel`` of a random image
    kernel: 36 of its 144 blocks non-zero, the blocks B4 and B7 take."""
    import torch
    from rpst_torch.ops.folded import fold_conv_kernel
    from rpst_torch.ops.folded_conv_q8 import quantize_weights
    x, k, sc = _q8_layer(rng, dev, n, h, w, c4, c4o, out_scale)
    if not dense:
        k3 = torch.from_numpy(rng.standard_normal(
            (3, 3, c4 // 4, c4o // 4)).astype("float32"))
        k = quantize_weights(fold_conv_kernel(k3))[0].to(dev).contiguous()
    return x, k, sc


# B4 (N, H, W, 4C, 4Co): the path's shape, a ragged one, and the edges of
# the tensor-core tilings: N = 3 and W = 33; H = 2, W = 37, 4C = 16 (a
# 32-channel K step spans the four input blocks) and 4Co = 132 (contiguous
# channels, two channel tiles); 4Co = 4 (the narrow tiling)
B4_CASES = (("path (1,256,256,128->128)", (1, 256, 256, 128, 128)),
            ("ragged (2,38,22,128->128)", (2, 38, 22, 128, 128)),
            ("edge (3,10,33,128->128)", (3, 10, 33, 128, 128)),
            ("edge (1,2,37,16->132)", (1, 2, 37, 16, 132)),
            ("edge (2,9,17,128->4)", (2, 9, 17, 128, 4)))


def _q8_kernels(dev, name_power):
    """Phase 12: B4 vs its plain version (float64 conv, exact integer sums)
    at the path's shape and the tilings' edges, with a quantized fold (36
    listed blocks) and a dense kernel, and B7's six outputs equal to two B4
    launches; each timed against its plain version at the path's shape,
    beside B1 bf16 there (the rival q8 must beat). Returns the kernels JSON
    numbers (B4 and B7 with folded kernels)."""
    import numpy as np
    import torch
    from rpst_torch.ops.folded import fold_bias, fold_conv_kernel
    from rpst_torch.ops.folded_conv import fused_folded_conv
    from rpst_torch.ops.folded_conv2_q8 import (fused_folded_conv2_q8,
                                                fused_folded_conv2_q8_plain)
    from rpst_torch.ops.folded_conv_q8 import (fused_folded_conv_q8,
                                               fused_folded_conv_q8_plain)
    rng = np.random.default_rng(2)
    out = {"B4": {"err": 0.0}, "B7": {"err": 0.0}}
    with torch.inference_mode():
        for label, shape in B4_CASES:
            for dense in (False, True):
                kind = "dense" if dense else "folded"
                x, k, sc = _q8_case(rng, dev, *shape, dense)
                msg = []
                for out_int8 in (True, False):
                    for stats in (False, True):
                        got = fused_folded_conv_q8(x, k, sc, out_int8, stats)
                        torch.cuda.synchronize()
                        ref = fused_folded_conv_q8_plain(x, k, sc, out_int8,
                                                         stats)
                        got, ref = ((got, ref) if stats
                                    else ((got,), (ref,)))
                        for i, (g, r) in enumerate(zip(got, ref)):
                            e, d = _q8_compare(
                                f"B4 {label} {kind} out_int8={out_int8} "
                                f"stats={stats} [{i}]", g, r)
                            out["B4"]["err"] = max(out["B4"]["err"], e)
                            msg.append(d)
                log("12 q8 kernels", f"B4 {label} {kind}, 4 modes: "
                    f"{'; '.join(sorted(set(msg)))}")
        for label, shape in B4_CASES[:2]:
            n, h, w, c4, _ = shape
            for dense in (False, True):
                x, k, sc = _q8_case(rng, dev, *shape, dense)
                _, k2, sc2 = _q8_case(rng, dev, n, h, w, 128, 128, dense,
                                      0.02)
                for out_int8 in (True, False):
                    got = fused_folded_conv2_q8(x, k, sc, k2, sc2, out_int8,
                                                True)
                    y1, s11, s12 = fused_folded_conv_q8(x, k, sc, True, True)
                    y2, s21, s22 = fused_folded_conv_q8(y1, k2, sc2,
                                                        out_int8, True)
                    torch.cuda.synchronize()
                    for i, (g, r) in enumerate(zip(
                            got, (y1, y2, s11, s12, s21, s22))):
                        if not torch.equal(g, r):
                            raise AssertionError(
                                f"B7 {label} out_int8={out_int8} [{i}]: "
                                f"{(g != r).sum().item()} elements differ "
                                "from two B4 launches")
                    ref = fused_folded_conv2_q8_plain(x, k, sc, k2, sc2,
                                                      out_int8, True)
                    for i, (g, r) in enumerate(zip(got, ref)):
                        e, _ = _q8_compare(f"B7 {label} vs plain [{i}]", g, r)
                        out["B7"]["err"] = max(out["B7"]["err"], e)
                    log("12 q8 kernels", f"B7 {label} "
                        f"{'dense' if dense else 'folded'} out_int8="
                        f"{out_int8}: six outputs equal to two B4 launches")
        t = {}
        for dense in (False, True):
            kind = "dense" if dense else "folded"
            x, k, sc = _q8_case(rng, dev, 1, 256, 256, 128, 128, dense)
            _, k2, sc2 = _q8_case(rng, dev, 1, 256, 256, 128, 128, dense,
                                  0.02)
            t[kind] = {
                "B4": cuda_ms(lambda: fused_folded_conv_q8(x, k, sc, True,
                                                           True)),
                "B4 plain": cuda_ms(lambda: fused_folded_conv_q8_plain(
                    x, k, sc, True, True), iters=5, warmup=1),
                "B4 bf16": cuda_ms(lambda: fused_folded_conv_q8(x, k, sc,
                                                                False)),
                "B7": cuda_ms(lambda: fused_folded_conv2_q8(
                    x, k, sc, k2, sc2, True, True)),
                "B7 plain": cuda_ms(lambda: fused_folded_conv2_q8_plain(
                    x, k, sc, k2, sc2, True, True), iters=5, warmup=1),
                "2xB4": cuda_ms(lambda: fused_folded_conv_q8(
                    fused_folded_conv_q8(x, k, sc, True, True)[0], k2, sc2,
                    True, True))}
        # the rival: B1 in bfloat16 on the same layer's float form
        g = torch.Generator().manual_seed(3)
        xb = torch.randn(1, 256, 256, 128, generator=g).to(dev, torch.bfloat16)
        kb = fold_conv_kernel(torch.randn(3, 3, 32, 32, generator=g)
                              * (9 * 32) ** -0.5).to(dev, torch.bfloat16)
        bb = fold_bias(torch.randn(32, generator=g) * 0.1).to(dev,
                                                              torch.bfloat16)
        t["B1 bf16"] = cuda_ms(lambda: fused_folded_conv(
            xb, kb.contiguous(), bb, 0.2))
    bnd = {kind: (q8_bound(1, 256, 256, 128, 128, kind == "folded")[0],
                  q8_bound(1, 256, 256, 128, 128, kind == "folded",
                           layers=2)[0]) for kind in t if kind != "B1 bf16"}
    for kind in ("folded", "dense"):
        tk = t[kind]
        log("12 q8 kernels", f"(1,256,256,128->128) {kind} kernel, ms: B4 "
            f"int8+stats {tk['B4']:.4f} vs plain {tk['B4 plain']:.4f} "
            f"(bound {bnd[kind][0]:.4f}, {100 * bnd[kind][0] / tk['B4']:.1f}"
            f"%); B4 bf16 {tk['B4 bf16']:.4f}; B7 pair {tk['B7']:.4f} vs "
            f"plain {tk['B7 plain']:.4f} vs two B4 {tk['2xB4']:.4f} (bound "
            f"{bnd[kind][1]:.4f}); B1 bf16 {t['B1 bf16']:.4f} "
            f"({name_power})")
    out["B4"].update(ms=t["folded"]["B4"], plain_ms=t["folded"]["B4 plain"])
    out["B7"].update(ms=t["folded"]["B7"], plain_ms=t["folded"]["B7 plain"])
    return out


def _q8_fixture(dev):
    """Phase 13: the q8 stylize on the card with rpst's act scales vs
    rpst's JAX output, f32 and bf16; exact launches; fuse_pairs bit-equal."""
    import numpy as np
    import torch
    from rpst_torch.bridge import load_weights
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    with np.load(Q8_FIXTURE) as fx:
        fx = {k: fx[k] for k in ("content", "style", "act_scales", "out_f32",
                                 "out_bf16")}
    bundle = build_model(load_config(dict(
        FLAGSHIP, img_size=fx["content"].shape[1])), dev)
    bundle.load_state_dict(load_weights(Q8_FIXTURE))
    c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
    scales = {"act_scales": fx["act_scales"]}
    outs, msg = {}, []
    for fuse in (False, True):
        plan = _q8_plan(bundle, fuse)
        if plan["scales"] != len(fx["act_scales"]):
            raise AssertionError(f"plan {plan} vs {len(fx['act_scales'])} "
                                 "fixture scales")
        want = {k: plan[k] for k in Q8_KERNELS}
        for dt, key in ((torch.float32, "out_f32"),
                        (torch.bfloat16, "out_bf16")):
            _reset_counts()
            y = bundle.stylize_q8(c, s, scales, dtype=dt, fuse_pairs=fuse)
            torch.cuda.synchronize()
            if _counts(Q8_KERNELS) != want:
                raise AssertionError(f"q8 fixture launches {_counts(Q8_KERNELS)}, "
                                     f"expected {want}")
            got = y.cpu().numpy()
            psnr, mae = _psnr(got, fx[key]), float(
                np.abs(got - fx[key]).mean())
            if not (np.isfinite(got).all() and psnr >= Q8_FIXTURE_PSNR
                    and mae < Q8_FIXTURE_MAE):
                raise AssertionError(f"q8 fixture {key} fuse_pairs={fuse}: "
                                     f"PSNR {psnr} dB, MAE {mae}")
            outs[(fuse, key)] = y
            if not fuse:
                msg.append(f"{key} PSNR {psnr:.2f} dB, MAE {mae:.3g}, max "
                           f"{float(np.abs(got - fx[key]).max()):.3g}")
        msg.append(f"fuse_pairs={fuse} launches {want}")
    for key in ("out_f32", "out_bf16"):
        if not torch.equal(outs[(False, key)], outs[(True, key)]):
            raise AssertionError(f"q8 fixture {key}: fuse_pairs changed it")
    log("13 q8 fixture", f"64px rp5 h32 vs rpst JAX (interpret): "
        f"{'; '.join(msg)}; fuse_pairs bit-equal")


def _q8_parity(dev, rng):
    """Phase 14: 512px b2 q8 (bf16, as served) vs the port's folded f32
    path, and fuse_pairs bit-equal."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    bundle = build_model(cfg, dev)
    init_torch_default(bundle.model, cfg.seed)
    c, s = (torch.from_numpy(rng.random((2, IMG, IMG, 3),
                                        np.float32)).to(dev)
            for _ in range(2))
    scales = bundle.calibrate_q8(c, s)
    q8 = bundle.stylize_q8(c, s, scales, fuse_pairs=False)
    pairs = bundle.stylize_q8(c, s, scales, fuse_pairs=True)
    folded = bundle.stylize(c, s, folded=True)
    torch.cuda.synchronize()
    psnr = _psnr(q8.cpu().numpy(), folded.cpu().numpy())
    if not (torch.isfinite(q8).all() and psnr > Q8_VS_FOLDED_PSNR):
        raise AssertionError(f"512px q8 vs folded f32: PSNR {psnr} dB")
    if not torch.equal(q8, pairs):
        raise AssertionError("512px fuse_pairs output differs from unfused")
    log("14 q8 parity", f"512px b2 q8 (bf16) vs folded f32: PSNR {psnr:.2f} "
        f"dB (bound > {Q8_VS_FOLDED_PSNR}); fuse_pairs bit-equal; "
        f"{len(scales['act_scales'])} act scales")


def _q8_serve(dev, rng):
    """Phase 15: the int8 main path through the user's entry points, unfused
    and with fuse_pairs, counts reset before and read after each; then
    serve_torch.py --mode q8. Returns the main path's B1/B4/B7 launches."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.config import load_config
    from rpst_torch.data import load_image
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.policy import FUSE_PAIRS
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    launches = {"B1": 0, "B4": 0, "B7": 0}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("content", "style"):
            (tmp / sub).mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        cfg_path = tmp / "cfg.yaml"
        cfg_path.write_text(json.dumps(dict(FLAGSHIP, img_size=IMG)))
        cfg = load_config(str(cfg_path), {"exec_strategy": "folded"})
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        mode = resolve_mode(bundle, "q8", batch=4)
        if mode != "q8":
            raise AssertionError(f"resolve_mode q8 gave {mode}")
        imgs = [load_image(tmp / "content" / f"c{i}.png", IMG)
                for i in range(8)]
        style_img = load_image(tmp / "style" / "s.png", IMG)
        calib = torch.from_numpy(np.stack(imgs[:4])).to(dev)
        scales = calibrate_scales(bundle, calib, torch.from_numpy(
            style_img)[None].to(dev).expand_as(calib).contiguous())
        for fuse in (False, True):
            plan = _q8_plan(bundle, fuse)
            if len(scales["act_scales"]) != plan["scales"]:
                raise AssertionError(f"{len(scales['act_scales'])} scales, "
                                     f"plan {plan}")
            run = make_run_impl(bundle, mode, scales, fuse_pairs=fuse)
            batcher = DynamicBatcher(run, batch_size=4, max_wait_ms=50.0,
                                     device=dev)
            _reset_counts()  # this main path's count starts here
            try:
                outs = [f.result(timeout=300) for f in
                        [batcher.submit(im, style_img) for im in imgs]]
            finally:
                batcher.close()
            got = _counts(Q8_KERNELS)
            batches = batcher.stats()["batches"]
            want = {k: batches * plan[k] for k in Q8_KERNELS}
            if got != want:
                raise AssertionError(f"q8 main path fuse_pairs={fuse}: "
                                     f"launches {got}, expected {want} "
                                     f"({batches} batches x {plan})")
            for o in outs:
                if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                    raise AssertionError(f"q8 main path output {o.shape}")
            for k in launches:
                launches[k] += got[k]
            log("15 q8 serve", f"8 requests via DynamicBatcher(b4), "
                f"fuse_pairs={fuse}: {batcher.stats()}, launches {got} "
                f"({batches} batches x {plan})")

        swept = tmp / "swept"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / "serve_torch.py"),
             "--config", str(cfg_path), "--content", str(tmp / "content"),
             "--style", str(tmp / "style" / "s.png"), "--out", str(swept),
             "--mode", "q8", "--batch", "4", "--device", "cuda"],
            capture_output=True, text=True, timeout=300, cwd=str(REPO))
        text = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise AssertionError(f"serve_torch q8 rc {proc.returncode}:\n"
                                 f"{text[-3000:]}")
        plan = _q8_plan(bundle, FUSE_PAIRS)
        child = {k: _logged_count(text, k) for k in Q8_KERNELS}
        want = {k: 2 * plan[k] for k in Q8_KERNELS}  # 2 batches
        # + calibration: one bf16 folded forward, B1 on every layer
        enc, dec = bundle.folded_weights(torch.float32)
        want["B1"] += 2 * len(enc) + len(dec)
        pngs = sorted(swept.glob("*.png"))
        if (len(pngs) != 8 or child != want or not child["B4"] > 0
                or f"Calibrated {plan['scales']} layer scales" not in text):
            raise AssertionError(f"serve_torch q8: {len(pngs)} PNGs, child "
                                 f"launches {child} vs {want}:\n"
                                 f"{text[-3000:]}")
        rate = [ln for ln in text.splitlines() if "Stylized" in ln]
        log("15 q8 serve", f"serve_torch.py --mode q8: 8 PNGs, 'Calibrated "
            f"{plan['scales']} layer scales', child launches {child}, "
            f"{time.perf_counter() - t0:.1f}s wall; "
            f"{rate[-1].split(' - ')[-1] if rate else ''}")
    return launches


def _logged_count(text, label):
    """The count serve_torch.py logs as '<label> <kernel> launches: N'."""
    counts = [int(ln.rsplit(":", 1)[1]) for ln in text.splitlines()
              if f" - {label} " in ln and " launches:" in ln]
    return counts[-1] if counts else None


def _q8_timing(dev, rng, name_power, rows):
    """Phase 16: 512px q8 stylize b1/b8 (bf16, as served), with B4 alone
    and with B7 pairs, beside folded B1 and standard in bfloat16, all four
    in both orders in this call (the A/B of policy.FUSE_PAIRS and
    Q8_AUTO_BATCHES), CUDA events; then phase 7's rows."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.models.fast_path import stylize_multi_adain_folded
    from rpst_torch.nn.blocks import init_torch_default
    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    bundle = build_model(cfg, dev)
    init_torch_default(bundle.model, cfg.seed)
    std = build_model(cfg.replace(exec_strategy="standard"), dev)
    std.load_state_dict(bundle.model.state_dict())
    bf = torch.bfloat16
    w = bundle.folded_weights(bf)
    with torch.inference_mode():
        for batch in (1, 8):
            c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                np.float32)).to(dev)
                    for _ in range(2))
            scales = bundle.calibrate_q8(c, s)
            paths = {
                "q8 B4": lambda: bundle.stylize_q8(c, s, scales,
                                                   fuse_pairs=False),
                "q8 B7 pairs": lambda: bundle.stylize_q8(c, s, scales,
                                                         fuse_pairs=True),
                "folded B1": lambda: stylize_multi_adain_folded(
                    w, c, s, dtype=bf),
                "standard": lambda: _standard(std, c, s, bf)}
            order = list(paths)
            for path in order + order[::-1]:
                ms = cuda_ms(paths[path], iters=10)
                log("16 q8 timing", f"512px b{batch} bfloat16 {path:12s}: "
                    f"{ms:8.3f} ms  {batch * 1e3 / ms:8.2f} img/s  "
                    f"({name_power})")
            for b, dt, path, ms in rows:
                if b == batch and path != "folded plain":
                    log("16 q8 timing", f"512px b{batch} {dt:8s} {path:12s}: "
                        f"{ms:8.3f} ms  {batch * 1e3 / ms:8.2f} img/s  "
                        f"(phase 7, {name_power})")


# ---------------------------------------------------------------- B5

WIDE = dict(rp_blocks=5, hidden_dim=32, seed=0)
ADAIN_YAML = REPO / "configs" / "train_deeper_rp_adain.yaml"  # hidden 16
# every shape the paths give B5, (label, (N, H, W, C, Co), pad): the four
# eligible layers of a 512px adain / wct stylize at hidden 32 (encoder on
# the 2N batch, checked at 2N = 2; decoder at N = 2), the six of the
# int8 VGG targets at 512px (conv_6..8 share one shape), and the six shapes
# a 512px SANet q8 stylize adds at batch 1 (the deeper VGG stages on the 2N
# batch, the mirror decoder's conv0 .. conv5)
B5_SHAPES = (
    ("adain enc 128->256", (2, 512, 512, 128, 256), "zero"),
    ("adain enc 256->512", (2, 512, 512, 256, 512), "zero"),
    ("adain dec 512->256", (2, 512, 512, 512, 256), "zero"),
    ("adain dec 256->128", (2, 512, 512, 256, 128), "zero"),
    ("VGG conv_4 128->128", (2, 256, 256, 128, 128), "reflect"),
    ("VGG conv_5 128->256", (2, 128, 128, 128, 256), "reflect"),
    ("VGG conv_6..8 256->256", (2, 128, 128, 256, 256), "reflect"),
    ("VGG conv_9 256->512", (2, 64, 64, 256, 512), "reflect"),
    ("VGG conv_10..12 512->512", (2, 64, 64, 512, 512), "reflect"),
    ("VGG conv_13 512->512", (2, 32, 32, 512, 512), "reflect"),
    ("mirror conv0 512->256", (1, 64, 64, 512, 256), "reflect"),
    ("mirror conv1..3 256->256", (1, 128, 128, 256, 256), "reflect"),
    ("mirror conv4 256->128", (1, 128, 128, 256, 128), "reflect"),
    ("mirror conv5 128->128", (1, 256, 256, 128, 128), "reflect"))
B5_WIDEST = "adain enc 256->512"
# (N, H, W, C, Co) at the edges of B5's tilings (16 pixel columns x 8 rows,
# 64 or 128 output channels, 32 input channels a step): the k tail at C = 4,
# 36, 48; Co = 4 and 132; H or W = 2; W = 33, 37
B5_EDGES = ((1, 2, 2, 4, 4), (1, 2, 37, 48, 4), (2, 9, 2, 4, 132),
            (1, 5, 17, 36, 68), (3, 16, 33, 128, 192))
WIDE_F32_TOL, WCT_F32_TOL = 1e-4, 1e-3  # wct: two 512x512 eigh in float32
Q8T_LOSS_RTOL = 5e-3  # tests/test_torch_q8_targets.py states the reason


def _b5_layer(rng, dev, n, h, w, c, co):
    import numpy as np
    import torch
    x = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c, co), dtype=np.int8)
    sc = np.stack([rng.uniform(2e-6, 6e-6, co) * (128 / c),
                   rng.normal(0, 0.2, co),
                   rng.uniform(10.0, 40.0, co)]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, k, sc))


def _b5_kernels(dev, name_power):
    """Phase 17: B5 and its bf16 mode against their plain versions, and
    B5's time per path shape beside its plain version, the one library call
    and its bound. Returns the kernels JSON numbers (at B5_WIDEST)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from rpst_torch.ops.conv2d_q8 import (fused_conv2d_bf16,
                                          fused_conv2d_bf16_plain,
                                          fused_conv2d_q8,
                                          fused_conv2d_q8_plain,
                                          pack_conv2d_weights)
    rng = np.random.default_rng(5)
    out = {"err": 0.0}
    with torch.inference_mode():
        # the edges of the tilings, both pads, both outputs, bits compared
        for shape in B5_EDGES:
            x, k, sc = _b5_layer(rng, dev, *shape)
            for pad in ("reflect", "zero"):
                for out_int8 in (True, False):
                    got = fused_conv2d_q8(x, k, sc, out_int8, 0.2, pad)
                    torch.cuda.synchronize()
                    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, 0.2, pad)
                    e, _ = _q8_compare(f"B5 edge {shape} {pad} out_int8="
                                       f"{out_int8}", got, ref)
                    if not out_int8 and not torch.equal(
                            got.view(torch.int16), ref.view(torch.int16)):
                        raise AssertionError(f"B5 edge {shape} {pad}: bf16 "
                                             "bits differ")
                    out["err"] = max(out["err"], e)
            log("17 B5 kernels", f"edge {shape}: int8 identical, bf16 bits "
                "equal, both pads")
        # every mode at an odd shape: H != W, W no multiple of the 16-wide
        # tile, Co past one 128-channel block
        x, k, sc = _b5_layer(rng, dev, 2, 13, 37, 36, 132)
        for alpha in (0.0, 0.2, 1.0):
            for pad in ("reflect", "zero"):
                msg = []
                for out_int8 in (True, False):
                    got = fused_conv2d_q8(x, k, sc, out_int8, alpha, pad)
                    torch.cuda.synchronize()
                    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, alpha,
                                                pad)
                    e, d = _q8_compare(f"B5 odd alpha={alpha} {pad} "
                                       f"out_int8={out_int8}", got, ref)
                    if not out_int8:
                        d += (", bits equal (-0.0 kept)" if torch.equal(
                            got.view(torch.int16), ref.view(torch.int16))
                            else ", bits differ")
                    out["err"] = max(out["err"], e)
                    msg.append(d)
                log("17 B5 kernels", f"odd (2,13,37,36->132) alpha={alpha} "
                    f"{pad}: {'; '.join(msg)}")
        # the paths' shapes, relu (alpha = 0), both outputs; then timed
        for label, shape, pad in B5_SHAPES:
            n, h, w, c, co = shape
            x, k, sc = _b5_layer(rng, dev, *shape)
            msg = []
            for out_int8 in (True, False):
                got = fused_conv2d_q8(x, k, sc, out_int8, 0.0, pad)
                torch.cuda.synchronize()
                ref = fused_conv2d_q8_plain(x, k, sc, out_int8, 0.0, pad)
                e, d = _q8_compare(f"B5 {label} out_int8={out_int8}", got,
                                   ref)
                out["err"] = max(out["err"], e)
                msg.append(d)
                del got, ref
            # as the paths call it: the layer keeps its packed weights
            kp = pack_conv2d_weights(k)
            ms = cuda_ms(lambda: fused_conv2d_q8(x, k, sc, True, 0.0, pad,
                                                 w_packed=kp), iters=10)
            plain = cuda_ms(lambda: fused_conv2d_q8_plain(x, k, sc, True, 0.0,
                                                          pad),
                            iters=3, warmup=1)
            # the one library call: conv + bias in bfloat16 on the
            # dequantized values, channels-last as B5 reads them (no
            # activation, no requantization; reflect pads outside the call)
            xd = (x.float() * 0.01).to(torch.bfloat16).permute(0, 3, 1, 2)
            wd = (k.float() * 0.01).to(torch.bfloat16).permute(3, 2, 0, 1) \
                .contiguous(memory_format=torch.channels_last)
            bd = sc[1].to(torch.bfloat16)
            lib = cuda_ms(lambda: F.conv2d(xd, wd, bd, padding=1), iters=10)
            b_ms, b_by = conv_bound(n, h, w, c, co, "int8", 1, [1],
                                    extra_bytes=3 * co * 4)
            log("17 B5 kernels", f"{label} {shape} {pad}: {'; '.join(msg)}; "
                f"B5 {ms:.4f} ms vs plain {plain:.4f}, F.conv2d bf16 "
                f"{lib:.4f}; bound {b_ms:.4f} ms by {b_by} "
                f"({100 * b_ms / ms:.1f}% of it reached; {name_power})")
            if label == B5_WIDEST:
                out.update(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b_ms, bound_by=b_by)
            del x, k, kp, sc, xd, wd
            torch.cuda.empty_cache()
        # the bf16 mode, at the widest VGG shape and an odd one
        g = torch.Generator().manual_seed(6)
        for shape in ((2, 128, 128, 256, 256), (2, 9, 19, 40, 72)):
            n, h, w, c, co = shape
            x = torch.randn(n, h, w, c, generator=g).to(dev)
            k = (torch.randn(3, 3, c, co, generator=g) * (9 * c) ** -0.5).to(
                dev)
            b = torch.randn(co, generator=g).to(dev)
            for pad in ("reflect", "zero"):
                for alpha in (0.0, 0.2, 1.0):
                    got = fused_conv2d_bf16(x, k, b, alpha, pad)
                    torch.cuda.synchronize()
                    err, _ = check_close(
                        f"B5 bf16 mode {shape} {pad} alpha={alpha}", got,
                        fused_conv2d_bf16_plain(x, k, b, alpha, pad),
                        BF16_TOL)
                    log("17 B5 kernels", f"bf16 mode {shape} {pad} "
                        f"alpha={alpha}: max abs err {err:.3g} (tol "
                        f"{BF16_TOL})")
            if c == 256:
                xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
                xd = xb.permute(0, 3, 1, 2)
                wd = kb.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                bd = b.to(torch.bfloat16)
                t = (cuda_ms(lambda: fused_conv2d_bf16(xb, kb, b, 0.0)),
                     cuda_ms(lambda: fused_conv2d_bf16_plain(x, k, b, 0.0)),
                     cuda_ms(lambda: F.conv2d(F.pad(xd, (1, 1, 1, 1),
                                                    mode="reflect"), wd, bd)))
                b_ms, b_by = conv_bound(n, h, w, c, co, "bf16", 2, [2])
                log("17 B5 kernels", f"bf16 mode {shape}: {t[0]:.4f} ms "
                    f"(weights repacked per call) vs plain {t[1]:.4f}, "
                    f"reflect pad + F.conv2d bf16 {t[2]:.4f}; bound "
                    f"{b_ms:.4f} ms by {b_by} ({100 * b_ms / t[0]:.1f}% of "
                    f"it reached; {name_power})")
    return out


def _rpseq_bundle(network, dev, size, seed=0, **over):
    """A bundle of adain / wct at full width with the weights that
    ``rpseq_weights_from_seed(seed)`` draws (the fixtures' weights)."""
    from rpst_torch.bridge import from_flax_params, rpseq_weights_from_seed
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    bundle = build_model(load_config(dict(WIDE, network=network,
                                          img_size=size, **over)), dev)
    bundle.load_state_dict(from_flax_params(rpseq_weights_from_seed(
        seed, WIDE["rp_blocks"], WIDE["hidden_dim"])))
    return bundle


def _wide_fixtures(dev):
    """Phase 18: adain and wct on the card vs rpst's JAX outputs."""
    import numpy as np
    import torch
    from rpst_torch.models.fast_path_q8_std import std_q8_plan
    for network, tol in (("adain", WIDE_F32_TOL), ("wct", WCT_F32_TOL)):
        with np.load(REPO / "tests" / "fixtures" /
                     f"torch_port_{network}.npz") as npz:
            fx = {k: npz[k] for k in npz.files}
        bundle = _rpseq_bundle(network, dev, fx["content"].shape[1],
                               int(fx["weights_seed"]))
        c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
        plan = std_q8_plan(*bundle.std_weights(torch.float32))
        if plan != {"scales": len(fx["act_scales"]), "B5": 4}:
            raise AssertionError(f"{network} plan {plan}")
        _reset_counts()
        out = bundle.stylize(c, s)
        torch.cuda.synchronize()
        err, mae = check_close(f"{network} fixture standard f32", out,
                               torch.from_numpy(fx["out_f32"]).to(dev), tol)
        msg = [f"standard f32 max abs err {err:.3g}, MAE {mae:.3g} (tol "
               f"{tol})"]
        scales = {"act_scales": fx["act_scales"]}
        # float32 at phase 13's PSNR gate; its MAE bound doubles (the CPU
        # rehearsal read 8e-4 to 9e-4): the narrow float32 layers' sums
        # differ in the last bit between conv libraries, which moves a few
        # first-quantization boundaries, and four int8 layers of up to 512
        # channels (and wct's eigendecompositions) spread that. In bfloat16
        # the six narrow layers round at different places in the two
        # frameworks: rpst's own q8-vs-float gate (30 dB) and the bf16
        # serving MAE bound (1e-2)
        for dt, key, min_psnr, max_mae in (
                (torch.float32, "out_q8_f32", Q8_FIXTURE_PSNR,
                 2 * Q8_FIXTURE_MAE),
                (torch.bfloat16, "out_q8_bf16", Q8_VS_FOLDED_PSNR, 1e-2)):
            _reset_counts()
            got = bundle.stylize_q8(c, s, scales, dtype=dt).cpu().numpy()
            n_b5 = _counters()["B5"].launches
            psnr = _psnr(got, fx[key])
            mae = float(np.abs(got - fx[key]).mean())
            if not (np.isfinite(got).all() and psnr >= min_psnr
                    and mae < max_mae and n_b5 == plan["B5"]):
                raise AssertionError(f"{network} fixture {key}: PSNR {psnr} "
                                     f"dB, MAE {mae}, {n_b5} B5 launches")
            msg.append(f"{key} PSNR {psnr:.2f} dB, MAE {mae:.3g}")
        own = bundle.calibrate_q8(c, s)["act_scales"]
        if not np.allclose(own, fx["act_scales"], rtol=2e-2):
            raise AssertionError(f"{network} calibration {own} vs rpst "
                                 f"{fx['act_scales']}")
        log("18 wide fixtures", f"{network} 64px rp5 h32 b2 vs rpst JAX: "
            f"{'; '.join(msg)}; {plan['B5']} B5 launches per q8 stylize; "
            f"{plan['scales']} scales within 2e-2 of rpst's")


def _q8_targets_fixture(dev):
    """Phase 19: the int8 VGG targets and their loss on the card vs rpst."""
    import numpy as np
    import torch
    from rpst_torch.bridge import vgg_from_flax, vgg_weights_from_seed
    from rpst_torch.models.fast_path_q8_std import (calibrate_vgg_targets_q8,
                                                    vgg_q8_plan,
                                                    vgg_target_taps_q8)
    from rpst_torch.nn.vgg import VGG19Encoder
    from rpst_torch.nn.vgg_folded import perceptual_rp_losses_q8targets
    from rpst_torch.ops.stats import calc_mean_std
    with np.load(REPO / "tests" / "fixtures" /
                 "torch_port_q8_targets.npz") as npz:
        fx = {k: npz[k] for k in npz.files}
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    vgg = vgg.to(dev)
    c, s, x = (torch.from_numpy(fx[k]).to(dev)
               for k in ("content", "style", "stylized"))
    scales = {"act_scales": fx["act_scales"]}
    plan = vgg_q8_plan(vgg)
    if plan != {"scales": len(fx["act_scales"]), "B5": B5_PER_TARGET_PASS}:
        raise AssertionError(f"VGG q8 plan {plan}")
    _reset_counts()
    taps = vgg_target_taps_q8(vgg, scales, torch.cat([s, c]), torch.float32)
    torch.cuda.synchronize()
    if _counters()["B5"].launches != B5_PER_TARGET_PASS:
        raise AssertionError(f"{_counters()['B5'].launches} B5 launches for "
                             "one target pass")
    msg = []
    for i, t in enumerate(taps):
        if i < 2:
            # relu1_1, relu2_1 come from float convs: their statistics
            m, sd = calc_mean_std(t.float())
            for name, got in (("mean", m), ("std", sd)):
                ref = torch.from_numpy(fx[f"tap_{name}_{i}"]).to(dev)
                if not torch.allclose(got[:, 0, 0, :], ref, rtol=1e-3,
                                      atol=1e-4 * float(ref.abs().max())):
                    raise AssertionError(f"tap {i} {name} differs from rpst")
        else:
            # relu3_1, relu4_1 pass the int8 chain: the whole tap
            got, ref = t.cpu().numpy(), fx[f"tap_{i}"]
            psnr = _psnr(got, ref)
            if not (got.shape == ref.shape and np.isfinite(got).all()
                    and psnr >= Q8_FIXTURE_PSNR):
                raise AssertionError(f"tap {i}: PSNR {psnr} dB vs rpst")
            msg.append(f"relu{i + 1}_1 PSNR {psnr:.2f} dB")
    parts, total = perceptual_rp_losses_q8targets(
        vgg, scales, x, s, c, 1.0, 2.0, dtype=torch.float32)
    got = {"style_loss": float(parts["style_loss"]),
           "content_loss": float(parts["content_loss"]),
           "total_loss": float(total)}
    for k, v in got.items():
        if not abs(v - float(fx[k])) <= Q8T_LOSS_RTOL * abs(float(fx[k])):
            raise AssertionError(f"q8-targets {k}: {v} vs rpst {fx[k]}")
    own = calibrate_vgg_targets_q8(vgg, c, s)["act_scales"]
    if not np.allclose(own, fx["act_scales"], rtol=2e-2):
        raise AssertionError(f"VGG target calibration {own} vs rpst "
                             f"{fx['act_scales']}")
    log("19 q8 targets fixture", f"64px b4 f32 vs rpst JAX (interpret): "
        f"{'; '.join(msg)}; relu1_1/relu2_1 statistics within 1e-3; loss parts "
        f"{ {k: round(v, 7) for k, v in got.items()} } vs "
        f"{ {k: round(float(fx[k]), 7) for k in got} } (rtol "
        f"{Q8T_LOSS_RTOL}); {B5_PER_TARGET_PASS} B5 launches, "
        f"{plan['scales']} scales within 2e-2 of rpst's")


def _serve_child(cfg_path, tmp, out_name, mode, extra=()):
    """serve_torch.py as a subprocess on tmp's 8 PNGs at batch 4; returns
    its log text and PNG count."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "serve_torch.py"), "--config",
         str(cfg_path), "--content", str(tmp / "content"), "--style",
         str(tmp / "style" / "s.png"), "--out", str(tmp / out_name),
         "--mode", mode, "--batch", "4", "--device", "cuda", *extra],
        capture_output=True, text=True, timeout=600, cwd=str(REPO))
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"serve_torch {out_name} rc {proc.returncode}:\n"
                             f"{text[-3000:]}")
    return text, len(list((tmp / out_name).glob("*.png")))


def _wide_serve(dev, rng):
    """Phase 20: the adain / wct int8 main path through the user's entry
    points. Returns the in-process main path's B5 launches."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.config import load_config
    from rpst_torch.data import load_image
    from rpst_torch.models import build_model
    from rpst_torch.models.fast_path_q8_std import std_q8_plan
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("content", "style"):
            (tmp / sub).mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        cfg_path = tmp / "adain.yaml"
        cfg_path.write_text(json.dumps(dict(WIDE, network="adain",
                                            img_size=IMG)))
        cfg = load_config(str(cfg_path))
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        plan = std_q8_plan(*bundle.std_weights(torch.float32))
        if plan != {"scales": 5, "B5": 4}:
            raise AssertionError(f"adain h32 plan {plan}")
        mode = resolve_mode(bundle, "q8", batch=4)
        if mode != "q8" or resolve_mode(bundle, "auto", batch=4) == "folded":
            raise AssertionError(f"adain resolve_mode gave {mode}")
        imgs = [load_image(tmp / "content" / f"c{i}.png", IMG)
                for i in range(8)]
        style_img = load_image(tmp / "style" / "s.png", IMG)
        calib = torch.from_numpy(np.stack(imgs[:4])).to(dev)
        scales = calibrate_scales(bundle, calib, torch.from_numpy(
            style_img)[None].to(dev).expand_as(calib).contiguous())
        if len(scales["act_scales"]) != plan["scales"]:
            raise AssertionError(f"{len(scales['act_scales'])} scales")
        batcher = DynamicBatcher(make_run_impl(bundle, mode, scales),
                                 batch_size=4, max_wait_ms=50.0, device=dev)
        _reset_counts()  # this main path's count starts here
        try:
            outs = [f.result(timeout=600) for f in
                    [batcher.submit(im, style_img) for im in imgs]]
        finally:
            batcher.close()
        launches = _counters()["B5"].launches
        batches = batcher.stats()["batches"]
        if launches != batches * plan["B5"] or batches < 2:
            raise AssertionError(f"adain q8 main path: {launches} B5 "
                                 f"launches in {batches} batches")
        std = bundle.stylize(torch.from_numpy(np.stack(imgs[:4])).to(dev),
                             torch.from_numpy(style_img)[None].to(dev)
                             .expand(4, -1, -1, -1).contiguous()).cpu().numpy()
        psnr = _psnr(np.stack(outs[:4]), std)
        for o in outs:
            if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                raise AssertionError(f"adain q8 main path output {o.shape}")
        if not psnr > Q8_VS_FOLDED_PSNR:
            raise AssertionError(f"adain q8 vs standard f32: PSNR {psnr} dB")
        log("20 wide serve", f"adain h32 512px: 8 requests via "
            f"DynamicBatcher(b4): {batcher.stats()}, {launches} B5 launches "
            f"({batches} batches x {plan['B5']}); q8 vs standard f32 PSNR "
            f"{psnr:.2f} dB (bound > {Q8_VS_FOLDED_PSNR})")
        del bundle, batcher, calib
        torch.cuda.empty_cache()

        wct_path = tmp / "wct.yaml"
        wct_path.write_text(json.dumps(dict(WIDE, network="wct",
                                            img_size=IMG)))
        for label, path, extra, per_call, n_scales in (
                ("adain h32", cfg_path, (), 4, 5),
                ("adain h16 (configs/train_deeper_rp_adain.yaml)",
                 ADAIN_YAML, ("--set", f"img_size={IMG}"), 2, 3),
                ("wct h32", wct_path, (), 4, 5)):
            t0 = time.perf_counter()
            text, n_png = _serve_child(path, tmp, label.split()[0] + str(
                per_call), "q8", extra)
            child = _logged_count(text, "B5")
            if (n_png != 8 or child != 2 * per_call
                    or f"Calibrated {n_scales} layer scales" not in text):
                raise AssertionError(f"serve_torch {label}: {n_png} PNGs, "
                                     f"{child} B5 launches:\n{text[-3000:]}")
            rate = [ln for ln in text.splitlines() if "Stylized" in ln]
            log("20 wide serve", f"serve_torch.py {label} --mode q8: 8 PNGs, "
                f"'Calibrated {n_scales} layer scales', {child} B5 launches "
                f"(2 batches x {per_call}), {time.perf_counter() - t0:.1f}s "
                f"wall; {rate[-1].split(' - ')[-1] if rate else ''}")
    return launches


def _q8_targets_train(dev):
    """Phase 21: train_torch.py with train_q8_targets=true on a 512px
    synthetic corpus, b4 f32 folded, 3 steps through the entry point in this
    process, counts reset before and read after. Returns the B1/B2/B3/B5
    launches."""
    import importlib.util
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        out = tmp / "run"
        cfg_path = tmp / "train.yaml"
        cfg_path.write_text(json.dumps(dict(
            FLAGSHIP, img_size=IMG, exec_strategy="folded", batch_size=4,
            max_iter=4, snapshot_save_iter=100, log_iter=1, num_workers=4,
            train_q8_targets=True,
            content_dir=str(tmp / "corpus" / "content"),
            style_dir=str(tmp / "corpus" / "style"), output=str(out))))
        spec = importlib.util.spec_from_file_location(
            "train_torch", REPO / "train_torch.py")
        driver = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(driver)
        _reset_counts()  # the main path's count starts here
        t0 = time.perf_counter()
        driver.main(["--config", str(cfg_path), "--device", "cuda"])
        launches = _counts(("B1", "B2", "B3", "B5"))
        want = tuple(3 * n for n in PER_STEP_Q8T + (B5_PER_TARGET_PASS,))
        if launches != want:
            raise AssertionError(f"q8-targets train launches {launches}, "
                                 f"expected 3 steps x "
                                 f"{PER_STEP_Q8T + (B5_PER_TARGET_PASS,)}")
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        losses = [ln["total_loss"] for ln in lines]
        if [ln["step"] for ln in lines] != [1, 2, 3] \
                or not np.isfinite(losses).all() \
                or any(ln["skipped"] for ln in lines):
            raise AssertionError(f"metrics.jsonl: {lines}")
    log("21 q8-targets train", f"train_torch.py b4 512px f32 folded, "
        f"train_q8_targets=true, 3 steps in {time.perf_counter() - t0:.1f}s "
        f"wall: total_loss {[round(v, 6) for v in losses]}; B1/B2/B3/B5 "
        f"launches {launches} (3 steps x "
        f"{PER_STEP_Q8T + (B5_PER_TARGET_PASS,)})")
    return launches


def _wide_timing(dev, rng, name_power):
    """Phase 22: 512px stylize of adain (b1, b4) and wct (b1), standard
    f32 / bf16 vs q8 (bf16 around the int8 layers, as served); the
    flagship's train step b1 / b4 with and without int8 targets. CUDA
    events, medians."""
    import numpy as np
    import torch
    from rpst_torch import policy
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.models.fast_path_q8_std import calibrate_vgg_targets_q8
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step

    def pair(batch):
        return tuple(torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                 np.float32)).to(dev)
                     for _ in range(2))

    for network, batches in (("adain", (1, 4)), ("wct", (1,))):
        bundle = _rpseq_bundle(network, dev, IMG)
        with torch.inference_mode():
            for batch in batches:
                c, s = pair(batch)
                scales = bundle.calibrate_q8(c, s)
                paths = {
                    "standard f32": lambda: _standard(bundle, c, s,
                                                      torch.float32),
                    "standard bf16": lambda: _standard(bundle, c, s,
                                                       torch.bfloat16),
                    "q8 B5": lambda: bundle.stylize_q8(c, s, scales)}
                # bf16, q8, q8, bf16: the policy's A/B in both orders
                for path in ("standard f32", "standard bf16", "q8 B5",
                             "q8 B5", "standard bf16"):
                    fn = paths[path]
                    ms = cuda_ms(fn, iters=7, warmup=2)
                    log("22 wide timing", f"{network} 512px b{batch} "
                        f"{path:14s}: {ms:9.3f} ms {batch * 1e3 / ms:8.2f} "
                        f"img/s ({name_power})")
        del bundle
        torch.cuda.empty_cache()

    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded",
                           train_q8_targets=True))
    vgg, _ = build_vgg(cfg, dev)
    min_batch = policy.TRAIN_Q8_TARGETS_MIN_BATCH
    try:
        policy.TRAIN_Q8_TARGETS_MIN_BATCH = 1  # time both sides at b1 too
        for batch in (1, 4):
            c, s = pair(batch)
            scales = calibrate_vgg_targets_q8(vgg, c, s)
            for dt in ("float32", "bfloat16"):
                # float, int8, int8, float: both orders inside one call
                for label, sc in (("float targets", None),
                                  ("int8 targets B5", scales),
                                  ("int8 targets B5", scales),
                                  ("float targets", None)):
                    bundle = build_model(cfg.replace(compute_dtype=dt), dev)
                    init_torch_default(bundle.model, cfg.seed)
                    bundle.q8_target_scales = sc
                    state = create_train_state(bundle)
                    ms = cuda_ms(lambda: train_step(state, vgg, c, s),
                                 iters=5, warmup=2)
                    log("22 wide timing", f"train step 512px b{batch} "
                        f"{dt:8s} {label:16s}: {ms:9.3f} ms/step "
                        f"{batch * 1e3 / ms:8.2f} img/s ({name_power})")
                    del state, bundle
                    torch.cuda.empty_cache()
    finally:
        policy.TRAIN_Q8_TARGETS_MIN_BATCH = min_batch


# ---------------------------------------------------------------- B6 / sanet

SANET_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_sanet.npz"
SANET_YAML = REPO / "configs" / "train_static_sanet.yaml"
# (label, (N, Nq, Nk, C)): the two attention modules of a 512px stylize
B6_SHAPES = (("relu4_1 b1", (1, 4096, 4096, 512)),
             ("relu5_1 b1", (1, 1024, 1024, 512)),
             ("relu4_1 b4", (4, 4096, 4096, 512)),
             ("relu5_1 b4", (4, 1024, 1024, 512)))
B6_JSON_SHAPE = "relu4_1 b1"
# (N, Nq, Nk, C) around the bfloat16 forward's tiles (32 query rows x 64
# keys): one below, at and one above each, at the widths below 512, N = 3
B6_FWD_EDGES = tuple((3, nq, nk, c) for c in (128, 256, 384)
                     for nq, nk in ((31, 63), (32, 64), (33, 65)))
LSE_TOL = 1e-4
# per 512px SANet call: two attention modules per stylize; the q8 plan's 16
# B5 (VGG conv_4 .. conv_13 on the 2N batch, mirror conv0 .. conv5); a train
# step runs three stylize passes (stylized, content-content, style-style),
# each module's forward with LSE once and both backward kernels once (f, g
# and h are trained, so dQ, dK and dV are all needed)
B6_PER_STYLIZE, SANET_Q8_B5, B6_PER_STEP = 2, 16, (6, 6, 6)
# gradients through the softmax (f and g, and f's bias): logits with a
# standard deviation near 8 amplify the float32 rounding of the scores, so
# the two frameworks' sums agree to ~1e-3 of the tensor's max there
SANET_SOFTMAX_GRAD_ATOL_REL = 2e-3
# the other leaves: the flagship's rtol (5e-3) with atol 5e-4 x max instead
# of its 1e-4: the loss runs five 14-conv VGG encodes and three decodes on
# cuDNN's float32 kernels, which sum in another order than the fixture's CPU
# convs (the first run on the card read 1.9e-4 at sanet5_1.h.bias)
SANET_GRAD_ATOL_REL = 5e-4
# q8 with rpst's scales, float32 around the int8 layers: 35 dB on the card,
# where the CPU test holds 40 (it reads 44.9). The narrow float layers run on
# cuDNN, whose float32 sums differ in the last bits from the fixture's CPU
# convs; that flips a few first quantizations, and 16 chained int8 layers
# with two peaked softmax modules between them spread the flips (the card
# read 40.2 dB). bfloat16: the 30 dB of the other q8 fixtures.
SANET_Q8_F32_PSNR = 35.0


def _attention_inputs(dev, dtype, n, nq, nk, c, scale=1.0, seed=0):
    """q, k, v, d_o with logits of order scale^2 (rows of norm ~C^(1/4))."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + n + nq + nk)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * scale / c ** 0.25).to(dev).to(dtype)
    return t(n, nq, c), t(n, nk, c), t(n, nk, c), t(n, nq, c)


def _sdpa(q, k, v):
    """The one library call that computes B6's function: unscaled, unmasked
    attention with one head of width C. In this script only."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1), scale=1.0).squeeze(1)


def _sdpa_backends(q, k, v):
    """The SDPA backends that accept this call, in the library's names."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok = []
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:  # a PyTorch that predates this backend
            continue
        try:
            with sdpa_kernel(backend):
                _sdpa(q, k, v)
            torch.cuda.synchronize()
            ok.append(backend.name)
        except RuntimeError:
            pass
    return ok


def _b6_compare(label, dev, dtype, shape, scale, tol):
    """B6a-d against their plain versions on one input (float32 at scale !=
    1, the forward's O and the gradients, against float64 oracles instead,
    by ``fa.f32_oracle_limit``); returns the max abs error against plain per
    kernel held to it."""
    import torch
    from rpst_torch.ops import flash_attention as fa
    q, k, v, d_o = _attention_inputs(dev, dtype, *shape, scale=scale)
    o = fa.flash_fwd(q, k, v)
    o2, lse = fa.flash_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
    f32 = dtype == torch.float32
    if f32 and scale != 1.0:
        ref64 = fa.attention_f64(q, k, v)
        limit = fa.f32_oracle_limit(ref_o, ref64)
        ora = max(check_oracle(f"{key} {label}", got, ref64, limit)
                  for key, got in (("B6a", o), ("B6b", o2)))
        err = {}
        fwd = (f"fwd O from the float64 oracle {ora:.3g} (limit {limit:.3g}: "
               f"{fa.F32_ORACLE_X:g}x max(plain's "
               f"{(ref_o.double() - ref64).abs().max().item():.3g}, 2^-20 "
               f"max |O|))")
    else:
        err = {"B6a": check_close(f"B6a {label}", o, ref_o, tol)[0],
               "B6b": check_close(f"B6b {label}", o2, ref_o, tol)[0]}
        fwd = f"fwd {err['B6a']:.3g}, fwd+lse {err['B6b']:.3g}"
    scaled = ""
    if scale == 1.0:  # both tensor-core forwards, at O's own size
        rel_max, rel_mean = ((fa.F32_O_REL, fa.F32_O_MEAN_REL) if f32
                             else (BF16_O_REL, BF16_O_MEAN_REL))
        rel = [check_scaled(f"{key} {label}", got, ref_o, rel_max, rel_mean)
               for key, got in (("B6a", o), ("B6b", o2))]
        scaled = (f"; fwd O err / max |ref|: max {max(r[0] for r in rel):.3g}"
                  f" (limit {rel_max}), mean {max(r[1] for r in rel):.3g} "
                  f"(limit {rel_mean})")
    # the LSE's own tolerance scales with the logits' size
    lse_err = (lse - ref_lse).abs().max().item()
    if not torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL):
        raise AssertionError(f"B6b {label} lse: max abs err {lse_err}")
    delta = (d_o.float() * ref_o.float()).sum(-1)
    bwd, text, _ = _b6_backward(label, q, k, v, d_o, ref_lse, delta, scale,
                                tol)
    log("23 B6 kernels", f"{label} {shape} {str(dtype)[6:]} x{scale:g}: max "
        f"abs err {fwd} (lse {lse_err:.3g}), {text}{scaled}")
    return {**err, **bwd}


def _b6_backward(label, q, k, v, d_o, lse, delta, scale, tol):
    """B6c and B6d under ``fa.check_backward``: against their plain
    versions, at their own size (float32 at x 1 from the float64 oracle of
    their own function, bfloat16 from the plain versions), float32 at x 30
    from that oracle by ``fa.f32_oracle_limit`` in place of the plain
    version, each run twice for bit-equal results. Returns the max abs error
    against plain per kernel held to it, the log text, and the worst (max,
    mean) share of max |ref| of the own-size checks (None where none was
    taken)."""
    from rpst_torch.ops import flash_attention as fa
    try:
        readings = fa.check_backward(q, k, v, d_o, lse, delta, tol, scale)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None
    kernel = {"dq": "B6c", "dk": "B6d", "dv": "B6d"}
    err, own = {}, None
    for name, r in readings.items():
        if r["plain"] is not None:
            err[kernel[name]] = max(err.get(kernel[name], 0.0), r["plain"])
        if "own" in r:
            own = tuple(max(a, b) for a, b in zip(own or (0.0, 0.0),
                                                  r["own"]))
    return err, (f"{fa.describe_backward(readings)} (tol {tol}); dQ, dK, dV "
                 f"bit-equal across two runs"), own


def _b6_kernels(dev, name_power):
    """Phase 23: B6a-d against their plain versions, then timed beside
    plain, SDPA and their bounds at every shape of a 512px stylize. Returns
    the kernels JSON numbers per kernel at B6_JSON_SHAPE: B6a-d in f32, and
    the bfloat16 forward (a kernel of its own) as B6a_bf16 / B6b_bf16."""
    import torch
    from rpst_torch.ops import flash_attention as fa
    worst = {k: 0.0 for k in ("B6a", "B6b", "B6c", "B6d")}
    worst_bf16 = {k: 0.0 for k in ("B6a", "B6b", "B6c", "B6d")}
    worst_rel = [0.0, 0.0]
    for shape in B6_FWD_EDGES:
        q, k, v, _ = _attention_inputs(dev, torch.bfloat16, *shape)
        o = fa.flash_fwd(q, k, v)
        o2, lse = fa.flash_fwd_lse(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
        worst_bf16["B6a"] = max(worst_bf16["B6a"], check_close(
            f"B6a edge {shape}", o, ref_o, BF16_TOL)[0])
        worst_bf16["B6b"] = max(worst_bf16["B6b"], check_close(
            f"B6b edge {shape}", o2, ref_o, BF16_TOL)[0])
        for got in (o, o2):
            rel = check_scaled(f"B6 edge {shape}", got, ref_o, BF16_O_REL,
                               BF16_O_MEAN_REL)
            worst_rel = [max(a, b) for a, b in zip(worst_rel, rel)]
        if not torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL):
            raise AssertionError(f"B6b edge {shape} lse: max abs err "
                                 f"{(lse - ref_lse).abs().max().item()}")
    log("23 B6 kernels", f"bf16 forward at {len(B6_FWD_EDGES)} tile-edge "
        f"shapes (N = 3; C 128, 256, 384; Nq 31-33, Nk 63-65): max abs err "
        f"{max(worst_bf16.values()):.3g} (tol {BF16_TOL}), err / max |ref| "
        f"max {worst_rel[0]:.3g} (limit {BF16_O_REL}), mean "
        f"{worst_rel[1]:.3g} (limit {BF16_O_MEAN_REL}), lse within "
        f"{LSE_TOL}")
    worst_rel = [0.0, 0.0]
    edges_f32 = [(3, nq, nk, c) for c in (128, 256, 384, 512)
                 for nq, nk in fa.F32_FWD_EDGES]
    for shape in edges_f32:
        q, k, v, _ = _attention_inputs(dev, torch.float32, *shape)
        o = fa.flash_fwd(q, k, v)
        o2, lse = fa.flash_fwd_lse(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
        if not torch.equal(o, o2):
            raise AssertionError(f"B6 edge {shape} f32: B6a and B6b differ")
        worst["B6a"] = max(worst["B6a"], check_close(
            f"B6a edge {shape}", o, ref_o, F32_TOL)[0])
        worst["B6b"] = max(worst["B6b"], check_close(
            f"B6b edge {shape}", o2, ref_o, F32_TOL)[0])
        rel = check_scaled(f"B6 edge {shape} f32", o, ref_o, fa.F32_O_REL,
                           fa.F32_O_MEAN_REL)
        worst_rel = [max(a, b) for a, b in zip(worst_rel, rel)]
        if not torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL):
            raise AssertionError(f"B6b edge {shape} f32 lse: max abs err "
                                 f"{(lse - ref_lse).abs().max().item()}")
    log("23 B6 kernels", f"f32 forward at {len(edges_f32)} tile-edge "
        f"shapes (N = 3; C 128-512; Nq 31-33, Nk 31-33 and 65): max abs err "
        f"{max(worst['B6a'], worst['B6b']):.3g} (tol {F32_TOL}), err / max "
        f"|ref| max {worst_rel[0]:.3g} (limit {fa.F32_O_REL}), mean "
        f"{worst_rel[1]:.3g} (limit {fa.F32_O_MEAN_REL}); B6a and B6b "
        f"bit-equal; lse within {LSE_TOL}")
    # around the backward kernels' tiles (16 rows a block x 32 swept rows,
    # both types), at every width, N = 3
    edges_bwd = [(3, nq, nk, c) for c in (128, 256, 384, 512)
                 for nq, nk in fa.BWD_EDGES]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        edge, own = {"B6c": 0.0, "B6d": 0.0}, (0.0, 0.0)
        for shape in edges_bwd:
            q, k, v, d_o = _attention_inputs(dev, dtype, *shape)
            ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
            delta = (d_o.float() * ref_o.float()).sum(-1)
            e, _, rel = _b6_backward(f"edge {shape}", q, k, v, d_o, ref_lse,
                                     delta, 1.0, tol)
            edge = {key: max(edge[key], e[key]) for key in edge}
            own = tuple(max(a, b) for a, b in zip(own, rel or own))
        for key, val in edge.items():
            if dtype == torch.float32:
                worst[key] = max(worst[key], val)
            else:
                worst_bf16[key] = max(worst_bf16[key], val)
        log("23 B6 kernels", f"{str(dtype)[6:]} backward at "
            f"{len(edges_bwd)} tile-edge shapes (N = 3; C 128-512; (Nq, "
            f"Nk) {fa.BWD_EDGES}): max abs err dq {edge['B6c']:.3g}, dk/dv "
            f"{edge['B6d']:.3g} (tol {tol}), from the "
            + (f"float64 oracle max {own[0]:.3g} / mean {own[1]:.3g} of max "
               f"|ref| (limits {fa.F32_GRAD_REL} / {fa.F32_GRAD_MEAN_REL})"
               if dtype == torch.float32 else
               f"plain version max {own[0]:.3g} / mean {own[1]:.3g} of max "
               f"|ref| (limits {fa.BF16_GRAD_REL} / "
               f"{fa.BF16_GRAD_MEAN_REL})")
            + "; dQ, dK, dV bit-equal across two runs")
    for label, shape, dtype, scale in (
            ("ragged", (2, 100, 70, 512), torch.float32, 1.0),
            ("ragged", (2, 100, 70, 512), torch.bfloat16, 1.0),
            ("tiny", (1, 1, 1, 128), torch.float32, 1.0),
            ("ragged x30", (2, 100, 70, 512), torch.float32, 30.0),
            ("relu5_1 x30", (1, 1024, 1024, 512), torch.float32, 30.0)):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for k, e in _b6_compare(label, dev, dtype, shape, scale, tol).items():
            if dtype == torch.float32:
                worst[k] = max(worst[k], e)
            elif k in worst_bf16:
                worst_bf16[k] = max(worst_bf16[k], e)
    out = {}
    for label, shape in B6_SHAPES:
        n, nq, nk, c = shape
        for dtype, tol, kind, size in ((torch.float32, F32_TOL, "f32", 4),
                                       (torch.bfloat16, BF16_TOL, "bf16", 2)):
            for k, e in _b6_compare(label, dev, dtype, shape, 1.0,
                                    tol).items():
                if dtype == torch.float32:
                    worst[k] = max(worst[k], e)
                elif k in worst_bf16:
                    worst_bf16[k] = max(worst_bf16[k], e)
            q, k_, v, d_o = _attention_inputs(dev, dtype, *shape)
            with torch.no_grad():
                o, lse = fa.flash_fwd_lse(q, k_, v)
                delta = (d_o.float() * o.float()).sum(-1)
                ms = {"B6a": cuda_ms(lambda: fa.flash_fwd(q, k_, v), iters=10),
                      "B6b": cuda_ms(lambda: fa.flash_fwd_lse(q, k_, v),
                                     iters=10),
                      "B6c": cuda_ms(lambda: fa.flash_bwd_dq(
                          q, k_, v, d_o, lse, delta), iters=10),
                      "B6d": cuda_ms(lambda: fa.flash_bwd_dkv(
                          q, k_, v, d_o, lse, delta), iters=10)}
                fwd_plain = cuda_ms(lambda: fa.flash_fwd_lse_plain(q, k_, v),
                                    iters=3, warmup=1)
                plain = {"B6a": fwd_plain, "B6b": fwd_plain,
                         "B6c": cuda_ms(lambda: fa.flash_bwd_dq_plain(
                             q, k_, v, d_o, lse, delta), iters=3, warmup=1),
                         "B6d": cuda_ms(lambda: fa.flash_bwd_dkv_plain(
                             q, k_, v, d_o, lse, delta), iters=3, warmup=1)}
                backends = _sdpa_backends(q, k_, v)
                lib_fwd = cuda_ms(lambda: _sdpa(q, k_, v), iters=10)
            leaves = [t.clone().requires_grad_(True) for t in (q, k_, v)]
            graph = _sdpa(*leaves)
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                graph, leaves, d_o, retain_graph=True), iters=5, warmup=2)
            del graph, leaves
            lib = {"B6a": lib_fwd, "B6b": lib_fwd, "B6c": lib_bwd,
                   "B6d": lib_bwd}
            qb, kb, rows = n * nq * c * size, n * nk * c * size, n * nq * 4
            work = n * nq * nk * c
            bounds = {  # operations; bytes in + bytes out
                "B6a": bound_ms(4 * work, qb + 2 * kb + qb, kind),
                "B6b": bound_ms(4 * work, qb + 2 * kb + qb + rows, kind),
                "B6c": bound_ms(6 * work, 2 * qb + 2 * kb + 2 * rows + qb,
                                kind),
                "B6d": bound_ms(8 * work, 2 * qb + 2 * kb + 2 * rows + 2 * kb,
                                kind)}
            for key in ("B6a", "B6b", "B6c", "B6d"):
                b_ms, b_by = bounds[key]
                log("23 B6 kernels", f"{label} {shape} {kind} {key}: "
                    f"{ms[key]:.4f} ms vs plain {plain[key]:.4f}, SDPA "
                    f"{'forward' if key in ('B6a', 'B6b') else 'backward'} "
                    f"{lib[key]:.4f} (backends that take the call: "
                    f"{backends}); bound {b_ms:.4f} ms by {b_by} "
                    f"({100 * b_ms / ms[key]:.1f}% of it reached"
                    + (f"; the 3xTF32 ceiling {3 * b_ms:.4f} ms, "
                       f"{100 * 3 * b_ms / ms[key]:.1f}% of it"
                       if kind == "f32" and b_by == "operations" else "")
                    + f"; {name_power})")
                if label == B6_JSON_SHAPE and (dtype == torch.float32
                                               or key in worst_bf16):
                    name = key if dtype == torch.float32 else key + "_bf16"
                    out[name] = {"ms": ms[key], "plain_ms": plain[key],
                                 "bound_ms": b_ms, "bound_by": b_by,
                                 "library_ms": lib[key]}
            del q, k_, v, d_o, o, lse, delta
            torch.cuda.empty_cache()
    for key in out:
        out[key]["max_abs_err"] = (worst_bf16[key[:3]]
                                   if key.endswith("_bf16") else worst[key])
    return out


def _sanet_bundle(dev, size, seeded=True, **over):
    """A static-SANet bundle with its 5-stage VGG set: the fixture's seeded
    weights, or what the drivers seed without --weights."""
    from rpst_torch.bridge import from_flax_params, sanet_weights_from_seed
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default
    cfg = load_config(str(SANET_YAML), dict(img_size=size, test_dir="", vgg="",
                                            **over))
    bundle = build_model(cfg, dev)
    if seeded:
        bundle.load_state_dict(from_flax_params(sanet_weights_from_seed(0)))
    else:
        init_torch_default(bundle.model, cfg.seed)
    bundle.vgg, _ = build_vgg(cfg, dev)
    return bundle


def _sanet_fixture(dev):
    """Phase 24: the static SANet on the card vs rpst's JAX outputs."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (from_flax_params, sanet_weights_from_seed,
                                   vgg_from_flax, vgg_weights_from_seed)
    from rpst_torch.models.fast_path_q8_std import sanet_q8_plan
    from rpst_torch.nn.vgg import VGG19Encoder
    with np.load(SANET_FIXTURE) as npz:
        fx = {k: npz[k] for k in npz.files}
    bundle = _sanet_bundle(dev, fx["content"].shape[1])
    bundle.load_state_dict(from_flax_params(sanet_weights_from_seed(
        int(fx["weights_seed"]))))
    vgg = VGG19Encoder(5)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]), 5)))
    bundle.vgg = vgg = vgg.to(dev)
    c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
    plan = sanet_q8_plan(vgg, bundle.q8_weights())
    if plan != {"scales": len(fx["act_scales"]), "B5": SANET_Q8_B5,
                "B6": B6_PER_STYLIZE}:
        raise AssertionError(f"sanet q8 plan {plan}")
    _reset_counts()
    out = bundle.stylize(c, s)
    torch.cuda.synchronize()
    if _counts(("B6a", "B5")) != (B6_PER_STYLIZE, 0):
        raise AssertionError(f"sanet stylize launches {_counts(('B6a', 'B5'))}")
    err, mae = check_close("sanet fixture standard f32", out,
                           torch.from_numpy(fx["out_f32"]).to(dev), F32_TOL)
    msg = [f"standard f32 max abs err {err:.3g}, MAE {mae:.3g} (tol "
           f"{F32_TOL}), {B6_PER_STYLIZE} B6"]
    scales = {"act_scales": fx["act_scales"]}
    for dt, key, min_psnr in ((torch.float32, "out_q8_f32", SANET_Q8_F32_PSNR),
                              (torch.bfloat16, "out_q8_bf16",
                               Q8_VS_FOLDED_PSNR)):
        _reset_counts()
        got = bundle.stylize_q8(c, s, scales, dtype=dt).cpu().numpy()
        n = _counts(("B5", "B6a"))
        psnr = _psnr(got, fx[key])
        if not (np.isfinite(got).all() and psnr >= min_psnr
                and n == (SANET_Q8_B5, B6_PER_STYLIZE)):
            raise AssertionError(f"sanet fixture {key}: PSNR {psnr} dB, B5 / "
                                 f"B6 launches {n}")
        msg.append(f"{key} PSNR {psnr:.2f} dB (>= {min_psnr})")
    _reset_counts()
    own = bundle.calibrate_q8(c, s)["act_scales"]
    if _counts(("B5", "B6a")) != (0, B6_PER_STYLIZE) \
            or not np.allclose(own, fx["act_scales"], rtol=2e-2):
        raise AssertionError(f"sanet calibration {own} vs rpst "
                             f"{fx['act_scales']}, launches "
                             f"{_counts(('B5', 'B6a'))}")
    # the loss and its gradients (train mode changes nothing: no BatchNorm)
    _reset_counts()
    total, parts = bundle.loss(vgg, c, s)
    total.backward()
    torch.cuda.synchronize()
    if _counts(("B6b", "B6c", "B6d")) != B6_PER_STEP:
        raise AssertionError(f"sanet loss launches "
                             f"{_counts(('B6b', 'B6c', 'B6d'))}")
    for k in ("content_loss", "style_loss", "l_identity1_loss",
              "l_identity2_loss", "total_loss"):
        got, want = float(parts[k].detach()), float(fx[k])
        if not abs(got - want) <= LOSS_RTOL * abs(want):
            raise AssertionError(f"sanet fixture {k}: {got} vs rpst {want}")
    worst = _check_sanet_grads(bundle.model, fx)
    log("24 sanet fixture", f"64px b2 vs rpst JAX: {'; '.join(msg)}; "
        f"{plan['B5']} B5 + {plan['B6']} B6 per q8 stylize, {plan['scales']} "
        f"scales within 2e-2 of rpst's; total_loss "
        f"{float(parts['total_loss'].detach()):.7g} vs "
        f"{float(fx['total_loss']):.7g}, worst gradient err / max {worst:.3g}; "
        f"B6 fwd/dq/dkv {B6_PER_STEP} per loss")


def _check_sanet_grads(model, fx):
    """The model's gradients against the fixture's: every bias in full, the
    [..., :8, :8] corner of every kernel, every leaf's norm. The g convs'
    biases shift all of a query's logits alike, so their gradient is zero up
    to rounding: held below 1e-3 of the f bias's. Returns the worst max abs
    err / max |ref|; raises with every leaf that is out of tolerance."""
    import numpy as np
    params = dict(model.named_parameters())
    worst, bad = 0.0, []
    for key, ref in fx.items():
        kind, _, path = key.partition("/")
        if kind not in ("grads", "gradpatch", "gradnorm"):
            continue
        name = path.replace("/", ".").replace("kernel", "weight")
        grad = params[name].grad.detach().float()
        if name.endswith(".g.bias"):
            f_max = params[name.replace(".g.", ".f.")].grad.abs().max().item()
            if not grad.abs().max().item() <= 1e-3 * f_max:
                bad.append(f"{name}: gradient {grad.abs().max().item()} not "
                           f"~0 (f bias max {f_max})")
            continue
        if kind == "gradnorm":
            if not abs(grad.norm().item() - float(ref)) <= 1e-3 * float(ref):
                bad.append(f"{name}: norm {grad.norm().item()} vs {ref}")
            continue
        got = (grad if kind == "grads" else
               grad.permute(2, 3, 1, 0)[..., :8, :8]).cpu().numpy()
        scale = float(np.abs(ref).max())
        softmax = any(t in name for t in (".f.", ".g."))
        rel = SANET_SOFTMAX_GRAD_ATOL_REL if softmax else SANET_GRAD_ATOL_REL
        err = float(np.abs(got - ref).max()) / max(scale, 1e-30)
        if not (np.isfinite(got).all() and np.allclose(
                got, ref, rtol=GRAD_RTOL, atol=rel * scale)):
            bad.append(f"{name} ({kind}): max abs err / max |ref| {err:.3g} "
                       f"(atol {rel} x max)")
        worst = max(worst, err)
    if bad:
        raise AssertionError("sanet gradients vs rpst:\n" + "\n".join(bad))
    return worst


def _plain_attention(f, g, h):
    from rpst_torch.ops.flash_attention import flash_fwd_plain
    return flash_fwd_plain(f, g, h)


def _sanet_parity(dev, rng):
    """Phase 25: 512px b2, the model on B6 vs the same model on the plain
    attention, f32 and bf16; launches per stylize."""
    import numpy as np
    import torch
    c, s = (torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
            for _ in range(2))
    msg = []
    for dt, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        bundle = _sanet_bundle(dev, IMG, compute_dtype=dt)
        _reset_counts()
        out = bundle.stylize(c, s)
        torch.cuda.synchronize()
        n = _counts(("B6a",))[0]
        bundle.model.attention = _plain_attention
        ref = bundle.stylize(c, s)
        torch.cuda.synchronize()
        if n != B6_PER_STYLIZE or _counts(("B6a",))[0] != n:
            raise AssertionError(f"sanet stylize {dt}: {n} B6 launches")
        # bf16: relative to the output's spread (the decoder amplifies the
        # attention's one-ulp differences)
        span = float(ref.max() - ref.min())
        err = (out - ref).abs().max().item()
        if dt == "float32":
            check_close(f"512px sanet B6 vs plain {dt}", out, ref, tol)
        elif not (torch.isfinite(out).all() and err <= tol * span):
            raise AssertionError(f"512px sanet B6 vs plain bf16: max abs err "
                                 f"{err} > {tol} x span {span}")
        msg.append(f"{dt} max abs err {err:.3g} (span {span:.3g}, tol {tol})")
        del bundle
        torch.cuda.empty_cache()
    log("25 sanet parity", f"{IMG}px b2 B6 vs plain attention: "
        f"{'; '.join(msg)}; {B6_PER_STYLIZE} B6 launches per stylize")


def _sanet_serve(dev, rng):
    """Phase 26: the SANet serving main path, standard and q8, through the
    user's entry points. Returns the in-process runs' B6a and B5 launches,
    and how many of the B6a launches were the bfloat16 kernel's."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.data import load_image
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    total = {"B6a": 0, "B5": 0, "B6a_bf16": 0}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("content", "style"):
            (tmp / sub).mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        imgs = [load_image(tmp / "content" / f"c{i}.png", IMG)
                for i in range(8)]
        style_img = load_image(tmp / "style" / "s.png", IMG)
        bundle = _sanet_bundle(dev, IMG, seeded=False)
        outs = {}
        for asked in ("standard", "q8"):
            mode = resolve_mode(bundle, asked, batch=4)
            if mode != asked or resolve_mode(bundle, "auto", 4) != "standard":
                raise AssertionError(f"sanet resolve_mode({asked}) = {mode}")
            scales = None
            if mode == "q8":
                calib = torch.from_numpy(np.stack(imgs[:4])).to(dev)
                scales = calibrate_scales(bundle, calib, torch.from_numpy(
                    style_img)[None].to(dev).expand_as(calib).contiguous())
                if len(scales["act_scales"]) != 16:
                    raise AssertionError(f"{len(scales['act_scales'])} scales")
            batcher = DynamicBatcher(make_run_impl(bundle, mode, scales),
                                     batch_size=4, max_wait_ms=50.0,
                                     device=dev)
            _reset_counts()  # this main path's count starts here
            try:
                outs[mode] = [f.result(timeout=600) for f in
                              [batcher.submit(im, style_img) for im in imgs]]
            finally:
                batcher.close()
            got = dict(zip(("B6a", "B5"), _counts(("B6a", "B5"))))
            batches = batcher.stats()["batches"]
            want = {"B6a": batches * B6_PER_STYLIZE,
                    "B5": batches * SANET_Q8_B5 * (mode == "q8")}
            if got != want or batches < 2:
                raise AssertionError(f"sanet {mode} main path: launches {got} "
                                     f"in {batches} batches, expected {want}")
            for o in outs[mode]:
                if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                    raise AssertionError(f"sanet {mode} output {o.shape}")
            # q8 serves bfloat16 around the int8 layers: its B6a launches
            # are the tensor-core kernel's, the standard f32 path's are not
            got["B6a_bf16"] = _bf16_fwd_counts()[0]
            if got["B6a_bf16"] != got["B6a"] * (mode == "q8"):
                raise AssertionError(f"sanet {mode} main path: {got}")
            for k in total:
                total[k] += got[k]
            log("26 sanet serve", f"{mode}: 8 requests via DynamicBatcher(b4): "
                f"{batcher.stats()}, launches {got} ({batches} batches)")
        psnr = _psnr(np.stack(outs["q8"]), np.stack(outs["standard"]))
        if not psnr > Q8_VS_FOLDED_PSNR:
            raise AssertionError(f"sanet q8 vs standard f32: PSNR {psnr} dB")
        log("26 sanet serve", f"q8 vs standard f32 PSNR {psnr:.2f} dB (bound > "
            f"{Q8_VS_FOLDED_PSNR})")
        del bundle, batcher
        torch.cuda.empty_cache()

        # the children: 8 PNGs in 2 batches; q8 calibrates first (2 more B6,
        # none of the int8 kernels)
        for mode, b5, b6 in (("standard", 0, 2 * B6_PER_STYLIZE),
                             ("q8", 2 * SANET_Q8_B5, 3 * B6_PER_STYLIZE)):
            t0 = time.perf_counter()
            text, n_png = _serve_child(
                SANET_YAML, tmp, f"sanet_{mode}", mode,
                ("--set", f"img_size={IMG}", "vgg=", "test_dir="))
            child = (_logged_count(text, "B5"), _logged_count(text, "B6"))
            if n_png != 8 or child != (b5, b6) or (
                    mode == "q8"
                    and "Calibrated 16 layer scales" not in text):
                raise AssertionError(f"serve_torch sanet {mode}: {n_png} "
                                     f"PNGs, B5 / B6 launches {child}:\n"
                                     f"{text[-3000:]}")
            rate = [ln for ln in text.splitlines() if "Stylized" in ln]
            log("26 sanet serve", f"serve_torch.py "
                f"configs/train_static_sanet.yaml --mode {mode}: 8 PNGs, B5 / "
                f"B6 launches {child}, {time.perf_counter() - t0:.1f}s wall; "
                f"{rate[-1].split(' - ')[-1] if rate else ''}")
    return total


def _sanet_train(dev):
    """Phase 27: train_torch.py on the repository's static-SANet yaml (512px,
    batch 4, f32): 3 steps as a subprocess, then 2 resumed steps through the
    same entry point in this process, counts reset before and read after.
    Then 2 steps in bfloat16 the same way. Returns the resumed run's B6
    forward-with-LSE / dQ / dK/dV launches and the bfloat16 run's forward-
    with-LSE / dQ / dK/dV launches."""
    import importlib.util
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        out = tmp / "run"
        args = ["--config", str(SANET_YAML), "--device", "cuda", "--set",
                "vgg=", "test_dir=", "num_workers=4", "log_iter=1",
                "snapshot_save_iter=2",
                f"content_dir={tmp / 'corpus' / 'content'}",
                f"style_dir={tmp / 'corpus' / 'style'}", f"output={out}"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / "train_torch.py"), *args,
             "max_iter=4"], capture_output=True, text=True, timeout=900,
            cwd=str(REPO))
        text = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise AssertionError(f"train_torch.py sanet rc {proc.returncode}:"
                                 f"\n{text[-3000:]}")
        child = [tuple(int(v) for v in ln.rsplit(":", 1)[1].split("/"))
                 for ln in text.splitlines() if "B6 fwd/dq/dkv launches:" in ln]
        if child != [tuple(3 * n for n in B6_PER_STEP)]:
            raise AssertionError(f"train_torch.py sanet launches {child}, "
                                 f"expected 3 steps x {B6_PER_STEP}:\n"
                                 f"{text[-3000:]}")
        rates = [ln.split("img/s ")[1].split(",")[0]
                 for ln in text.splitlines() if "img/s" in ln]
        log("27 sanet train", f"train_torch.py sanet b4 {IMG}px f32, 3 steps "
            f"in {time.perf_counter() - t0:.1f}s wall (img/s per step "
            f"{rates}); child B6 fwd/dq/dkv launches {child[0]}")

        spec = importlib.util.spec_from_file_location(
            "train_torch", REPO / "train_torch.py")
        train_cli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(train_cli)
        _reset_counts()  # the main path's count starts here
        train_cli.main([*args, "resume=true", "max_iter=3"])
        launches = _counts(("B6b", "B6c", "B6d"))
        if launches != tuple(2 * n for n in B6_PER_STEP) \
                or _counts(("B6a",)) != (0,):
            raise AssertionError(f"resumed sanet run launches {launches} "
                                 f"(B6a {_counts(('B6a',))}), expected 2 "
                                 f"steps x {B6_PER_STEP}")
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        steps = [ln["step"] for ln in lines]
        losses = [ln["total_loss"] for ln in lines]
        if steps != [1, 2, 3, 4, 5] or not np.isfinite(losses).all() \
                or any(ln["skipped"] for ln in lines):
            raise AssertionError(f"sanet metrics.jsonl: {lines}")
        # the same entry point in bfloat16 (compute_dtype), 2 steps: the
        # forward with LSE is then the tensor-core kernel
        _reset_counts()
        train_cli.main([*args[:-1], f"output={tmp / 'run_bf16'}",
                     "compute_dtype=bfloat16", "max_iter=3"])
        bf16 = _counts(("B6b", "B6c", "B6d"))
        bf16_fwd = _bf16_fwd_counts()[1]
        if bf16 != tuple(2 * n for n in B6_PER_STEP) or bf16_fwd != bf16[0]:
            raise AssertionError(f"bf16 sanet run launches {bf16}, bf16 "
                                 f"forward {bf16_fwd}, expected 2 steps x "
                                 f"{B6_PER_STEP}")
        bf16_lines = [json.loads(ln) for ln in (
            tmp / "run_bf16" / "logs" / "metrics.jsonl").read_text()
            .splitlines()]
        if len(bf16_lines) != 2 or not np.isfinite(
                [ln["total_loss"] for ln in bf16_lines]).all():
            raise AssertionError(f"bf16 sanet metrics.jsonl: {bf16_lines}")
    log("27 sanet train", f"resumed at step 3 for steps 4-5; total_loss "
        f"{[round(v, 4) for v in losses]}; B6 fwd+lse/dq/dkv launches "
        f"{launches} (2 steps x {B6_PER_STEP}); bfloat16, 2 steps: {bf16}, "
        f"total_loss {[round(ln['total_loss'], 4) for ln in bf16_lines]}")
    return launches + (bf16_fwd,) + bf16[1:]


def _sanet_timing(dev, rng, name_power):
    """Phase 28: the 512px SANet stylize (standard f32, bf16, q8) and train
    step at b1 and b4, with B6, with the plain attention and with the SDPA
    call in B6's place. CUDA events, medians."""
    import numpy as np
    import torch
    from rpst_torch.ops.flash_attention import sanet_attention
    from rpst_torch.train.step import create_train_state, train_step

    def pair(batch):
        return tuple(torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                 np.float32)).to(dev)
                     for _ in range(2))

    attentions = (("B6", sanet_attention), ("plain", _plain_attention),
                  ("SDPA", _sdpa))
    for batch in (1, 4):
        c, s = pair(batch)
        for dt in ("float32", "bfloat16"):
            bundle = _sanet_bundle(dev, IMG, compute_dtype=dt)
            paths = [(f"standard {dt}", lambda: bundle.stylize(c, s))]
            if dt == "bfloat16":  # q8 serves in bf16 around the int8 layers
                scales = bundle.calibrate_q8(c, s)
                paths.append(("q8 B5", lambda: bundle.stylize_q8(c, s,
                                                                 scales)))
            # bf16, q8, q8, bf16 on B6: the policy's A/B in both orders
            again = [paths[1], paths[0]] if dt == "bfloat16" else []
            for i, (path, fn) in enumerate(paths + again):
                for label, attention in (attentions if i < len(paths)
                                         else attentions[:1]):
                    bundle.model.attention = attention
                    ms = cuda_ms(fn, iters=7, warmup=2)
                    log("28 sanet timing", f"stylize {IMG}px b{batch} "
                        f"{path:17s} attention {label:5s}: {ms:9.3f} ms "
                        f"{batch * 1e3 / ms:8.2f} img/s ({name_power})")
            del bundle
            torch.cuda.empty_cache()
    for batch in (1, 4):
        c, s = pair(batch)
        for dt in ("float32", "bfloat16"):
            for label, attention in attentions:
                bundle = _sanet_bundle(dev, IMG, compute_dtype=dt)
                bundle.model.attention = attention
                state = create_train_state(bundle)
                ms = cuda_ms(lambda: train_step(state, bundle.vgg, c, s),
                             iters=5, warmup=2)
                log("28 sanet timing", f"train step {IMG}px b{batch} {dt:8s} "
                    f"attention {label:5s}: {ms:9.3f} ms/step "
                    f"{batch * 1e3 / ms:8.2f} img/s ({name_power})")
                del state, bundle
                torch.cuda.empty_cache()


def _standard(bundle, c, s, dt):
    import torch
    with torch.autocast("cuda", dtype=torch.bfloat16,
                        enabled=dt == torch.bfloat16):
        return bundle.model(c, s)


def _logged_launches(text):
    """The count serve_torch.py logs as 'B1 fused_folded_conv launches: N'."""
    counts = [int(ln.rsplit(":", 1)[1]) for ln in text.splitlines()
              if "fused_folded_conv launches:" in ln]
    return counts[-1] if counts else None


def _daemon_round_trip(cfg_path, tmp, env):
    """Start serve_torch.py --daemon, send 6 requests, stats and shutdown
    over one connection; return (replies, stats). Always reaps the child."""
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "serve_torch.py"), "--config",
         str(cfg_path), "--content", str(tmp / "content"),
         "--style", str(tmp / "style" / "s.png"), "--out",
         str(tmp / "daemon"), "--mode", "folded", "--batch", "4",
         "--device", "cuda", "--daemon", "--port", "0",
         "--max-wait-ms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(REPO))
    try:
        port, lines = None, []
        deadline = time.time() + 300
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "DAEMON LISTENING" in line:
                port = int(line.split("DAEMON LISTENING")[1].split()[0]
                           .rsplit(":", 1)[1])
        if port is None:
            raise AssertionError("daemon did not start:\n" + "".join(lines))
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
            f = s.makefile("rw")
            for i in range(6):
                f.write(json.dumps({"id": f"r{i}", "content": str(
                    tmp / "content" / f"c{i}.png")}) + "\n")
            f.flush()
            replies = [json.loads(f.readline()) for _ in range(6)]
            f.write(json.dumps({"cmd": "stats"}) + "\n")
            f.flush()
            stats = json.loads(f.readline())
            f.write(json.dumps({"cmd": "shutdown"}) + "\n")
            f.flush()
            if not json.loads(f.readline()).get("shutdown"):
                raise AssertionError("daemon did not acknowledge shutdown")
        rest, _ = proc.communicate(timeout=120)
        bad = [r for r in replies if not r.get("ok")
               or not Path(r["out"]).exists()]
        if bad or {r["id"] for r in replies} != {f"r{i}" for i in range(6)}:
            raise AssertionError(f"daemon replies: {replies}")
        if stats.get("served") != 6 or proc.returncode != 0:
            raise AssertionError(f"daemon stats {stats}, rc "
                                 f"{proc.returncode}:\n{rest[-2000:]}")
        if not (_logged_launches(rest) or 0) > 0:
            raise AssertionError(f"daemon logged no B1 launches:\n{rest}")
        return replies, stats
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


if __name__ == "__main__":
    main()
