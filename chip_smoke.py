#!/usr/bin/env python
"""Quickest proof that the PyTorch/CUDA port runs on the GPU: builds the
port's CUDA kernels from this checkout, checks each against its plain
PyTorch version, drives the flagship's folded serving and training paths at
512px through the user's entry points, and times them. Needs one NVIDIA
Hopper card; run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own line; any failed check raises, exit code != 0):
  1. build     nvcc-build every kernel of the paths, one nvcc per source, all
               at once (B1 folded_conv.cu; B2, B3 folded_conv_bwd.cu)
  2. kernels   B1, B2, B3 vs their plain versions at the paths' shapes, f32 +
               bf16; B2/B3 timed against plain
  3. fixture   folded stylize on the card vs rpst's JAX output
               (tests/fixtures/torch_port_flagship.npz)
  4. parity    512px: folded (B1) vs the port's standard path; bf16 vs f32;
               launches == folded conv layers run
  5. serve     the serving main path: 8 requests through build_model ->
               resolve_mode -> make_run_impl -> DynamicBatcher, launch
               counts reset before and read after; then serve_torch.py's
               folder sweep as a subprocess
  6. daemon    serve_torch.py --daemon: 6 requests + stats + shutdown
  7. timing    512px stylize b1/b8, f32/bf16: folded B1, folded plain,
               standard, with CUDA events
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

    def layer(n, h, w, c, co):
        bound = (9 * c) ** -0.5
        x = torch.rand(n, h, w, 4 * c, generator=g) * 2 - 0.5
        k = fold_conv_kernel((torch.rand(3, 3, c, co, generator=g) * 2 - 1)
                             * bound)
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
             ("rings override", (1, 64, 64, 32, 32), 0.2, True)]
    fused_folded_conv.launches = 0
    f32_err, kernel_ms, plain_ms = 0.0, {}, {}
    with torch.inference_mode():
        for label, shape, alpha, with_rings in cases:
            x, k, b = layer(*shape)
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
                if label == "128->128":
                    kernel_ms[dt] = cuda_ms(
                        lambda: fused_folded_conv(xd, kd, bd, alpha))
                    plain_ms[dt] = cuda_ms(
                        lambda: fused_folded_conv_plain(xd, kd, bd, alpha))
                log("2 kernels", f"{label} x{tuple(x.shape)}->4Co "
                    f"{k.shape[3]} {str(dt)[6:]}: max abs err {err:.3g} "
                    f"(tol {tol})")
    log("2 kernels", f"{fused_folded_conv.launches} comparison launches; "
        f"(1,256,256,128->128) B1 vs plain ms: f32 "
        f"{kernel_ms[torch.float32]:.4f} vs {plain_ms[torch.float32]:.4f}, "
        f"bf16 {kernel_ms[torch.bfloat16]:.4f} vs "
        f"{plain_ms[torch.bfloat16]:.4f} ({name_power})")
    bwd = _check_backward_kernels(dev, name_power)

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
                for path, fn in paths.items():
                    ms = cuda_ms(fn)
                    rows.append((batch, str(dt)[6:], path, ms))
                    log("7 timing", f"512px b{batch} {str(dt)[6:]:8s} "
                        f"{path:12s}: {ms:8.3f} ms  "
                        f"{batch * 1e3 / ms:8.2f} img/s  ({name_power})")

    # ---- 8-11. training ---------------------------------------------------
    _train_fixture(dev)
    _train_parity(dev, rng)
    train_launches = _train_main_path(dev)
    _train_timing(dev, rng, name_power)

    bwd_src = "src/rpst_torch/csrc/folded_conv_bwd.cu"
    kernels = {"kernels": [
        {"name": "fused_folded_conv", "route": "cuda",
         "source": "src/rpst_torch/csrc/folded_conv.cu",
         "replaces": "src/rpst/ops/pallas/folded_conv.py:650",
         "launches": main_launches + train_launches[0],
         "max_abs_err": f32_err, "ms": kernel_ms[torch.float32],
         "plain_ms": plain_ms[torch.float32]},
        {"name": "fused_folded_conv_grad_input", "route": "cuda",
         "source": bwd_src,
         "replaces": "src/rpst/ops/pallas/folded_conv.py:339",
         "launches": train_launches[1], "max_abs_err": bwd["B2"]["err"],
         "ms": bwd["B2"]["ms"], "plain_ms": bwd["B2"]["plain_ms"]},
        {"name": "fused_folded_conv_grad_weight", "route": "cuda",
         "source": bwd_src,
         "replaces": "src/rpst/ops/pallas/folded_conv.py:468",
         "launches": train_launches[2], "max_abs_err": bwd["B3"]["err"],
         "ms": bwd["B3"]["ms"], "plain_ms": bwd["B3"]["plain_ms"]}]}
    print(json.dumps(kernels), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _grad_case(g, dev, n, h, w, c4, c4o):
    import torch
    x = torch.randn(n, h, w, c4, generator=g)
    gz = torch.randn(n, h, w, c4o, generator=g)
    kf = torch.randn(3, 3, c4, c4o, generator=g) * 0.1
    return (x.to(dev), gz.to(dev),
            kf.flip(0, 1).transpose(2, 3).contiguous().to(dev))


def _check_backward_kernels(dev, name_power):
    """Phase 2, backward: B2 and B3 against their plain versions at every
    width of the training path, f32 and bf16, and timed against plain at
    (1,256,256,128->128) and (1,128,128,512->512). Returns the f32 max abs
    errors and the 128->128 f32 times for the kernels JSON."""
    import torch
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
    err = {"B2": 0.0, "B3": 0.0}
    for label, shape in cases:
        x, gz, khat = _grad_case(g, dev, *shape)
        n, h, w = shape[:3]
        dk_atol = DK_ATOL_512 * (n * h * w / 512) ** 0.5
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xd, gd, kd = x.to(dt), gz.to(dt), khat.to(dt)
            dx = fused_folded_conv_grad_input(gd, kd)
            dk, db = fused_folded_conv_grad_weight(xd, gd)
            torch.cuda.synchronize()
            e2, _ = check_close(f"B2 {label} {dt}", dx,
                                fused_folded_conv_grad_input_plain(gd, kd),
                                tol)
            rdk, rdb = fused_folded_conv_grad_weight_plain(xd, gd)
            e3 = 0.0
            for name, got, ref in (("dk", dk, rdk), ("db", db, rdb)):
                if not (torch.isfinite(got).all() and torch.allclose(
                        got, ref, rtol=1e-4, atol=dk_atol)):
                    raise AssertionError(
                        f"B3 {label} {dt} {name}: max abs err "
                        f"{(got - ref).abs().max().item()} (rtol 1e-4, atol "
                        f"{dk_atol:.3g})")
                e3 = max(e3, (got - ref).abs().max().item())
            if dt == torch.float32:
                err["B2"], err["B3"] = max(err["B2"], e2), max(err["B3"], e3)
            log("2 kernels", f"{label} {tuple(shape)} {str(dt)[6:]}: B2 dx "
                f"max abs err {e2:.3g} (tol {tol}), B3 dk/db {e3:.3g} "
                f"(atol {dk_atol:.3g})")
    out = {"B2": {"err": err["B2"]}, "B3": {"err": err["B3"]}}
    for shape in ((1, 256, 256, 128, 128), (1, 128, 128, 512, 512)):
        x, gz, khat = _grad_case(g, dev, *shape)
        for dt in (torch.float32, torch.bfloat16):
            xd, gd, kd = x.to(dt), gz.to(dt), khat.to(dt)
            t = {"B2": cuda_ms(lambda: fused_folded_conv_grad_input(gd, kd)),
                 "B2 plain": cuda_ms(
                     lambda: fused_folded_conv_grad_input_plain(gd, kd)),
                 "B3": cuda_ms(lambda: fused_folded_conv_grad_weight(xd, gd)),
                 "B3 plain": cuda_ms(
                     lambda: fused_folded_conv_grad_weight_plain(xd, gd))}
            log("2 kernels", f"{tuple(shape)} {str(dt)[6:]}: B2 "
                f"{t['B2']:.4f} ms vs plain {t['B2 plain']:.4f}; B3 "
                f"{t['B3']:.4f} ms vs plain {t['B3 plain']:.4f} "
                f"({name_power})")
            if shape[3] == 128 and dt == torch.float32:
                for k in ("B2", "B3"):
                    out[k].update(ms=t[k], plain_ms=t[f"{k} plain"])
    return out


def _counters():
    from rpst_torch.ops.folded_conv import (fused_folded_conv,
                                            fused_folded_conv_grad_input,
                                            fused_folded_conv_grad_weight)
    return (fused_folded_conv, fused_folded_conv_grad_input,
            fused_folded_conv_grad_weight)


def _reset_counts():
    for c in _counters():
        c.launches = 0


def _counts():
    return tuple(c.launches for c in _counters())


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
    from rpst_torch.ops.folded_conv import fused_folded_conv_plain

    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    vgg, _ = build_vgg(cfg, dev)
    c, s = (torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
            for _ in range(2))
    runs = {}
    for label, over, conv_act in (
            ("kernels", {}, None), ("plain", {}, fused_folded_conv_plain),
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
    from rpst_torch.ops.folded_conv import fused_folded_conv_plain
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
                    ("folded plain", "folded",
                     {"conv_act": fused_folded_conv_plain}),
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
