#!/usr/bin/env python
"""Quickest proof that the PyTorch/CUDA port runs on the GPU: builds the
port's CUDA kernels from this checkout, checks each against its plain
PyTorch version, drives the flagship's folded serving path at 512px through
the user's entry points, and times it. Needs one NVIDIA Hopper card; run
from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own line; any failed check raises, exit code != 0):
  1. build     nvcc-build every kernel of the path (B1 folded conv)
  2. kernels   B1 vs its plain version at the path's shapes, f32 + bf16
  3. fixture   folded stylize on the card vs rpst's JAX output
               (tests/fixtures/torch_port_flagship.npz)
  4. parity    512px: folded (B1) vs the port's standard path; bf16 vs f32;
               launches == folded conv layers run
  5. serve     the main path: 8 requests through build_model ->
               resolve_mode -> make_run_impl -> DynamicBatcher, launch
               counts reset before and read after; then serve_torch.py's
               folder sweep as a subprocess
  6. daemon    serve_torch.py --daemon: 6 requests + stats + shutdown
  7. timing    512px stylize b1/b8, f32/bf16: folded B1, folded plain,
               standard, with CUDA events

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
    build.load("folded_conv")
    info = build.build_info["folded_conv"]
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    log("1 build", f"folded_conv.cu built in {info['seconds']:.2f}s "
        f"(load {time.perf_counter() - t0:.2f}s); ptxas: {regs}")

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

    kernels = {"kernels": [{
        "name": "fused_folded_conv", "route": "cuda",
        "source": "src/rpst_torch/csrc/folded_conv.cu",
        "replaces": "src/rpst/ops/pallas/folded_conv.py:650",
        "launches": main_launches, "max_abs_err": f32_err,
        "ms": kernel_ms[torch.float32],
        "plain_ms": plain_ms[torch.float32]}]}
    print(json.dumps(kernels), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


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
