#!/usr/bin/env python
"""Serving CLI of the PyTorch/CUDA port: stylize a folder of content
images against a style image, or serve a line-JSON TCP daemon with dynamic
request batching. The counterpart of ``serve.py``, with the same flags
except ``--mesh``, plus ``--device`` and ``--weights``; it imports no JAX.

  * ``--mode q8``       int8 PTQ serving: calibrates per-tensor activation
                        scales on the first min(batch, 8) content images
                        with the style (adain and wct use at most 2 of
                        them), then runs the int8 layers on the
                        hand-written CUDA kernels: the flagship's folded
                        layers on B4 (B7 pairs where
                        ``rpst_torch.policy.FUSE_PAIRS``) with the image
                        layers on B1, adain's and wct's wide
                        standard-layout layers on B5, sanet's frozen VGG
                        encode (conv_4 .. conv_13 on the 2N batch) and
                        mirror decoder (conv0 .. conv5) on B5 with its two
                        attention modules on B6 (on a CPU device: their
                        plain versions); flagship configs without int8
                        layers (4 * hidden_dim % 128) serve standard, with
                        a warning,
  * ``--mode folded``   exact space-to-depth execution on the hand-written
                        B1 CUDA kernel (on a CPU device: its plain version),
  * ``--mode standard`` the plain model path (sanet: the frozen 5-stage
                        VGG, the attention transform on the hand-written
                        B6 kernel, the mirror decoder),
  * ``--mode auto``     the path measured fastest on the H100 at --batch
                        (``rpst_torch.policy``, PERF.md section 6).

At the end it logs the B1, B4, B7, B5 and B6 launch counts of the run.
Networks: multi_adain (the flagship), adain, wct and sanet (``--mode
folded`` falls back to standard for the last three, with a warning). sanet
loads its frozen VGG from the config's ``vgg`` (``.pth`` or ``.npz``), or
seeds a random one, with a warning.

Weights: ``--weights`` takes a reference-layout ``.pth`` (written from an
rpst checkpoint by ``tools/export_reference_checkpoint.py``) or an ``.npz``
of flax parameter paths; without it the weights are seeded from the
config's ``seed``, with a warning.

Usage:
  python serve_torch.py --config cfg.yaml --content in/ --style style.png \
      --out stylized/ [--mode folded] [--batch 8] [--device cuda] \
      [--weights w.pth] [--set key=val ...]
  python serve_torch.py ... --daemon [--port N] [--max-wait-ms 5]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np
import torch
import yaml

from rpst_torch.bridge import load_weights
from rpst_torch.config import load_config
from rpst_torch.data import image_paths, load_image, to_u8
from rpst_torch.metrics import logger, save_image
from rpst_torch.models import build_model, build_vgg
from rpst_torch.nn.blocks import init_torch_default
from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8
from rpst_torch.ops.flash_attention import launch_counts
from rpst_torch.ops.folded_conv import fused_folded_conv
from rpst_torch.ops.folded_conv2_q8 import fused_folded_conv2_q8
from rpst_torch.ops.folded_conv_q8 import fused_folded_conv_q8
from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                make_run_impl, resolve_mode, serve_daemon)


def _load_images(path: Path, img_size: int):
    return [(p.stem, load_image(p, img_size)) for p in image_paths(path)]


def _log_launches():
    for label, fn in (("B1", fused_folded_conv), ("B4", fused_folded_conv_q8),
                      ("B7", fused_folded_conv2_q8),
                      ("B5", fused_conv2d_q8)):
        logger.info(f"{label} {fn.__name__} launches: {fn.launches}")
    logger.info(f"B6 flash_attention launches: {launch_counts()['B6_fwd']}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--content", required=True)
    parser.add_argument("--style", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--mode", default="folded",
                        choices=["standard", "folded", "q8", "auto"],
                        help="execution strategy; 'auto' picks the path "
                        "measured fastest on the H100 at --batch")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the default; exits if no "
                        "card is present), cuda:N or cpu")
    parser.add_argument("--weights", default="",
                        help="reference-layout .pth or .npz of flax param "
                        "paths; empty = weights seeded from cfg.seed")
    parser.add_argument("--daemon", action="store_true",
                        help="serve a line-JSON TCP loop with dynamic "
                        "request batching instead of sweeping --content "
                        "(protocol: rpst_torch/serving.py docstring)")
    parser.add_argument("--port", type=int, default=0,
                        help="daemon TCP port (0 = ephemeral; the bound "
                        "port is logged as 'DAEMON LISTENING host:port')")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="daemon batching window: the first queued "
                        "request waits at most this long for the batch "
                        "to fill before dispatching")
    parser.add_argument("--set", nargs="*", default=[])
    args = parser.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = yaml.safe_load(v)
    if args.mode != "standard":
        overrides.setdefault("exec_strategy", "folded")
    cfg = load_config(args.config, overrides)

    bundle = build_model(cfg, device)
    mode = resolve_mode(bundle, args.mode, batch=args.batch)
    if args.weights:
        bundle.load_state_dict(load_weights(args.weights))
        logger.info(f"Loaded weights {args.weights}")
    else:
        init_torch_default(bundle.model, cfg.seed)
        logger.warning(f"No --weights: serving randomly initialized params "
                       f"(seed {cfg.seed})")

    if bundle.network == "sanet":
        bundle.vgg, vgg_source = build_vgg(cfg, device)
        if cfg.vgg and vgg_source == str(cfg.vgg):
            logger.info(f"Loaded VGG weights from {cfg.vgg}")
        else:
            logger.warning(f"VGG weights {cfg.vgg!r} not found: serving on "
                           f"{vgg_source}")

    contents = _load_images(Path(args.content), cfg.img_size)
    styles = _load_images(Path(args.style), cfg.img_size)
    scales = None
    if mode == "q8":
        # per-tensor absmax needs few images; a large serving batch would
        # make calibration's peak memory exceed serving's
        calib = torch.from_numpy(np.stack(
            [img for _, img in contents[:min(args.batch, 8)]])).to(device)
        calib_style = torch.from_numpy(styles[0][1])[None].to(device)
        scales = calibrate_scales(bundle, calib,
                                  calib_style.expand_as(calib).contiguous())
        logger.info(f"Calibrated {len(scales['act_scales'])} layer scales")
    run_impl = make_run_impl(bundle, mode, scales)

    def run_u8(content, style):
        """uint8 across the host<->device boundary (4x less transfer than
        float32); the /255 and the save-side clip*255+0.5 run on the device,
        so the PNG bytes equal the host-side math."""
        y = run_impl(content.float() / 255.0, style.float() / 255.0)
        return (torch.clamp(y.float(), 0.0, 1.0) * 255.0 + 0.5).to(
            torch.uint8)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    style_u8 = to_u8(styles[0][1])

    if args.daemon:
        batcher = DynamicBatcher(run_u8, batch_size=args.batch,
                                 max_wait_ms=args.max_wait_ms, device=device)
        try:
            serve_daemon(batcher, cfg.img_size, out_dir, port=args.port,
                         default_style=style_u8, to_u8=to_u8)
        finally:
            batcher.close()
        _log_launches()
        return

    style_dev = torch.from_numpy(style_u8)[None].to(device)

    def _dispatch(chunk):
        """Decode + copy + asynchronous launch of one batch."""
        batch = torch.from_numpy(to_u8(np.stack([img for _, img in chunk])))
        b = batch.to(device)
        return run_u8(b, style_dev.expand(b.shape[0], -1, -1, -1))

    def _flush(chunk, out):
        arr = out.cpu().numpy()  # waits for the device
        for b, (name, _) in enumerate(chunk):
            save_image(arr[b], out_dir / f"{name}-{styles[0][0]}.png")

    # double-buffered: batch t+1 decodes and launches while t computes
    n_done, t0, pending = 0, time.perf_counter(), None
    with torch.inference_mode():
        for i in range(0, len(contents), args.batch):
            chunk = contents[i:i + args.batch]
            out = _dispatch(chunk)
            if pending is not None:
                _flush(*pending)
                n_done += len(pending[0])
            pending = (chunk, out)
        if pending is not None:
            _flush(*pending)
            n_done += len(pending[0])
    dt = time.perf_counter() - t0
    logger.info(f"Stylized {n_done} images in {dt:.2f}s "
                f"({n_done / dt:.1f} img/s incl host IO, {device}) "
                f"-> {out_dir}")
    _log_launches()


if __name__ == "__main__":
    main()
