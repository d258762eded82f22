#!/usr/bin/env python
"""Serving CLI of the PyTorch/CUDA port: stylize a folder of content
images against a style image, or serve a line-JSON TCP daemon with dynamic
request batching. The counterpart of ``serve.py``, with the same flags,
plus ``--device`` and ``--weights``; it imports no JAX.

  * ``--mode q8``       int8 PTQ serving: calibrates per-tensor activation
                        scales on the first min(batch, 8) content images
                        with the style (the wide standard-layout
                        networks use at most 2 of them), then runs the
                        int8 layers on the
                        hand-written CUDA kernels: the flagship's folded
                        layers on B4 (B7 pairs where
                        ``rpst_torch.policy.FUSE_PAIRS``) with the image
                        layers on B1, the same for sel_multi_adain, ccam
                        and mst (B4 alone; their SE bottleneck, CCAM
                        residuals and MST transform in plain PyTorch),
                        the wide standard-layout layers of adain, wct,
                        seg_adain (adain's stacks), mrf (its two encoders
                        one pass each, the 1024-channel decoder head) and
                        spade (its encoders; the SPADE generator float32,
                        instance norm only) on B5, sanet's and
                        dynamic_sanet's frozen VGG encode (conv_4 ..
                        conv_13 on the 2N batch) and mirror decoder (conv0
                        .. conv5) on B5, sanet's two attention modules on
                        B6, dynamic_sanet's adaptive attention in plain
                        PyTorch, src's 4-stage encode (conv_4 .. conv_9)
                        and decoder on B5, LD v1's (``ld_adain``) 3x3
                        small branches and decoder convs on B5 and its 7x7
                        big branches on B5's 7x7 form, LD v2's
                        (``ld_adain2``) small branch, pooled-branch conv_a
                        / conv_b and decoder convs on B5 (on a CPU device:
                        the kernels' plain versions); flagship configs
                        without int8
                        layers (4 * hidden_dim % 128) serve standard, with
                        a warning,
  * ``--mode folded``   exact space-to-depth execution on the hand-written
                        B1 CUDA kernel (on a CPU device: its plain version),
  * ``--mode standard`` the plain model path (sanet: the frozen 5-stage
                        VGG, the attention transform on the hand-written
                        B6 kernel, the mirror decoder; dynamic_sanet the
                        same with its adaptive transform; src: the 4-stage
                        VGG, AdaIN, the mirror decoder; the LD family its
                        dual-branch stacks in PyTorch),
  * ``--mode auto``     the path measured fastest on the H100 at --batch
                        (``rpst_torch.policy``, PERF.md section 6).

At the end it logs the B1, B4, B7, B5 (and, among B5's, its 7x7 form's)
and B6 launch counts of the run. Networks: all 17 of the registry:
multi_adain (the flagship), sel_multi_adain, ccam, mst, adain, wct, mrf,
spade, seg_adain, sanet, dynamic_sanet, src and ld_adain .. ld_adain5
(``--mode folded`` and ``q8`` fall back to standard, with a warning, for a
config the folded path does not cover: the feature models, the wide
standard-layout networks, the LD family, and ccam's and mst's yamls with
their ``shuffle: true``, which ``--set shuffle=false`` turns off; src's
and ld_adain's ``use_mask: true``, spade's batch norms and ld_adain3-5
serve standard under q8; ``--set use_mask=false`` serves ld_adain's q8;
the flagship yaml's ``attention: se`` serves standard under folded and q8;
``--mode auto`` serves the LD family standard, ``rpst_torch.policy``). The
requests carry no segmentation masks, so ``use_mask`` stylizes by plain
AdaIN here, as rpst's ``serve.py`` does; ``test_torch.py`` stylizes a
test set with its masks. The feature
models (sanet, dynamic_sanet, src) load their frozen VGG from the config's
``vgg`` (``.pth`` or ``.npz``), or seed a random one, with a warning.

Weights: ``--weights`` takes a reference-layout ``.pth`` (written from an
rpst checkpoint by ``tools/export_reference_checkpoint.py``) or an ``.npz``
of flax parameter paths; without it the weights are seeded from the
config's ``seed``, with a warning.

``--mesh`` (rpst ``serve.py:99-133``) sweeps --content, or serves the
daemon, over ranks, one process each, which the command starts itself after
building the CUDA kernels once (``rpst_torch.dist.launch``): ``--mesh N``
data parallel over N ranks, each stylizing its share of every batch, for
every network; ``--mesh data=a,spatial=b`` also shards image rows, the
row-sharded folded stylize of multi_adain, sel_multi_adain and ccam (halo
rows and all-reduced statistics; ``img_size % (4 * spatial) == 0``), the
row-sharded standard stylize of sanet and dynamic_sanet (``--mode
standard``: halo VGG convs, B6 on each rank's query rows, in the config's
compute_dtype; ``img_size % (32 * spatial) == 0``), and the row-sharded
standard stylize of every other network but mst (adain, wct, mrf, spade,
seg_adain, src, ld_adain .. ld_adain5, and multi_adain, sel_multi_adain
and ccam in ``--mode standard``: rpst's GSPMD route, the one-device
stylize with halo rows and statistics summed over the shares; launches no
kernel of the port; ``img_size % spatial == 0``). Under a mesh ``--mode
q8`` gives way to folded with a warning, mst refuses a spatial axis, and a
``model`` axis raises ``ValueError`` (serving takes data and spatial, as
rpst's). With ``--daemon`` rank 0 owns the
socket and the batcher and sends each batch to every rank; ``{"cmd":
"shutdown"}`` stops them all. Rank 0 writes the images. Ranks share a card
over gloo where they outnumber the GPUs.

Usage:
  python serve_torch.py --config cfg.yaml --content in/ --style style.png \
      --out stylized/ [--mode folded] [--batch 8] [--device cuda] \
      [--weights w.pth] [--mesh N | --mesh data=a,spatial=b] \
      [--set key=val ...]
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
from rpst_torch.dist import (is_main_process, make_mesh, rank_device,
                             replicate, setup_distributed)
from rpst_torch.dist.launch import spawn
from rpst_torch.metrics import logger, save_image
from rpst_torch.models import build_model, build_vgg
from rpst_torch.nn.blocks import init_torch_default
from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8
from rpst_torch.ops.flash_attention import launch_counts
from rpst_torch.ops.folded_conv import fused_folded_conv
from rpst_torch.ops.folded_conv2_q8 import fused_folded_conv2_q8
from rpst_torch.ops.folded_conv_q8 import fused_folded_conv_q8
from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                gather_batch, make_mesh_run_impl,
                                make_run_impl, mesh_mode, parse_mesh,
                                resolve_mode, serve_daemon, serve_ranks)


def _load_images(path: Path, img_size: int):
    return [(p.stem, load_image(p, img_size)) for p in image_paths(path)]


def _log_launches():
    for label, fn in (("B1", fused_folded_conv), ("B4", fused_folded_conv_q8),
                      ("B7", fused_folded_conv2_q8),
                      ("B5", fused_conv2d_q8)):
        logger.info(f"{label} {fn.__name__} launches: {fn.launches}")
    logger.info(f"7x7 B5 {fused_conv2d_q8.__name__} launches: "
                f"{fused_conv2d_q8.launches_7x7}")
    logger.info(f"B6 flash_attention launches: {launch_counts()['B6_fwd']}")


def main(argv=None):
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
    parser.add_argument("--mesh", default="1",
                        help="N (data parallel over N ranks) or axis=size "
                        "pairs like data=2,spatial=2 (a spatial axis shards "
                        "image rows: the folded multi_adain, "
                        "sel_multi_adain, ccam; sanet and dynamic_sanet "
                        "standard)")
    parser.add_argument("--set", nargs="*", default=[])
    # a rank's place, added by the command to the ranks it starts
    parser.add_argument("--rank-init", default="", help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=-1,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

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
    mesh_shape = parse_mesh(args.mesh)
    world = int(np.prod(list(mesh_shape.values())))
    mesh = None
    if world > 1:
        if args.batch % mesh_shape.get("data", 1):
            raise ValueError(f"--batch {args.batch} must divide by the data "
                             f"axis {mesh_shape.get('data', 1)}")
        if args.rank < 0:
            # refuse here what every rank would refuse, then start them
            probe = build_model(cfg)
            mesh_mode(probe, resolve_mode(probe, args.mode,
                                          batch=args.batch), mesh_shape)
            logger.info(f"--mesh {mesh_shape}: starting {world} ranks")
            rc = spawn([str(Path(__file__).resolve()),
                        *(argv if argv is not None else sys.argv[1:])],
                       world, lambda r, url: ["--rank-init", url, "--rank",
                                              str(r)],
                       build_kernels=device.type == "cuda")
            if rc:
                raise SystemExit(f"serve_torch.py: a rank exited with {rc}")
            return
        # a daemon's ranks wait in the next broadcast while it is idle
        setup_distributed(args.rank_init, world, args.rank, device.type,
                          timeout_s=7 * 86400.0 if args.daemon else 600.0)
        mesh = make_mesh(mesh_shape, rank_device(device.type))
        device = mesh.device
        if device.type == "cuda":
            torch.cuda.set_device(device)

    bundle = build_model(cfg, device)
    mode = resolve_mode(bundle, args.mode, batch=args.batch)
    if mesh is not None:
        mode = mesh_mode(bundle, mode, mesh_shape)
    if args.weights:
        bundle.load_state_dict(load_weights(args.weights))
        logger.info(f"Loaded weights {args.weights}")
    else:
        init_torch_default(bundle.model, cfg.seed)
        logger.warning(f"No --weights: serving randomly initialized params "
                       f"(seed {cfg.seed})")
    if mesh is not None:
        replicate(bundle.model, mesh)

    if bundle.from_features:
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
    run_impl = (make_run_impl(bundle, mode, scales) if mesh is None
                else make_mesh_run_impl(bundle, mode, mesh))

    def run_u8(content, style):
        """uint8 across the host<->device boundary (4x less transfer than
        float32); the /255 and the save-side clip*255+0.5 run on the device,
        so the PNG bytes equal the host-side math."""
        y = run_impl(content.float() / 255.0, style.float() / 255.0)
        return (torch.clamp(y.float(), 0.0, 1.0) * 255.0 + 0.5).to(
            torch.uint8)

    out_dir = Path(args.out)
    if is_main_process():
        out_dir.mkdir(parents=True, exist_ok=True)
    style_u8 = to_u8(styles[0][1])

    if args.daemon:
        run, follow, stop = (run_u8, None, None) if mesh is None \
            else serve_ranks(run_u8, mesh)
        if follow is not None and not is_main_process():
            follow()  # until rank 0's daemon stops
        else:
            # on a mesh the batches stay on the host: rank 0 sends them
            batcher = DynamicBatcher(
                run, batch_size=args.batch, max_wait_ms=args.max_wait_ms,
                device=device if mesh is None else "cpu")
            try:
                serve_daemon(batcher, cfg.img_size, out_dir, port=args.port,
                             default_style=style_u8, to_u8=to_u8)
            finally:
                batcher.close()
                if stop is not None:
                    stop()
            _log_launches()
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
        return

    style_dev = torch.from_numpy(style_u8)[None].to(device)

    def _dispatch(chunk):
        """Decode + copy + asynchronous launch of one batch (on a mesh: this
        rank's share, the last batch padded to a whole share a rank; the
        shares gathered)."""
        imgs = [img for _, img in chunk]
        if mesh is not None:
            d = mesh.data
            imgs += imgs[-1:] * (-len(imgs) % d)
            per = len(imgs) // d
            i = mesh.axis("data").index
            imgs = imgs[i * per:(i + 1) * per]
        batch = torch.from_numpy(to_u8(np.stack(imgs)))
        b = batch.to(device)
        y = run_u8(b, style_dev.expand(b.shape[0], -1, -1, -1))
        return y if mesh is None else gather_batch(y, mesh)

    def _flush(chunk, out):
        arr = out.cpu().numpy()  # waits for the device
        if not is_main_process():  # rank 0 writes the images
            return
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
    if is_main_process():
        logger.info(f"Stylized {n_done} images in {dt:.2f}s "
                    f"({n_done / dt:.1f} img/s incl host IO, {device}"
                    + (f", mesh {mesh_shape}" if mesh is not None else "")
                    + f") -> {out_dir}")
        _log_launches()
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
