#!/usr/bin/env python
"""Training driver of the PyTorch/CUDA port; the one-device counterpart of
``train.py``.

Same flags (``--config <yaml>``, ``--set key=value``), same YAML files, same
output tree (``<output>/logs/metrics.jsonl``, ``<output>/checkpoints/<step>``),
same cadence keys (``log_iter``, ``snapshot_save_iter``, ``max_iter``: steps
1 .. max_iter-1 of each run, numbered after the resumed step), same loss
mixing, Adam and lr schedule, and the same non-finite skip. The flagship
(``multi_adain``, constant stack) trains folded (``exec_strategy: folded``:
every folded conv on B1, its backward on B2 and B3 when the tensors are on
the card) or standard; with ``train_q8_targets: true`` its style and content
loss targets come from the int8 VGG chain on B5, calibrated once on the
first batch. ``adain`` trains standard (autograd through the library convs;
it needs no kernel). ``sanet`` (``configs/train_static_sanet.yaml``) trains
standard over a frozen 5-stage VGG: every attention module runs B6's forward
with its log-sum-exp and the two B6 backward kernels (three stylize passes of
two modules: 6 / 6 / 6 launches per step).

    python train_torch.py --config cfg.yaml [--set key=value ...]
                          [--device cuda|cpu]

``--device cuda`` (the default) without a CUDA device exits non-zero;
``--device cpu`` runs the kernels' plain PyTorch versions. At the end it
logs the B6, B5 and B1/B2/B3 launch counts of the run. Options of later slices
raise ``NotImplementedError`` naming their ROADMAP.md slice: ``mesh_shape``
and ``distributed`` (slice 8), ``target_cache`` (section A item 7),
``grad_accum > 1`` and ``remat`` (slice 8), ``test_dir`` test dumps (slice
7), and every network but ``multi_adain``, ``adain`` and ``sanet`` (wct
training is slice 5b, ``dynamic_sanet`` and ``src`` slice 6b).
"""

import argparse
import sys
import time
from pathlib import Path

import yaml

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

from rpst_torch.config import load_config  # noqa: E402
from rpst_torch.data import ImageFolderDataset, InfiniteLoader  # noqa: E402
from rpst_torch.metrics import logger  # noqa: E402
from rpst_torch.models import build_model, build_vgg  # noqa: E402
from rpst_torch.models.fast_path_q8_std import (  # noqa: E402
    calibrate_vgg_targets_q8)
from rpst_torch.nn.blocks import init_torch_default  # noqa: E402
from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8  # noqa: E402
from rpst_torch.ops.flash_attention import launch_counts  # noqa: E402
from rpst_torch.ops.folded_conv import (  # noqa: E402
    fused_folded_conv, fused_folded_conv_grad_input,
    fused_folded_conv_grad_weight)
from rpst_torch.train.checkpoint import (latest_step,  # noqa: E402
                                         restore_checkpoint, save_checkpoint)
from rpst_torch.train.fault import CheckpointOnSignal  # noqa: E402
from rpst_torch.train.metrics import MetricWriter, StepTimer  # noqa: E402
from rpst_torch.train.step import create_train_state, train_step  # noqa: E402

# config key -> (is it asked for?, the ROADMAP.md place that ports it)
_UNPORTED = {
    "mesh_shape": (lambda c: bool(c.mesh_shape), "section A slice 8"),
    "distributed": (lambda c: bool(c.distributed), "section A slice 8"),
    "target_cache": (lambda c: bool(c.get("target_cache", 0)),
                     "section A item 7"),
    "grad_accum": (lambda c: int(c.grad_accum) > 1, "section A slice 8"),
    "remat": (lambda c: bool(c.remat), "section A slice 8"),
    "test_dir": (lambda c: bool(c.test_dir), "section A slice 7 (test dumps)"),
}


def check_ported(cfg) -> None:
    """Raise NotImplementedError for a config this port cannot train yet."""
    if cfg.network == "wct":
        raise NotImplementedError(
            "train_torch.py: wct training (the frozen-encoder resume, "
            "freeze_prefixes) is ROADMAP.md section A slice 5b")
    if cfg.network not in ("multi_adain", "adain", "sanet"):
        raise NotImplementedError(
            f"train_torch.py trains multi_adain, adain and sanet only; "
            f"{cfg.network!r} is ROADMAP.md section A slices 4-6b")
    for key, (asked, where) in _UNPORTED.items():
        if asked(cfg):
            raise NotImplementedError(
                f"train_torch.py: {key} is not ported yet: ROADMAP.md {where}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--set", nargs="*", default=[],
                    help="key=value config overrides (YAML values)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = yaml.safe_load(v)
    cfg = load_config(args.config, overrides)
    check_ported(cfg)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_torch.py: --device cuda but "
                         "torch.cuda.is_available() is False (use --device "
                         "cpu to train on the plain PyTorch versions)")
    device = torch.device(args.device)
    if device.type == "cuda":  # f32 convs outside the kernels in full f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    output = Path(cfg.output)
    for sub in ("logs", "checkpoints"):
        (output / sub).mkdir(exist_ok=True, parents=True)
    writer = MetricWriter(output)

    bundle = build_model(cfg, device)
    init_torch_default(bundle.model, cfg.seed)
    vgg, vgg_source = build_vgg(cfg, device)
    bundle.vgg = vgg  # sanet stylizes from its features
    if cfg.vgg and vgg_source == str(cfg.vgg):
        logger.info(f"Loaded VGG weights from {cfg.vgg}")
    else:
        logger.warning(f"VGG weights {cfg.vgg!r} not found: using {vgg_source} "
                       "(perceptual losses hold no meaning; fine for smoke "
                       "runs)")

    content_ds = ImageFolderDataset(cfg.content_dir, cfg.img_size, fmt="*")
    style_ds = ImageFolderDataset(cfg.style_dir, cfg.img_size, fmt="*/*")
    if len(style_ds) == 0:  # the reference uses '*/*' for wikiart subdirs
        style_ds = ImageFolderDataset(cfg.style_dir, cfg.img_size, fmt="*")
    if not len(content_ds) or not len(style_ds):
        raise SystemExit(f"no images: {len(content_ds)} content in "
                         f"{cfg.content_dir!r}, {len(style_ds)} style in "
                         f"{cfg.style_dir!r}")

    state = create_train_state(bundle)
    begin = 0
    if cfg.resume:
        ckpt = cfg.checkpoint_path or None
        if not ckpt:
            step = latest_step(output / "checkpoints")
            ckpt = output / "checkpoints" / str(step) if step else None
        if ckpt and Path(ckpt).exists():
            restore_checkpoint(ckpt, state)
            begin = state.step
            logger.info(f"Loaded checkpoint from {ckpt} (step {begin})")
        else:
            logger.warning(f"resume requested but no checkpoint at {ckpt}")

    # the resumed run continues both image streams where the saved run
    # stopped (one batch per step)
    content_iter = InfiniteLoader(content_ds, cfg.batch_size,
                                  cfg.num_workers, seed=cfg.seed, skip=begin)
    style_iter = InfiniteLoader(style_ds, cfg.batch_size, cfg.num_workers,
                                seed=cfg.seed + 1, skip=begin)
    if cfg.train_q8_targets:
        # int8 no-grad VGG loss targets: the encoder is frozen, so scales
        # calibrated once on a representative batch hold for the whole run;
        # only the folded loss consumes them (ModelBundle.loss)
        if bundle.folded_exec() and cfg.img_size % 8 == 0:
            bundle.q8_target_scales = calibrate_vgg_targets_q8(
                vgg, torch.from_numpy(next(content_iter)).to(device),
                torch.from_numpy(next(style_iter)).to(device))
            logger.info("train_q8_targets: calibrated "
                        f"{len(bundle.q8_target_scales['act_scales'])} VGG "
                        "target scales (int8 no-grad loss targets"
                        + ("" if bundle.q8_targets_active(cfg.batch_size)
                           else "; inactive at this batch size: "
                           "rpst_torch.policy.TRAIN_Q8_TARGETS_MIN_BATCH")
                        + ")")
        else:
            logger.warning("train_q8_targets ignored: needs a folded "
                           "multi_adain config and img_size % 8 == 0")
    logger.info(f"Training {cfg.network} ({'folded' if bundle.folded_exec() else 'standard'}, "
                f"{cfg.compute_dtype}) on {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else "")
                + f", batch {cfg.batch_size}, {cfg.img_size}px")

    counters = (fused_folded_conv, fused_folded_conv_grad_input,
                fused_folded_conv_grad_weight)
    launches0 = [c.launches for c in counters]
    b5_0 = fused_conv2d_q8.launches
    b6_0 = launch_counts()
    timer = StepTimer(sync_every=max(cfg.log_iter, 10), device=device)
    try:
        with CheckpointOnSignal() as stop:
            for i in range(1, cfg.max_iter):
                start = time.perf_counter()
                content = torch.from_numpy(next(content_iter)).to(device)
                style = torch.from_numpy(next(style_iter)).to(device)
                parts = train_step(state, vgg, content, style)
                timer.tick()
                if i % cfg.log_iter == 0:
                    values = {k: float(v) for k, v in parts.items()}
                    elapsed = time.perf_counter() - start
                    writer.write(begin + i, values)
                    rate = timer.steps_per_sec
                    rate_str = (f", img/s {rate * cfg.batch_size:.2f}"
                                if rate == rate else
                                f", img/s {cfg.batch_size / elapsed:.2f}")
                    loss_str = "".join(f", {k} {v}"
                                       for k, v in sorted(values.items()))
                    logger.info(f"Iterations {begin + i}, elapsed time: "
                                f"{elapsed:.3f}{rate_str}{loss_str}")
                if (i % cfg.snapshot_save_iter == 0 or (i + 1) == cfg.max_iter
                        or stop.requested):
                    path = save_checkpoint(output / "checkpoints", state)
                    logger.info(f"Saved checkpoint {path}")
                if stop.requested:
                    logger.info("Signal received: checkpointed, exiting")
                    break
    finally:
        content_iter.close()
        style_iter.close()
        writer.close()
    b1, b2, b3 = (c.launches - n for c, n in zip(counters, launches0))
    logger.info("B6 fwd/dq/dkv launches: " + "/".join(
        str(n - b6_0[k]) for k, n in launch_counts().items()))
    logger.info(f"B5 fused_conv2d_q8 launches: "
                f"{fused_conv2d_q8.launches - b5_0}")
    logger.info(f"B1/B2/B3 launches: {b1}/{b2}/{b3}")


if __name__ == "__main__":
    main()
