#!/usr/bin/env python
"""Training driver of the PyTorch/CUDA port; the one-device counterpart of
``train.py``.

Same flags (``--config <yaml>``, ``--set key=value``), same YAML files, same
output tree (``<output>/logs/metrics.jsonl``, ``<output>/checkpoints/<step>``),
same cadence keys (``log_iter``, ``snapshot_save_iter``, ``max_iter``: steps
1 .. max_iter-1 of each run, numbered after the resumed step), same loss
mixing, Adam and lr schedule, and the same non-finite skip (which also puts
back sel_multi_adain's BatchNorm running statistics). The flagship
(``multi_adain``, constant stack) and its three variants
(``sel_multi_adain``, ``ccam``, ``mst``; ccam's and mst's yamls need
``--set shuffle=false`` to fold) train folded (``exec_strategy: folded``:
every RP conv on B1, its backward on B2 and B3 when the tensors are on the
card) or standard; with ``train_q8_targets: true`` their style and content
loss targets come from the int8 VGG chain on B5, calibrated once on the
first batch, and with ``target_cache: N`` (N content slots,
``target_cache_style_slots`` style slots) from the device-resident target
cache, keyed by dataset index, which supersedes ``train_q8_targets``.
``adain`` trains standard (autograd through the library convs;
it needs no kernel). ``sanet`` (``configs/train_static_sanet.yaml``) trains
standard over a frozen 5-stage VGG: every attention module runs B6's forward
with its log-sum-exp and the two B6 backward kernels (three stylize passes of
two modules: 6 / 6 / 6 launches per step). ``dynamic_sanet``
(``configs/train_dynamic_sanet.yaml``) trains the same way with the adaptive
transform in float32, its attention plain PyTorch (streamed by query blocks
under ``torch.utils.checkpoint`` where ``adaptive_blockwise`` says so; no
kernel), and ``src`` (``configs/train_source_adain.yaml``) trains its
decoder over a frozen 4-stage VGG (no kernel; ``use_mask`` is not read).
``wct``, ``mrf``, ``spade`` and ``seg_adain`` train standard (no kernel of
the port), and so does the LD family (``ld_adain`` .. ``ld_adain5``, their
``configs/train_ld*_rp_adain.yaml``; ``ld_layer_num`` defaults to
``rp_blocks``; the v1 and v4 yamls' ``use_mask: true`` is not read in
training, as in rpst). A wct run with ``resume: true`` freezes the encoder
(rpst's ``freeze_prefixes``): its parameters get no update and no Adam
state, so a checkpoint saved without the freeze is refused, as rpst
refuses it.
seg_adain with ``seg_dir`` (a folder of Cityscapes side-by-side images:
content on the left ``img_size`` columns, the label ids on the next)
trains on labelled content batches, its segmentation head through the
class-weighted cross entropy; without it, unlabelled (the head then gets
zero gradients). The multiscale family takes ``attention: se`` (an SE
bottleneck in every encoder block, its BatchNorms moving their running
statistics) and ``sort``, which keep it off the folded path, as in rpst:
the flagship yaml (``configs/train_constant_multiscale_rp_adain.yaml``)
trains standard, as written.

With ``test_dir`` set, every ``test_iter`` steps the config's test set
(``test_dataset``) is stylized into ``<output>/test/<step>/``
(``{content}-{style}-cat.png`` and ``{content}-{style}.png``, rpst's
``run_test_dump``), with its segmentation masks where ``use_mask`` is set
and the set has them (``rpst_torch.dumps``).

    python train_torch.py --config cfg.yaml [--set key=value ...]
                          [--device cuda|cpu]

``--device cuda`` (the default) without a CUDA device exits non-zero;
``--device cpu`` runs the kernels' plain PyTorch versions. At the end it
logs the B6, B5 and B1/B2/B3 launch counts of the run. ``grad_accum: k``
splits each batch into k microbatches whose gradients are averaged before
one Adam step (the batch must divide by k; not with ``target_cache``), and
``remat: true`` recomputes the whole loss's forward in the backward
(``rpst_torch.train.step``). The multi-device options raise
``NotImplementedError`` naming their ROADMAP.md slice: ``mesh_shape`` and
``distributed`` (slice 8).
"""

import argparse
import sys
import time
from pathlib import Path

import yaml

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

from rpst_torch.config import load_config  # noqa: E402
from rpst_torch.data import (CityscapesDataset,  # noqa: E402
                             ImageFolderDataset, InfiniteLoader,
                             build_test_dataset)
from rpst_torch.dumps import dump_test_set  # noqa: E402
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
from rpst_torch.train.target_cache import DeviceTargetCache  # noqa: E402

# config key -> (is it asked for?, the ROADMAP.md place that ports it)
_UNPORTED = {
    "mesh_shape": (lambda c: bool(c.mesh_shape), "section A slice 8"),
    "distributed": (lambda c: bool(c.distributed), "section A slice 8"),
}


def check_ported(cfg) -> None:
    """Raise NotImplementedError for a config this port cannot train yet."""
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

    bundle = build_model(cfg, device)
    init_torch_default(bundle.model, cfg.seed)
    vgg, vgg_source = build_vgg(cfg, device)
    bundle.vgg = vgg  # the feature models stylize from its features
    if cfg.vgg and vgg_source == str(cfg.vgg):
        logger.info(f"Loaded VGG weights from {cfg.vgg}")
    else:
        logger.warning(f"VGG weights {cfg.vgg!r} not found: using {vgg_source} "
                       "(perceptual losses hold no meaning; fine for smoke "
                       "runs)")

    # labelled content (rpst train.py:112-132): seg_adain on a Cityscapes
    # side-by-side folder yields (content, label) batches
    seg_training = bool(cfg.network == "seg_adain" and cfg.seg_dir)
    content_ds = (CityscapesDataset(cfg.seg_dir, cfg.img_size)
                  if seg_training else
                  ImageFolderDataset(cfg.content_dir, cfg.img_size, fmt="*"))
    style_ds = ImageFolderDataset(cfg.style_dir, cfg.img_size, fmt="*/*")
    if len(style_ds) == 0:  # the reference uses '*/*' for wikiart subdirs
        style_ds = ImageFolderDataset(cfg.style_dir, cfg.img_size, fmt="*")
    if not len(content_ds) or not len(style_ds):
        raise SystemExit(f"no images: {len(content_ds)} content in "
                         f"{cfg.seg_dir if seg_training else cfg.content_dir!r}"
                         f", {len(style_ds)} style in {cfg.style_dir!r}")
    test_ds = build_test_dataset(cfg) if cfg.test_dir else None
    # the output tree is made once the data is there: a run that cannot
    # start writes nothing
    output = Path(cfg.output)
    for sub in ("logs", "checkpoints"):
        (output / sub).mkdir(exist_ok=True, parents=True)
    writer = MetricWriter(output)

    # a wct resume freezes the encoder (rpst train.py:158)
    freeze = ("encoder",) if (cfg.network == "wct" and cfg.resume) else ()
    state = create_train_state(bundle, freeze_prefixes=freeze)
    if freeze:
        logger.info(f"Frozen for this run: {', '.join(freeze)}")
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

    # the device-resident target cache (rpst train.py:199-213): the folded
    # families on one device, grad_accum 1 (the port trains no other way)
    use_tcache = (bool(cfg.get("target_cache", 0)) and bundle.folded_infer()
                  and not seg_training and cfg.img_size % 8 == 0
                  and int(cfg.get("grad_accum", 1)) == 1)
    if cfg.get("target_cache", 0) and not use_tcache:
        logger.warning("target_cache ignored: needs a single-device "
                       "folded-family run with grad_accum=1")
    target_cache = None
    if use_tcache:
        target_cache = DeviceTargetCache(
            img_size=cfg.img_size, dtype=bundle.folded_dtype(),
            content_slots=int(cfg.get("target_cache")),
            style_slots=int(cfg.get("target_cache_style_slots", 8192)),
            device=device)
        logger.info(f"target_cache: {target_cache.content_slots} content "
                    f"slots ({target_cache.nbytes() / 2 ** 20:.0f} MiB of "
                    f"device memory), {target_cache.style_slots} style slots "
                    "— the style/content VGG target pass is skipped on hits")

    # the resumed run continues both image streams where the saved run
    # stopped (one batch per step); the cache keys batches by dataset index
    content_iter = InfiniteLoader(content_ds, cfg.batch_size,
                                  cfg.num_workers, seed=cfg.seed, skip=begin,
                                  with_indices=use_tcache)
    style_iter = InfiniteLoader(style_ds, cfg.batch_size, cfg.num_workers,
                                seed=cfg.seed + 1, skip=begin,
                                with_indices=use_tcache)
    if cfg.train_q8_targets and use_tcache:
        logger.info("train_q8_targets superseded by target_cache (the "
                    "target pass it quantizes is skipped entirely)")
    elif cfg.train_q8_targets:
        # int8 no-grad VGG loss targets: the encoder is frozen, so scales
        # calibrated once on a representative batch hold for the whole run;
        # only the folded loss consumes them (ModelBundle.loss)
        if bundle.folded_infer() and cfg.img_size % 8 == 0:
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
            logger.warning("train_q8_targets ignored: needs a folded-family "
                           "config and img_size % 8 == 0")
    logger.info(f"Training {cfg.network} ({'folded' if bundle.folded_infer() else 'standard'}, "
                f"{cfg.compute_dtype}"
                + (", labelled content from seg_dir" if seg_training else "")
                + f") on {device}"
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
                targets = label = None
                if seg_training:
                    content_np, label_np = next(content_iter)
                    content = torch.from_numpy(content_np).to(device)
                    label = torch.from_numpy(label_np).to(device)
                    style = torch.from_numpy(next(style_iter)).to(device)
                elif use_tcache:
                    c_idx, content_np = next(content_iter)
                    s_idx, style_np = next(style_iter)
                    content = torch.from_numpy(content_np).to(device)
                    style = torch.from_numpy(style_np).to(device)
                    targets = target_cache.targets_for_batch(
                        vgg, style, content, s_idx, c_idx)
                else:
                    content = torch.from_numpy(next(content_iter)).to(device)
                    style = torch.from_numpy(next(style_iter)).to(device)
                parts = train_step(state, vgg, content, style,
                                   targets=targets, content_label=label)
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
                    if use_tcache:
                        tc = target_cache.stats()
                        loss_str += (f", tcache_hit_steps {tc['hit_steps']}"
                                     f"/{tc['hit_steps'] + tc['miss_steps']}")
                    logger.info(f"Iterations {begin + i}, elapsed time: "
                                f"{elapsed:.3f}{rate_str}{loss_str}")
                if test_ds is not None and i % cfg.test_iter == 0:
                    dump_test_set(bundle, test_ds, cfg.batch_size,
                                  output / "test" / str(begin + i))
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
    if use_tcache:
        logger.info(f"target_cache stats: {target_cache.stats()}")
    logger.info(f"B1/B2/B3 launches: {b1}/{b2}/{b3}")


if __name__ == "__main__":
    main()
