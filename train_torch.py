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
(``rpst_torch.train.step``). ``profile_iter: k`` (0, off, by default) makes
rank 0 trace steps k .. k + ``profile_steps`` - 1 of the loop with
``torch.profiler`` into ``<output>/logs/trace`` (``*.pt.trace.json``;
``rpst_torch.train.profiler``), as rpst's ``train.py:281-298``. Where
``tensorboard`` imports, the metrics are also written as TensorBoard event
files beside ``metrics.jsonl``.

Multi-device runs (rpst ``train.py:61-98``): ``mesh_shape`` lays the ranks
on ``data``, ``spatial`` and ``model`` axes (``{data: 2}``, ``{spatial:
2}``, ``{data: 2, spatial: 2}``, ``{data: 2, model: 2}``), one process per
rank, each on ``cuda:(local_rank % device_count)`` (or the CPU). Without ``distributed`` the command starts its
own ranks on this host, after building the CUDA kernels once
(``rpst_torch.dist.launch``); with ``distributed: true`` each process is
one rank, started from outside with ``coordinator_address`` (``host:port``
or a ``tcp://`` / ``file://`` URL), ``num_processes`` and ``process_id``
(or torchrun's environment where unset). The folded multi_adain, ccam and
sel_multi_adain train row-sharded on B1-B3's halo modes (also on a mesh
without a ``spatial`` axis, as rpst's shard_map); on a ``spatial`` axis
every other network but mst (and the folded three where that route turns
them away, or beside a ``model`` axis) trains its standard layout
row-sharded (``rpst_torch.train.step``'s "rows" route, rpst's GSPMD step:
the one-device loss on each rank's rows, sanet's attention on B6b-d);
without one, data parallel, its BatchNorm statistics over the global
batch. mst on a ``spatial`` axis raises ``ValueError``, as rpst's does. A
``model`` axis (any network; rpst's ``tp_shardings``) keeps each rank's
share of every conv kernel and per-channel vector of at least 32 channels,
and of their Adam moments, and computes each sharded conv's output-channel
share (``rpst_torch.dist.tp``; the folded convs on B1-B3 at the share's
width), also beside a ``spatial`` axis. The log names the route taken.
Each data rank draws its share of the image stream (``InfiniteSampler``'s
shards), the ranks of one model group the same share, and the ranks of one
row group split its images' rows. Every rank takes the stop decision of a
SIGTERM / SIGINT together, at ``log_iter`` boundaries (the maximum of the
ranks' flags), so all checkpoint the same step and exit 0. Rank 0 alone
writes the checkpoints, the metrics and the test dumps (on a model axis
every rank first joins the gather to the full shapes: the checkpoint is
the one-device layout, and a resume on any mesh re-shards it); the target
cache and the int8 loss targets stay off on a mesh, as in rpst. Ranks
share a card over gloo where there are more ranks than GPUs (NCCL
otherwise).
"""

import argparse
import logging
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
from rpst_torch.dist import (check_mesh_shape, is_main_process,  # noqa: E402
                             make_mesh, max_over, rank_device, replicate,
                             setup_distributed, shard_rows, tp)
from rpst_torch.dist.launch import in_rank, spawn  # noqa: E402
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
from rpst_torch.train.profiler import start_trace, stop_trace  # noqa: E402
from rpst_torch.train.step import (create_train_state,  # noqa: E402
                                   train_route, train_step)
from rpst_torch.train.target_cache import DeviceTargetCache  # noqa: E402


def check_ported(cfg) -> None:
    """Raise, before any rank starts, for a mesh no route trains: mst on a
    ``spatial`` axis, an img_size the ``spatial`` axis does not divide, an
    unknown axis (``ValueError``, as rpst refuses them)."""
    if cfg.mesh_shape:
        train_route(build_model(cfg), check_mesh_shape(cfg.mesh_shape))


def mesh_size(cfg) -> int:
    size = 1
    for v in (cfg.mesh_shape or {}).values():
        size *= int(v)
    return size


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
    if mesh_size(cfg) > 1 and not cfg.distributed and not in_rank():
        # start this command's ranks here, each a process of its own
        world = mesh_size(cfg)
        logger.info(f"mesh {dict(cfg.mesh_shape)}: starting {world} ranks")
        rc = spawn(
            [str(Path(__file__).resolve()), "--config", args.config,
             "--device", args.device, "--set", *args.set], world,
            lambda r, url: ["distributed=true",
                            f"coordinator_address={url}",
                            f"num_processes={world}", f"process_id={r}"],
            build_kernels=args.device == "cuda")
        if rc:
            raise SystemExit(f"train_torch.py: a rank exited with {rc}")
        return
    mesh = None
    if cfg.distributed or in_rank():
        setup_distributed(cfg.coordinator_address, cfg.num_processes,
                          cfg.process_id, args.device)
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_world_size() > 1:
            mesh = make_mesh(cfg.mesh_shape, rank_device(args.device))
        if not is_main_process():  # rank 0 logs the run
            logger.setLevel(logging.WARNING)
    device = mesh.device if mesh is not None else torch.device(args.device)
    if device.type == "cuda":  # f32 convs outside the kernels in full f32
        if mesh is not None:  # this rank's card
            torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    main_proc = is_main_process()
    data_shards = mesh.data if mesh is not None else 1
    if cfg.batch_size % data_shards:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"{data_shards} data ranks")
    local_batch = cfg.batch_size // data_shards
    data_index = mesh.axis("data").index if mesh is not None else 0

    bundle = build_model(cfg, device)
    init_torch_default(bundle.model, cfg.seed)
    if mesh is not None:
        replicate(bundle.model, mesh)
        if mesh.model > 1:  # this rank's channel shares from here on
            whole = tp.stored_numel(bundle.model)
            n = tp.shard_model(bundle.model, mesh.axis("model"))
            logger.info(f"model axis {mesh.model}: {n} leaves channel-"
                        f"sharded, {tp.stored_numel(bundle.model)} of "
                        f"{whole} parameter and buffer elements stored a "
                        "rank")
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
    # start writes nothing; rank 0 alone writes it
    output = Path(cfg.output)
    if main_proc:
        for sub in ("logs", "checkpoints"):
            (output / sub).mkdir(exist_ok=True, parents=True)
    writer = MetricWriter(output) if main_proc else None

    # a wct resume freezes the encoder (rpst train.py:158)
    freeze = ("encoder",) if (cfg.network == "wct" and cfg.resume) else ()
    state = create_train_state(bundle, freeze_prefixes=freeze, mesh=mesh)
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
                  and int(cfg.get("grad_accum", 1)) == 1 and mesh is None)
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
    # a data rank draws its share of each stream, local_batch a step
    shard = dict(shard_index=data_index, shard_count=data_shards)
    content_iter = InfiniteLoader(content_ds, local_batch,
                                  cfg.num_workers, seed=cfg.seed, skip=begin,
                                  with_indices=use_tcache, **shard)
    style_iter = InfiniteLoader(style_ds, local_batch, cfg.num_workers,
                                seed=cfg.seed + 1, skip=begin,
                                with_indices=use_tcache, **shard)
    route = train_route(bundle, mesh)
    if mesh is not None:
        logger.info(f"Mesh: {dict(mesh.shape)} over {mesh.backend}: "
                    + {"spatial": "row-sharded folded training (B1-B3 halo "
                                  "modes on each rank's rows)",
                       "rows": "row-sharded standard layout (the "
                               "one-device loss on each rank's rows"
                               + (", channel tensor parallel on the model "
                                  "axis" if mesh.model > 1 else "") + ")",
                       "model": "channel tensor parallel (each rank's "
                                "output-channel shares), data parallel "
                                "over data"}.get(route, "data parallel"))
    if cfg.train_q8_targets and mesh is not None:
        if route == "spatial":
            logger.info("train_q8_targets inactive: the row-sharded folded "
                        "route keeps float loss targets (its loss runs on "
                        "the rows of each rank)")
        else:
            logger.warning("train_q8_targets skipped on a multi-device "
                           "mesh, as rpst skips it")
    elif cfg.train_q8_targets and use_tcache:
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

    sharded = tp.is_sharded(bundle.model)
    dump_copy = {}

    def dump_bundle():
        """The bundle the test dumps stylize: on a model axis a one-device
        copy (every rank joins the gather; rank 0 gets the copy)."""
        if not sharded:
            return bundle
        full = tp.full_state_dict(bundle.model)
        if not main_proc:
            return None
        if "b" not in dump_copy:
            dump_copy["b"] = build_model(cfg, device)
            dump_copy["b"].vgg = vgg
        dump_copy["b"].load_state_dict(full)
        return dump_copy["b"]

    counters = (fused_folded_conv, fused_folded_conv_grad_input,
                fused_folded_conv_grad_weight)
    launches0 = [c.launches for c in counters]
    b5_0 = fused_conv2d_q8.launches
    b6_0 = launch_counts()
    timer = StepTimer(sync_every=max(cfg.log_iter, 10), device=device)
    trace_dir = output / "logs" / "trace"
    profiling = False
    try:
        with CheckpointOnSignal() as stop:
            for i in range(1, cfg.max_iter):
                start = time.perf_counter()
                # rpst train.py:281-298: rank 0 traces steps profile_iter ..
                # profile_iter + profile_steps - 1 of this run's loop
                if cfg.profile_iter and main_proc:
                    if i == cfg.profile_iter:
                        start_trace(trace_dir, device)
                        profiling = True
                    elif profiling and i >= (cfg.profile_iter
                                             + cfg.profile_steps):
                        stop_trace()
                        profiling = False
                        logger.info(f"Wrote device trace for steps "
                                    f"{cfg.profile_iter}..{i - 1} -> "
                                    f"{trace_dir}")
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
                if route in ("spatial", "rows"):  # this rank's rows of its
                    content = shard_rows(content, mesh).contiguous()  # share
                    style = shard_rows(style, mesh).contiguous()
                    if label is not None:
                        label = shard_rows(label, mesh).contiguous()
                parts = train_step(state, vgg, content, style,
                                   targets=targets, content_label=label)
                timer.tick()
                if i % cfg.log_iter == 0 and main_proc:
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
                    dumped = dump_bundle()
                    if main_proc:
                        dump_test_set(dumped, test_ds, cfg.batch_size,
                                      output / "test" / str(begin + i))
                # the ranks agree on a stop at log_iter boundaries (rpst
                # train.py:354-381): a rank that stopped alone would leave
                # the others waiting in the next collective
                stop_now = stop.requested
                if mesh is not None:
                    stop_now = (max_over(stop.requested, device)
                                if i % cfg.log_iter == 0 else False)
                if (i % cfg.snapshot_save_iter == 0 or (i + 1) == cfg.max_iter
                        or stop_now) and (main_proc or sharded):
                    path = save_checkpoint(output / "checkpoints", state,
                                           write=main_proc)
                    if main_proc:
                        logger.info(f"Saved checkpoint {path}")
                if stop_now:
                    rank = mesh.rank if mesh is not None else 0
                    logger.warning(f"Signal received: rank {rank} stops "
                                   f"after step {begin + i}, checkpointed")
                    break
    finally:
        if profiling:  # the loop ended inside the trace window
            stop_trace()
        content_iter.close()
        style_iter.close()
        if writer is not None:
            writer.close()
    b1, b2, b3 = (c.launches - n for c, n in zip(counters, launches0))
    logger.info("B6 fwd/dq/dkv launches: " + "/".join(
        str(n - b6_0[k]) for k, n in launch_counts().items()))
    logger.info(f"B5 fused_conv2d_q8 launches: "
                f"{fused_conv2d_q8.launches - b5_0}")
    if use_tcache:
        logger.info(f"target_cache stats: {target_cache.stats()}")
    logger.info(f"B1/B2/B3 launches: {b1}/{b2}/{b3}")
    if mesh is not None:
        logger.info("B2 row_rings=False / B3 rings launches: "
                    f"{fused_folded_conv_grad_input.launches_halo}/"
                    f"{fused_folded_conv_grad_weight.launches_rings}")
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
