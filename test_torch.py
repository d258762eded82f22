#!/usr/bin/env python
"""Batch-inference driver of the PyTorch/CUDA port; the counterpart of
``test.py``, with the same flags plus ``--device``.

It builds the config's network, restores the newest checkpoint under
``<output>/checkpoints`` (or ``checkpoint_path``) that ``train_torch.py``
wrote, stylizes the config's test set (``test_dir``, ``test_dataset``:
paired, photoreal, iden_photoreal or fmt) in batches of ``batch_size``, and
writes ``{content}-{style}-cat.png`` (content, style and stylized side by
side) and ``{content}-{style}.png`` under ``<output>/test/test_output/``.
With ``use_mask: true`` and a photoreal set's ``labelme_segmentation/``
masks, each batch stylizes with its masks (segment-masked AdaIN, on the
standard path); dynamic_sanet also writes its claim maps to
``<output>/claim_map/it_<step>_bid_<batch>.png``. The feature models
(sanet, dynamic_sanet, src) load their frozen VGG from the config's
``vgg``, or seed a random one, with a warning.

    python test_torch.py --config cfg.yaml [--set key=value ...]
                         [--device cuda|cpu]

``--device cuda`` (the default) without a CUDA device exits non-zero;
``--device cpu`` runs the kernels' plain PyTorch versions. At the end it
logs the B1, B4, B5 and B6 launch counts of the run.
"""

import argparse
import sys
from pathlib import Path

import yaml

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

from rpst_torch.config import load_config  # noqa: E402
from rpst_torch.data import build_test_dataset  # noqa: E402
from rpst_torch.dumps import dump_test_set  # noqa: E402
from rpst_torch.metrics import logger  # noqa: E402
from rpst_torch.models import build_model, build_vgg  # noqa: E402
from rpst_torch.nn.blocks import init_torch_default  # noqa: E402
from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8  # noqa: E402
from rpst_torch.ops.flash_attention import launch_counts  # noqa: E402
from rpst_torch.ops.folded_conv import fused_folded_conv  # noqa: E402
from rpst_torch.ops.folded_conv_q8 import fused_folded_conv_q8  # noqa: E402
from rpst_torch.train.checkpoint import (latest_step,  # noqa: E402
                                         restore_checkpoint)
from rpst_torch.train.step import create_train_state  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=str,
                    default="config/TrainConfig.yaml")
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
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("test_torch.py: --device cuda but "
                         "torch.cuda.is_available() is False (use --device "
                         "cpu to stylize on the plain PyTorch versions)")
    device = torch.device(args.device)
    if device.type == "cuda":  # f32 convs and label sums in full f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    output = Path(cfg.output)
    out_dir = output / "test" / "test_output"
    bundle = build_model(cfg, device)
    init_torch_default(bundle.model, cfg.seed)
    vgg, vgg_source = build_vgg(cfg, device)
    bundle.vgg = vgg  # the feature models stylize from its features
    if not (cfg.vgg and vgg_source == str(cfg.vgg)):
        logger.warning(f"VGG weights {cfg.vgg!r} not found: using "
                       f"{vgg_source}")

    state = create_train_state(bundle)
    ckpt = cfg.checkpoint_path or None
    if not ckpt:
        step = latest_step(output / "checkpoints")
        ckpt = output / "checkpoints" / str(step) if step else None
    if ckpt and Path(ckpt).exists():
        restore_checkpoint(ckpt, state)
        logger.info(f"Loaded checkpoint from {ckpt} (step {state.step})")
    else:
        logger.warning("No checkpoint found: stylizing with seeded weights")

    counters = (("B1", fused_folded_conv), ("B4", fused_folded_conv_q8),
                ("B5", fused_conv2d_q8))
    before = {label: fn.launches for label, fn in counters}
    b6_0 = launch_counts()["B6_fwd"]
    counts = dump_test_set(bundle, build_test_dataset(cfg), cfg.batch_size,
                           out_dir, claim_maps_dir=output,
                           iterations=state.step)
    logger.info(f"Stylized {counts['images']} pairs into {out_dir} "
                f"({counts['masked_batches']} batch(es) with masks, "
                f"{counts['valid_labels']} valid label(s)) on {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else ""))
    for label, fn in counters:
        logger.info(f"{label} {fn.__name__} launches: "
                    f"{fn.launches - before[label]}")
    logger.info(f"B6 flash_attention launches: "
                f"{launch_counts()['B6_fwd'] - b6_0}")


if __name__ == "__main__":
    main()
