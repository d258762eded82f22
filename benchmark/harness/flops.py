"""FLOPs of a configuration's work, counted once on its plain reference
(``torch.utils.flop_counter.FlopCounterMode``: convolutions and matrix
products, 2 per multiply-add) on meta tensors at the cell's shapes, so the
count is the same whatever implements it. The configuration's file stores
the counts (``flops``); the tests count them again.

    python3 benchmark/harness/flops.py <config>   # prints the counts
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from harness.manifest import Manifest
else:
    from .manifest import Manifest


def _meta(shapes):
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def count(manifest: Manifest, config: str, model_shapes: dict,
          vgg_shapes: dict, batch: int) -> dict:
    """{"stylize_per_image", "train_step_per_image"} at the configuration's
    img_size and ``batch``: the stylize, and the loss's forward and
    backward (the no-grad targets included)."""
    cfg = manifest.config(config)["settings"]
    ref = manifest.reference(config).build(cfg, _meta(model_shapes),
                                           _meta(vgg_shapes))
    size = int(cfg["img_size"])
    img = torch.empty((batch, size, size, 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            ref.stylize(img, img)
    stylize = fc.get_total_flops()
    params = {k: v.requires_grad_(True)
              for k, v in _meta(model_shapes).items()}
    with FlopCounterMode(display=False) as fc:
        ref.loss(params, img, img)["total_loss"].backward()
    return {"stylize_per_image": stylize // batch,
            "train_step_per_image": fc.get_total_flops() // batch}


def shapes_of(config: dict):
    """(model, VGG) parameter shapes by the port's key names."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, vgg_stages
    from rpst_torch.nn.vgg import VGG19Encoder
    s = dict(config["settings"], img_size=32)
    model = build_model(load_config(s)).model
    vgg = VGG19Encoder(num_stages=vgg_stages(s["network"]))
    return ({k: tuple(p.shape) for k, p in model.named_parameters()},
            {k: tuple(p.shape) for k, p in vgg.named_parameters()})


if __name__ == "__main__":
    m = Manifest()
    name = sys.argv[1]
    conf = m.config(name)
    model_shapes, vgg_shapes = shapes_of(conf)
    print(json.dumps(count(m, name, model_shapes, vgg_shapes,
                           int(conf["settings"]["batch_size"]))))
