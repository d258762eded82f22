"""The program under test, ``rpst_torch``, built for a configuration from
seeded weights, and the launch counters it keeps.

The benchmark takes from the program only the system under test (the
bundle, ``make_run_impl``, ``DynamicBatcher``, ``train_step``), its batcher
statistics and its kernels' launch counters. It keeps its own copy of the
weights it made, which the reference reads.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from . import inputs
from .manifest import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def settings(config: dict, traffic: dict, overrides: Optional[dict] = None
             ) -> dict:
    """The port's config keys: the configuration's, the mix's batch, and
    (tests only) ``overrides``."""
    out = dict(config["settings"])
    out["batch_size"] = int(traffic["batch_size"])
    out.update(overrides or {})
    return out


@dataclass
class Program:
    bundle: object
    vgg: object                           # the port's VGG19Encoder or None
    weights: Dict[str, torch.Tensor]      # the benchmark's copies
    vgg_weights: Optional[Dict[str, torch.Tensor]]


def build(config: dict, cfg: dict, seed: int, device,
          with_vgg: bool) -> Program:
    """The bundle on ``device`` with the configuration's seeded weights; the
    frozen VGG too when the mix trains or the network stylizes from VGG
    features (``bundle.vgg``)."""
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, vgg_stages
    from rpst_torch.nn.vgg import VGG19Encoder

    bundle = build_model(load_config(cfg), device)
    rules = config["weights"]
    weights = inputs.seeded_weights(
        [(k, p.shape) for k, p in bundle.model.named_parameters()],
        rules["model"], seed, inputs.MODEL, device)
    state = bundle.model.state_dict()
    state.update(weights)
    bundle.load_state_dict(state)
    vgg = vgg_weights = None
    if with_vgg or bundle.from_features:
        vgg = VGG19Encoder(num_stages=vgg_stages(cfg["network"])).to(device)
        vgg_weights = inputs.seeded_weights(
            [(k, p.shape) for k, p in vgg.named_parameters()], rules["vgg"],
            seed, inputs.VGG, device)
        vgg.load_state_dict(vgg_weights)
        if bundle.from_features:
            bundle.vgg = vgg
    return Program(bundle, vgg, weights, vgg_weights)


def launch_counters() -> Dict[str, int]:
    """The port's kernel launch counters: B1-B3 (``ops.folded_conv``) and
    B6a-d (``ops.flash_attention``)."""
    from rpst_torch.ops import flash_attention as fa
    from rpst_torch.ops import folded_conv as fc
    return {"B1": fc.fused_folded_conv.launches,
            "B2": fc.fused_folded_conv_grad_input.launches,
            "B3": fc.fused_folded_conv_grad_weight.launches,
            "B6a": fa.flash_fwd.launches,
            "B6b": fa.flash_fwd_lse.launches,
            "B6c": fa.flash_bwd_dq.launches,
            "B6d": fa.flash_bwd_dkv.launches}


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}
