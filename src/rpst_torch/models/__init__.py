"""Model registry of the port; counterpart of ``rpst.models``.

The port covers one network, the flagship ``multi_adain`` (constant RP
stack), for serving and training. ``build_model`` raises ``ValueError`` for
the other 16, naming the ROADMAP.md slice that brings each.

A :class:`ModelBundle` holds the ``nn.Module`` with its weights on one
device and exposes what the serving CLI calls:
  * ``stylize(content, style)`` -> image, NHWC in [0, 1] on the bundle's
    device (the reference's ``network.test`` path),
  * ``folded_exec()`` / ``folded_infer()``: whether the config asks for, and
    the model supports, folded execution,
  * ``load_state_dict(sd)``: weights in the port's names (see ``bridge``),
  * ``loss(vgg, content, style)`` -> (total, parts): the training loss
    (rpst's ``ModelBundle.loss``), differentiable in the model's
    parameters; ``build_vgg`` makes its frozen encoder.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import Config
from ..nn.vgg import VGG19Encoder
from ..nn.vgg_folded import ConvAct, perceptual_rp_losses_folded
from ..ops.folded_conv import folded_conv_act
from .adain_rp import MultiScaleAdaINRP
from .base import perceptual_rp_losses
from .fast_path import (folded_blocks, live_folded_blocks,
                        stylize_multi_adain_folded)

__all__ = ["build_model", "build_vgg", "ModelBundle", "MultiScaleAdaINRP"]

# every other rpst registry network -> the ROADMAP.md section A slice that
# ports it
_NOT_PORTED = {
    **dict.fromkeys(("sel_multi_adain", "ccam", "mst"), "slice 4"),
    **dict.fromkeys(("adain", "seg_adain", "wct", "mrf", "spade", "ld_adain",
                     "ld_adain2", "ld_adain3", "ld_adain4", "ld_adain5"),
                    "slice 5"),
    **dict.fromkeys(("sanet", "dynamic_sanet", "src"), "slice 6"),
}


@dataclasses.dataclass
class ModelBundle:
    network: str
    model: MultiScaleAdaINRP
    cfg: Config
    device: torch.device
    # dtype -> folded (encoder, decoder) weights; cleared by load_state_dict
    _folded: Dict[torch.dtype, Any] = dataclasses.field(
        default_factory=dict, init=False, repr=False)

    def folded_exec(self) -> bool:
        """True when cfg asks for folded execution and the model supports
        it: multi_adain constant stacks without inception, attention,
        shuffle, sort or masks."""
        c = self.cfg
        return (c.get("exec_strategy", "standard") == "folded"
                and self.network == "multi_adain"
                and c.enc_stack_way != "deeper"
                and c.inception_num == 0 and c.attention == "none"
                and not c.shuffle and not c.sort and not c.use_mask)

    def folded_infer(self) -> bool:
        """rpst also folds sel_multi_adain, ccam and mst; none of them is
        ported yet, so here it equals ``folded_exec``."""
        return self.folded_exec()

    def folded_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                else torch.float32)

    def load_state_dict(self, state_dict) -> None:
        self.model.load_state_dict(state_dict)
        self.weights_changed()

    def weights_changed(self) -> None:
        """Drop the folded serving weights (after a load or an update)."""
        self._folded.clear()

    def folded_weights(self, dtype: Optional[torch.dtype] = None):
        """The model's weights folded for ``stylize_multi_adain_folded``,
        cached per dtype until the next ``load_state_dict``."""
        dtype = dtype or self.folded_dtype()
        if dtype not in self._folded:
            self._folded[dtype] = folded_blocks(self.model, dtype)
        return self._folded[dtype]

    def _mix(self, parts: Dict[str, torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        return (c.content_weight * parts["content_loss"]
                + c.style_weight * parts["style_loss"])

    def loss(self, vgg: VGG19Encoder, content: torch.Tensor,
             style: torch.Tensor, targets=None,
             conv_act: ConvAct = folded_conv_act
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss (rpst's ``ModelBundle.loss`` for the flagship):
        (total, parts) with parts ``style_loss``, ``content_loss`` and
        ``total_loss``, differentiable in ``self.model``'s parameters.

        Folded (``folded_exec()``): ``stylize_multi_adain_folded`` on the
        live folded weights, then the folded VGG loss, every folded conv
        through ``conv_act`` (B1's autograd Function; a benchmark passes B1's
        plain version to time the plain path). Standard: the module's
        forward, then ``perceptual_rp_losses``, under bfloat16 autocast when
        compute_dtype says so."""
        if targets is not None:
            raise NotImplementedError(
                "precomputed loss targets (the target cache) are not ported "
                "yet: ROADMAP.md section A item 7")
        if self.cfg.get("train_q8_targets", False):
            raise NotImplementedError(
                "train_q8_targets (int8 no-grad VGG targets on B4/B5) is not "
                "ported yet: ROADMAP.md section A slice 3")
        c = self.cfg
        if self.folded_exec():
            dtype = self.folded_dtype()
            stylized = stylize_multi_adain_folded(
                live_folded_blocks(self.model, dtype), content, style,
                dtype=dtype, conv=lambda x, k, b: conv_act(x, k, b, 0.2))
            parts, _ = perceptual_rp_losses_folded(
                vgg, stylized, style, content, c.content_weight,
                c.style_weight, dtype=dtype, conv_act=conv_act)
        else:
            with torch.autocast(self.device.type, dtype=torch.bfloat16,
                                enabled=c.compute_dtype == "bfloat16"):
                stylized = self.model(content, style)
                parts, _ = perceptual_rp_losses(
                    vgg, stylized, style, content, c.content_weight,
                    c.style_weight)
            parts = {k: v for k, v in parts.items() if k != "total_loss"}
        total = self._mix(parts)
        return total, {**parts, "total_loss": total}

    def stylize(self, content: torch.Tensor, style: torch.Tensor,
                batch_encode: bool = False,
                folded: Optional[bool] = None) -> torch.Tensor:
        """Inference: (N, H, W, 3) content and style on the bundle's device
        -> (N, H, W, 3) float32. ``folded`` (default ``folded_infer()``)
        picks the folded path; otherwise the standard model runs, under
        bfloat16 autocast when compute_dtype says so. Runs under
        ``torch.inference_mode``."""
        if folded is None:
            folded = self.folded_infer()
        elif folded and not self.folded_infer():
            raise ValueError("folded execution needs exec_strategy: folded "
                             "and a network/config the folded path covers")
        with torch.inference_mode():
            if folded:
                return stylize_multi_adain_folded(
                    self.folded_weights(), content, style,
                    dtype=self.folded_dtype(), batch_encode=batch_encode)
            with torch.autocast(self.device.type, dtype=torch.bfloat16,
                                enabled=self.cfg.compute_dtype == "bfloat16"):
                return self.model(content, style).float()


def build_model(cfg: Config, device="cpu") -> ModelBundle:
    """The bundle for ``cfg.network`` with PyTorch-default-initialized
    weights on ``device`` (seed them with ``nn.blocks.init_torch_default``
    or load them with ``bundle.load_state_dict``)."""
    n = cfg.network
    if n in _NOT_PORTED:
        raise ValueError(f"network {n!r} is not ported to rpst_torch yet: "
                         f"ROADMAP.md section A {_NOT_PORTED[n]}")
    if n != "multi_adain":
        raise ValueError(f"unknown network {n!r}")
    device = torch.device(device)
    model = MultiScaleAdaINRP(
        rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim,
        enc_stack_way=cfg.enc_stack_way, inception_num=cfg.inception_num,
        attention=cfg.attention, shuffle=bool(cfg.shuffle),
        sort=bool(cfg.sort), use_mask=bool(cfg.use_mask), device=device)
    model.eval()  # serving; training calls .train() (no BatchNorm: the same)
    return ModelBundle(network=n, model=model, cfg=cfg, device=device)


def build_vgg(cfg: Config, device="cpu") -> Tuple[VGG19Encoder, str]:
    """The frozen 4-stage VGG of the perceptual loss and where its weights
    came from: ``cfg.vgg`` (``.pth`` or ``.npz``) when that file exists,
    else ``bridge.vgg_weights_from_seed(cfg.seed + 1)`` (random: the losses
    then hold no perceptual meaning, fine for smoke and timing runs)."""
    from ..bridge import load_vgg_weights, vgg_from_flax, vgg_weights_from_seed
    vgg = VGG19Encoder(num_stages=4)
    if cfg.vgg and Path(cfg.vgg).exists():
        vgg.load_state_dict(load_vgg_weights(cfg.vgg))
        source = str(cfg.vgg)
    else:
        vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(cfg.seed + 1)))
        source = f"random (vgg_weights_from_seed({cfg.seed + 1}))"
    return vgg.to(device), source
