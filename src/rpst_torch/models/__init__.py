"""Model registry of the port; counterpart of ``rpst.models``.

The port covers four networks: the flagship ``multi_adain`` (constant RP
stack) for serving (folded, standard and int8 q8) and training (with
float or int8 loss targets); ``adain`` for serving (standard and q8) and
standard training; ``wct`` for serving (standard and q8); the static
``sanet`` for serving (standard and q8) and training, its attention on B6.
``build_model`` raises ``ValueError`` for the other 13, naming the
ROADMAP.md slice that brings each.

A :class:`ModelBundle` holds the ``nn.Module`` with its weights on one
device and exposes what the serving CLI calls:
  * ``stylize(content, style)`` -> image, NHWC in [0, 1] on the bundle's
    device (the reference's ``network.test`` path); sanet stylizes from
    the features of ``bundle.vgg``, the frozen 5-stage encoder the caller
    sets (``build_vgg``),
  * ``folded_exec()`` / ``folded_infer()``: whether the config asks for, and
    the model supports, folded execution,
  * ``q8_infer()`` / ``q8_recommended(batch)``: whether the int8 PTQ path
    covers the config, and whether ``--mode auto`` should take it;
    ``calibrate_q8`` and ``stylize_q8`` run it on the cached int8 weights
    (the flagship folded on B4/B7; adain, wct and sanet standard-layout on
    B5),
  * ``load_state_dict(sd)``: weights in the port's names (see ``bridge``),
  * ``loss(vgg, content, style)`` -> (total, parts): the training loss
    (rpst's ``ModelBundle.loss``), differentiable in the model's
    parameters; ``build_vgg`` makes its frozen encoder. With
    ``train_q8_targets`` and ``q8_target_scales`` set (``train_torch.py``
    calibrates them on the first batch) the flagship's style and content
    targets come from the int8 VGG chain on B5. sanet's loss is
    ``SAModel.loss`` (content, style and two identity terms).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..config import Config
from ..nn.vgg import VGG19Encoder
from ..nn.vgg_folded import (ConvAct, perceptual_rp_losses_folded,
                             perceptual_rp_losses_q8targets)
from ..ops.folded_conv import folded_conv_act
from .adain_rp import AdaINRP, MultiScaleAdaINRP
from .base import perceptual_rp_losses
from .fast_path import (folded_blocks, live_folded_blocks,
                        stylize_multi_adain_folded)
from .fast_path_q8 import (calibrate_multi_adain_q8, quantize_blocks,
                           stylize_multi_adain_folded_q8)
from .fast_path_q8_std import (calibrate_adain_q8, calibrate_sanet_q8,
                               calibrate_wct_q8, quantize_convs, quantize_std,
                               sanet_blocks, std_blocks, stylize_adain_q8,
                               stylize_sanet_q8, stylize_wct_q8)
from .sanet import SAModel
from .wct_rp import WCTRP

__all__ = ["build_model", "build_vgg", "vgg_stages", "ModelBundle",
           "MultiScaleAdaINRP", "AdaINRP", "WCTRP", "SAModel"]

# every other rpst registry network -> the ROADMAP.md section A slice that
# ports it
_NOT_PORTED = {
    **dict.fromkeys(("sel_multi_adain", "ccam", "mst"), "slice 4"),
    **dict.fromkeys(("seg_adain", "mrf", "spade", "ld_adain", "ld_adain2",
                     "ld_adain3", "ld_adain4", "ld_adain5"), "slice 5b"),
    **dict.fromkeys(("dynamic_sanet", "src"), "slice 6b"),
}


def vgg_stages(network: str) -> int:
    """The taps the network's frozen VGG gives: relu1_1 .. relu5_1 for the
    SANet models, .. relu4_1 for the others."""
    return 5 if network in ("sanet", "dynamic_sanet") else 4


@dataclasses.dataclass
class ModelBundle:
    network: str
    model: Union[MultiScaleAdaINRP, AdaINRP, WCTRP, SAModel]
    cfg: Config
    device: torch.device
    # the frozen encoder whose features sanet stylizes from (``build_vgg``,
    # ``vgg_stages`` taps); the caller sets it before stylize / calibrate
    vgg: Optional[VGG19Encoder] = None
    # activation scales of the int8 no-grad VGG loss targets
    # (``train_q8_targets``), set by the training driver after
    # ``fast_path_q8_std.calibrate_vgg_targets_q8`` on its first batch
    q8_target_scales: Optional[Dict[str, Any]] = None
    # dtype -> serving weights (folded for the flagship, ``std_blocks`` for
    # adain and wct), and the int8 weight set ("q8"); cleared by
    # weights_changed
    _folded: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, init=False, repr=False)

    @property
    def vgg_stages(self) -> int:
        return vgg_stages(self.network)

    def _std_q8(self) -> bool:
        """adain and wct: the int8 path runs on the standard layout (B5)."""
        return self.network in ("adain", "wct")

    def _feature_vgg(self) -> VGG19Encoder:
        if self.vgg is None or self.vgg.num_stages != self.vgg_stages:
            raise ValueError(
                f"{self.network} stylizes from VGG features: set bundle.vgg "
                f"to the {self.vgg_stages}-stage encoder of build_vgg first")
        return self.vgg

    def _folded_stack_ok(self) -> bool:
        c = self.cfg
        return (self.network == "multi_adain"
                and c.enc_stack_way != "deeper"
                and c.inception_num == 0 and c.attention == "none"
                and not c.shuffle and not c.sort and not c.use_mask)

    def folded_exec(self) -> bool:
        """True when cfg asks for folded execution and the model supports
        it: multi_adain constant stacks without inception, attention,
        shuffle, sort or masks."""
        return (self.cfg.get("exec_strategy", "standard") == "folded"
                and self._folded_stack_ok())

    def folded_infer(self) -> bool:
        """rpst also folds sel_multi_adain, ccam and mst; none of them is
        ported yet, so here it equals ``folded_exec``."""
        return self.folded_exec()

    def q8_infer(self) -> bool:
        """The int8 path covers adain (without masks), wct and sanet on the
        standard layout, and the folded stacks whose hidden layers fill 128
        folded lanes (4 * hidden_dim % 128 == 0): narrower folded stacks
        have no int8 layer (rpst's gates, ``models/__init__.py:96-105,
        147-152``)."""
        if self.network == "adain":
            return not self.cfg.use_mask
        if self.network == "wct":
            return True
        if self.network == "sanet":
            # the int8 VGG encode pools by exact 2x2 halving where the float
            # path pools in ceil mode: four pools to relu5_1
            return self.cfg.img_size % 16 == 0
        return (self._folded_stack_ok()
                and (self.cfg.hidden_dim * 4) % 128 == 0)

    def q8_recommended(self, batch: Optional[int] = None) -> bool:
        """Should ``--mode auto`` serve q8 at ``batch``: only where the H100
        measured it fastest (``rpst_torch.policy``)."""
        from ..policy import q8_preferred
        return self.q8_infer() and q8_preferred(self.network, batch)

    def q8_weights(self):
        """The eligible layers' int8 weights and scales (``quantize_blocks``
        of the float32 folded weights, ``quantize_std`` of the float32
        standard-layout stacks), quantized once and cached until
        ``weights_changed``."""
        if "q8" not in self._folded:
            if self.network == "sanet":  # the decoder's eligible convs
                q8 = quantize_convs(
                    self.std_weights(torch.float32)["decoder"])
            elif self._std_q8():
                q8 = quantize_std(self.std_weights(torch.float32))
            else:
                q8 = quantize_blocks(self.folded_weights(torch.float32))
            self._folded["q8"] = q8
        return self._folded["q8"]

    def std_weights(self, dtype: torch.dtype):
        """adain / wct: the (encoder, decoder) conv lists in ``dtype``
        (``fast_path_q8_std.std_blocks``); sanet: its ``sanet_blocks``.
        Cached until the next ``load_state_dict``."""
        key = ("std", dtype)
        if key not in self._folded:
            make = sanet_blocks if self.network == "sanet" else std_blocks
            self._folded[key] = make(self.model, dtype)
        return self._folded[key]

    def _wct_args(self) -> Dict[str, Any]:
        return {"method": self.model.method, "wct_dtype": self.model.wct_dtype}

    def calibrate_q8(self, content: torch.Tensor,
                     style: torch.Tensor) -> Dict[str, Any]:
        """PTQ calibration: {'act_scales': (L,) float32} from one bfloat16
        forward of (content, style): folded for the flagship (rpst's
        ``calibrate_multi_adain_q8``), standard-layout on at most 2 images
        for adain and wct (``calibrate_adain_q8``, ``calibrate_wct_q8``),
        the whole batch for sanet (``calibrate_sanet_q8``)."""
        self._check_q8()
        if self.network == "sanet":
            return calibrate_sanet_q8(
                self._feature_vgg(), self.std_weights(torch.bfloat16),
                self.q8_weights(), content, style)
        if self.network == "adain":
            return calibrate_adain_q8(self.std_weights(torch.bfloat16),
                                      content, style)
        if self.network == "wct":
            return calibrate_wct_q8(self.std_weights(torch.bfloat16), content,
                                    style, **self._wct_args())
        return calibrate_multi_adain_q8(self.folded_weights(torch.bfloat16),
                                        content, style)

    def stylize_q8(self, content: torch.Tensor, style: torch.Tensor,
                   scales, dtype: torch.dtype = torch.bfloat16,
                   fuse_pairs="auto") -> torch.Tensor:
        """Int8 inference with calibrated ``scales``: (N, H, W, 3) content
        and style on the bundle's device -> (N, H, W, 3) float32, in
        bfloat16 around the int8 layers as rpst serves it. ``fuse_pairs``
        applies to the flagship's folded encoder only. Runs under
        ``torch.inference_mode``."""
        self._check_q8()
        with torch.inference_mode():
            if self.network == "sanet":
                return stylize_sanet_q8(
                    self._feature_vgg(), self.std_weights(dtype),
                    self.q8_weights(), scales, content, style, dtype=dtype,
                    attention=self.model.attention)
            if self._std_q8():
                args = (self.std_weights(dtype), self.q8_weights(), scales,
                        content, style)
                if self.network == "adain":
                    return stylize_adain_q8(*args, dtype=dtype)
                return stylize_wct_q8(*args, dtype=dtype, **self._wct_args())
            return stylize_multi_adain_folded_q8(
                self.folded_weights(dtype), self.q8_weights(), scales,
                content, style, dtype=dtype, fuse_pairs=fuse_pairs)

    def _check_q8(self) -> None:
        if not self.q8_infer():
            raise ValueError("the int8 path needs adain without masks, wct, "
                             "sanet with img_size a multiple of 16, or a "
                             "folded multi_adain stack with 4 * hidden_dim a "
                             "multiple of 128")

    def folded_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                else torch.float32)

    def load_state_dict(self, state_dict) -> None:
        self.model.load_state_dict(state_dict)
        self.weights_changed()

    def weights_changed(self) -> None:
        """Drop the folded and int8 serving weights (after a load or an
        update)."""
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
        total = (c.content_weight * parts["content_loss"]
                 + c.style_weight * parts["style_loss"])
        if "l_identity1_loss" in parts:
            total = total + (c.l_identity1_weight * parts["l_identity1_loss"]
                             + c.l_identity2_weight
                             * parts["l_identity2_loss"])
        return total

    def loss(self, vgg: VGG19Encoder, content: torch.Tensor,
             style: torch.Tensor, targets=None,
             conv_act: ConvAct = folded_conv_act
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss (rpst's ``ModelBundle.loss`` for the flagship):
        (total, parts) with parts ``style_loss``, ``content_loss`` and
        ``total_loss`` (sanet: also ``l_identity1_loss`` and
        ``l_identity2_loss``, from ``SAModel.loss`` on the 5-stage ``vgg``),
        differentiable in ``self.model``'s parameters.

        Folded (``folded_exec()``): ``stylize_multi_adain_folded`` on the
        live folded weights, then the folded VGG loss, every folded conv
        through ``conv_act`` (B1's autograd Function; a benchmark passes B1's
        plain version to time the plain path); where ``q8_targets_active``
        the style and content targets come from the int8 VGG chain on B5
        instead of the folded float pass. Standard: the module's
        forward, then ``perceptual_rp_losses``, under bfloat16 autocast when
        compute_dtype says so."""
        if targets is not None:
            raise NotImplementedError(
                "precomputed loss targets (the target cache) are not ported "
                "yet: ROADMAP.md section A item 7")
        c = self.cfg
        if self.network == "wct":
            raise NotImplementedError(
                "wct training (the frozen-encoder resume, freeze_prefixes) "
                "is not ported yet: ROADMAP.md section A slice 5b")
        if self.network == "sanet":
            with torch.autocast(self.device.type, dtype=torch.bfloat16,
                                enabled=c.compute_dtype == "bfloat16"):
                parts = self.model.loss(vgg, content, style)
        elif self.folded_exec():
            dtype = self.folded_dtype()
            stylized = stylize_multi_adain_folded(
                live_folded_blocks(self.model, dtype), content, style,
                dtype=dtype, conv=lambda x, k, b: conv_act(x, k, b, 0.2))
            if self.q8_targets_active(content.shape[0]):
                parts, _ = perceptual_rp_losses_q8targets(
                    vgg, self.q8_target_scales, stylized, style, content,
                    c.content_weight, c.style_weight, dtype=dtype,
                    conv_act=conv_act)
            else:
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

    def q8_targets_active(self, batch: int) -> bool:
        """Does the folded loss take int8 targets at ``batch``: the knob is
        on, the scales are calibrated, three exact 2x2 pools fit the image
        (img_size % 8 == 0), and the batch reaches the H100's measured
        crossover (``policy.TRAIN_Q8_TARGETS_MIN_BATCH``). Otherwise the
        loss takes the folded float targets, as rpst does."""
        from ..policy import TRAIN_Q8_TARGETS_MIN_BATCH
        return (bool(self.cfg.get("train_q8_targets", False))
                and self.q8_target_scales is not None
                and self.cfg.img_size % 8 == 0
                and batch >= TRAIN_Q8_TARGETS_MIN_BATCH)

    def stylize(self, content: torch.Tensor, style: torch.Tensor,
                batch_encode: bool = False,
                folded: Optional[bool] = None) -> torch.Tensor:
        """Inference: (N, H, W, 3) content and style on the bundle's device
        -> (N, H, W, 3) float32. ``folded`` (default ``folded_infer()``)
        picks the folded path; otherwise the standard model runs, under
        bfloat16 autocast when compute_dtype says so (sanet: on the features
        of one 2N pass of ``bundle.vgg``, its attention on B6). Runs under
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
                if self.network == "sanet":
                    n = content.shape[0]
                    feats = self._feature_vgg()(torch.cat([content, style]))
                    return self.model([f[:n] for f in feats],
                                      [f[n:] for f in feats]).float()
                return self.model(content, style).float()


def build_model(cfg: Config, device="cpu") -> ModelBundle:
    """The bundle for ``cfg.network`` with PyTorch-default-initialized
    weights on ``device`` (seed them with ``nn.blocks.init_torch_default``
    or load them with ``bundle.load_state_dict``)."""
    n = cfg.network
    if n in _NOT_PORTED:
        raise ValueError(f"network {n!r} is not ported to rpst_torch yet: "
                         f"ROADMAP.md section A {_NOT_PORTED[n]}")
    device = torch.device(device)
    if n == "adain":
        model = AdaINRP(rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim,
                        use_mask=bool(cfg.use_mask), device=device)
    elif n == "wct":
        model = WCTRP(rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim,
                      method=cfg.wct_method, wct_dtype=cfg.wct_dtype,
                      device=device)
    elif n == "sanet":
        model = SAModel(adaptive=False, img_size=cfg.img_size, device=device)
    elif n == "multi_adain":
        model = MultiScaleAdaINRP(
            rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim,
            enc_stack_way=cfg.enc_stack_way, inception_num=cfg.inception_num,
            attention=cfg.attention, shuffle=bool(cfg.shuffle),
            sort=bool(cfg.sort), use_mask=bool(cfg.use_mask), device=device)
    else:
        raise ValueError(f"unknown network {n!r}")
    model.eval()  # serving; training calls .train() (no BatchNorm: the same)
    return ModelBundle(network=n, model=model, cfg=cfg, device=device)


def build_vgg(cfg: Config, device="cpu") -> Tuple[VGG19Encoder, str]:
    """The frozen VGG of the perceptual loss (and of sanet's features), with
    ``vgg_stages(cfg.network)`` taps, and where its weights came from:
    ``cfg.vgg`` (``.pth`` or ``.npz``) when that file exists, else
    ``bridge.vgg_weights_from_seed(cfg.seed + 1)`` (random: the losses then
    hold no perceptual meaning, fine for smoke and timing runs)."""
    from ..bridge import load_vgg_weights, vgg_from_flax, vgg_weights_from_seed
    stages = vgg_stages(cfg.network)
    vgg = VGG19Encoder(num_stages=stages)
    if cfg.vgg and Path(cfg.vgg).exists():
        vgg.load_state_dict(load_vgg_weights(cfg.vgg, stages))
        source = str(cfg.vgg)
    else:
        vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
            cfg.seed + 1, stages)))
        source = f"random (vgg_weights_from_seed({cfg.seed + 1}))"
    return vgg.to(device), source
