"""Model registry of the port; counterpart of ``rpst.models``.

The port covers all 17 registry networks: the flagship ``multi_adain``
(constant RP stack) for serving (folded, standard and int8 q8) and
training (with float, int8 or cached loss targets); its three variants on
the same stack,
``sel_multi_adain`` (an SE bottleneck on the last fusion), ``ccam`` (a
cross-channel attention residual) and ``mst`` (k-means channel matching),
each for serving (folded, standard and q8 on B4) and training (folded and
standard); the wide standard-layout families, each for serving (standard
and q8 on B5) and standard training: ``adain``, ``wct`` (its encoder frozen
on a resume), ``mrf`` (two encoders, a concat, the MRF loss),
``spade`` (a SPADE generator; q8 with the instance norm only) and
``seg_adain`` (adain's stylize, a segmentation head trained on labelled
batches); the static ``sanet`` for serving (standard and q8) and training,
its attention on B6; the adaptive ``dynamic_sanet`` (its attention plain
PyTorch, dense or streamed) and ``src`` (SourceNet, AdaIN at relu4_1), each
for serving (standard and q8 on B5) and training; the LD family
(``ld_adain`` .. ``ld_adain5``, dual-branch RP stacks) for standard serving
and training, with q8 serving for v1 (its 7x7 big branch on B5's 7x7 form)
and v2, both on B5.

A :class:`ModelBundle` holds the ``nn.Module`` with its weights on one
device and exposes what the serving CLI calls:
  * ``stylize(content, style, c_labels=None, s_labels=None)`` -> image,
    NHWC in [0, 1] on the bundle's device (the reference's
    ``network.test`` path); with ``use_mask`` and segmentation label maps
    (N, H, W) the test-mode networks (the multiscale family, the LD family,
    src) fuse by the segment-masked AdaIN, on the standard path (the
    folded and int8 paths take no labels, as rpst's); the feature models
    (sanet, dynamic_sanet, src) stylize from the features of ``bundle.vgg``,
    the frozen encoder the caller sets (``build_vgg``);
    ``stylize_with_aux`` also returns dynamic_sanet's claim maps,
  * ``folded_exec()`` / ``folded_infer()``: whether the config asks for, and
    the model supports, folded execution,
  * ``q8_infer()`` / ``q8_recommended(batch)``: whether the int8 PTQ path
    covers the config, and whether ``--mode auto`` should take it;
    ``calibrate_q8`` and ``stylize_q8`` run it on the cached int8 weights
    (the flagship and its three variants folded on B4, the flagship's
    encoder pairs on B7 with ``fuse_pairs``; adain, wct, mrf, spade,
    seg_adain, the feature models and LD v1 / v2 standard-layout on B5),
  * ``load_state_dict(sd)``: weights in the port's names (see ``bridge``),
  * ``loss(vgg, content, style)`` -> (total, parts): the training loss
    (rpst's ``ModelBundle.loss``), differentiable in the model's
    parameters; ``build_vgg`` makes its frozen encoder. With
    ``train_q8_targets`` and ``q8_target_scales`` set (``train_torch.py``
    calibrates them on the first batch) the flagship's style and content
    targets come from the int8 VGG chain on B5; with ``targets`` (the target
    cache, ``train.target_cache``) the folded families' targets are given.
    The feature models' loss is
    the model's own: ``SAModel.loss`` (content, style and two identity
    terms) for sanet and dynamic_sanet, ``SourceNet.loss`` (style, and
    content against the AdaIN target) for src, ``MRFRP.loss`` (the MRF
    term and the two cycle losses) for mrf, ``SegAdaINRP.loss`` (the
    perceptual losses, and the segmentation loss on a labelled batch) for
    seg_adain.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..config import Config
from ..nn.vgg import VGG19Encoder
from ..nn.vgg_folded import (ConvAct, perceptual_rp_losses_folded,
                             perceptual_rp_losses_folded_pretargets,
                             perceptual_rp_losses_q8targets)
from ..ops.folded_conv import folded_conv_act
from .adain_rp import CCAMRP, MSTRP, AdaINRP, MultiScaleAdaINRP, SELastRP
from .base import perceptual_rp_losses
from .fast_path import (folded_blocks, live_folded_blocks, se_weights,
                        stylize_ccam_folded, stylize_mst_folded,
                        stylize_multi_adain_folded,
                        stylize_sel_multi_adain_folded)
from .fast_path_q8 import (calibrate_ccam_q8, calibrate_mst_q8,
                           calibrate_multi_adain_q8,
                           calibrate_sel_multi_adain_q8, quantize_blocks,
                           stylize_ccam_folded_q8, stylize_mst_folded_q8,
                           stylize_multi_adain_folded_q8,
                           stylize_sel_multi_adain_folded_q8)
from .fast_path_q8_ld import (calibrate_ld_q8, ld_blocks, quantize_ld,
                              stylize_ld_q8)
from .fast_path_q8_std import (calibrate_adain_q8, calibrate_mrf_q8,
                               calibrate_sanet_q8, calibrate_spade_q8,
                               calibrate_src_q8, calibrate_wct_q8, mrf_blocks,
                               quantize_convs, quantize_std, sanet_blocks,
                               spade_blocks, src_blocks, std_blocks,
                               stylize_adain_q8, stylize_mrf_q8,
                               stylize_sanet_q8, stylize_spade_q8,
                               stylize_src_q8, stylize_wct_q8)
from .ld_adain import LDAdaINRP
from .mrf_rp import MRFRP
from .sanet import SAModel
from .seg_adain import SegAdaINRP
from .spade_rp import SpadeRP
from .src_adain import SourceNet
from .wct_rp import WCTRP

__all__ = ["build_model", "build_vgg", "vgg_stages", "roadmap_slice",
           "ModelBundle", "MultiScaleAdaINRP", "AdaINRP", "WCTRP", "SAModel",
           "SourceNet", "SELastRP", "CCAMRP", "MSTRP", "MRFRP", "SpadeRP",
           "SegAdaINRP", "LDAdaINRP"]

# every rpst registry network the port does not build -> the ROADMAP.md
# section A slice that ports it (none since the LD family came)
_NOT_PORTED: Dict[str, str] = {}
_LD = ("ld_adain", "ld_adain2", "ld_adain3", "ld_adain4", "ld_adain5")
# the LD variants with an int8 path (B5, its 7x7 form for v1)
_LD_Q8 = ("ld_adain", "ld_adain2")
# the networks that stylize from the features of a frozen VGG (bundle.vgg)
_FEAT_MODELS = ("sanet", "dynamic_sanet", "src")
# the flagship's constant stack and its three variants: folded and int8 q8
# paths on B1-B4
_FOLDED_FAMILY = ("multi_adain", "sel_multi_adain", "ccam", "mst")
# the networks whose standard stylize runs in test mode and takes labels
# (the channel shuffle, the masks; rpst's ``_TEST_MODE_MODELS``)
_TEST_MODE_MODELS = ("multi_adain", "sel_multi_adain", "ccam", "mst") + _LD
# the RPSequence families whose int8 path runs on the standard layout (B5),
# and the functions that take their float conv lists from the model
_STD_Q8 = {"adain": std_blocks, "wct": std_blocks, "mrf": mrf_blocks,
           "spade": spade_blocks,
           "seg_adain": lambda m, dt: std_blocks(m.adain_rp, dt)}


def roadmap_slice(network: str) -> Optional[str]:
    """The ROADMAP.md section A slice that ports ``network``, None for a
    ported one."""
    return _NOT_PORTED.get(network)


def vgg_stages(network: str) -> int:
    """The taps the network's frozen VGG gives: relu1_1 .. relu5_1 for the
    SANet models, .. relu4_1 for the others."""
    return 5 if network in ("sanet", "dynamic_sanet") else 4


@dataclasses.dataclass
class ModelBundle:
    network: str
    model: Union[MultiScaleAdaINRP, SELastRP, CCAMRP, MSTRP, AdaINRP, WCTRP,
                 MRFRP, SpadeRP, SegAdaINRP, SAModel, SourceNet, LDAdaINRP]
    cfg: Config
    device: torch.device
    # the frozen encoder whose features the feature models stylize from
    # (``build_vgg``, ``vgg_stages`` taps); the caller sets it before
    # stylize / calibrate
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

    @property
    def from_features(self) -> bool:
        """Does the network stylize from ``bundle.vgg``'s features (sanet,
        dynamic_sanet, src)? Then the caller sets ``bundle.vgg``."""
        return self.network in _FEAT_MODELS

    def _std_q8(self) -> bool:
        """adain, wct, mrf, spade, seg_adain: the int8 path runs on the
        standard layout (B5)."""
        return self.network in _STD_Q8

    def _feature_vgg(self) -> VGG19Encoder:
        if self.vgg is None or self.vgg.num_stages != self.vgg_stages:
            raise ValueError(
                f"{self.network} stylizes from VGG features: set bundle.vgg "
                f"to the {self.vgg_stages}-stage encoder of build_vgg first")
        return self.vgg

    def _folded_stack_ok(self) -> bool:
        c = self.cfg
        return (self.network in _FOLDED_FAMILY
                and c.enc_stack_way != "deeper"
                and c.inception_num == 0 and c.attention == "none"
                and not c.shuffle and not c.sort and not c.use_mask)

    def folded_exec(self) -> bool:
        """True when cfg asks for folded execution of the flagship:
        multi_adain constant stacks without inception, attention, shuffle,
        sort or masks."""
        return (self.network == "multi_adain"
                and self.cfg.get("exec_strategy", "standard") == "folded"
                and self._folded_stack_ok())

    def folded_infer(self) -> bool:
        """Folded execution of the flagship and of sel_multi_adain, ccam and
        mst (the SE bottleneck, the CCAM residuals and the MST transform
        fold exactly), for stylize and for the training loss (rpst's
        ``folded_infer``)."""
        return (self.cfg.get("exec_strategy", "standard") == "folded"
                and self._folded_stack_ok())

    def q8_infer(self) -> bool:
        """The int8 path covers adain (without masks), wct, mrf, seg_adain,
        spade with the instance norm (the batch norms' statistics are not
        threaded through it), sanet, dynamic_sanet and src (without masks)
        on the standard layout, LD v1 and v2 without masks or inception
        stacks whose deepest layer (hidden_dim * 2^(ld_layer_num - 1), at
        least 2 layers) fills 128 lanes (v2 also an even img_size: the int8
        path pools by exact 2x2 halving), and the folded constant stacks
        (the flagship and its three variants) whose hidden layers fill 128
        folded lanes (4 * hidden_dim % 128 == 0): narrower folded stacks
        have no int8 layer (rpst's gates, ``models/__init__.py:96-152``);
        LD v3-v5 never. A standard stack narrower than 128 channels
        everywhere has no int8 layer either and serves q8 on the float
        convs alone, as rpst's."""
        c = self.cfg
        if self.network in _LD_Q8:
            return (not c.use_mask and c.inception_num == 0
                    and c.ld_layer_num >= 2
                    and (c.hidden_dim * 2 ** (c.ld_layer_num - 1)) % 128 == 0
                    and (self.network == "ld_adain" or c.img_size % 2 == 0))
        if self.network in _LD:
            return False
        if self.network == "adain":
            return not self.cfg.use_mask
        if self.network in ("wct", "mrf", "seg_adain"):
            return True
        if self.network == "spade":
            return self.cfg.spade_norm == "instance"
        if self.network in ("sanet", "dynamic_sanet"):
            # the int8 VGG encode pools by exact 2x2 halving where the float
            # path pools in ceil mode: four pools to relu5_1
            return self.cfg.img_size % 16 == 0
        if self.network == "src":  # three exact pools to relu4_1
            return not self.cfg.use_mask and self.cfg.img_size % 8 == 0
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
            if self.from_features:  # the decoder's eligible convs
                q8 = quantize_convs(
                    self.std_weights(torch.float32)["decoder"])
            elif self.network in _LD_Q8:
                q8 = quantize_ld(self.std_weights(torch.float32))
            elif self._std_q8():
                q8 = quantize_std(self.std_weights(torch.float32))
            else:
                q8 = quantize_blocks(self.folded_weights(torch.float32))
            self._folded["q8"] = q8
        return self._folded["q8"]

    def std_weights(self, dtype: torch.dtype):
        """adain / wct / seg_adain: the (encoder, decoder) conv lists in
        ``dtype`` (``fast_path_q8_std.std_blocks``, seg_adain's of its
        ``adain_rp``); mrf its (content encoder, style encoder, decoder)
        lists, spade its two encoders' (``mrf_blocks``, ``spade_blocks``);
        sanet and dynamic_sanet their ``sanet_blocks``, src its
        ``src_blocks``, LD v1 / v2 their ``ld_blocks``. Cached until the
        next ``load_state_dict``."""
        key = ("std", dtype)
        if key not in self._folded:
            make = {"sanet": sanet_blocks, "dynamic_sanet": sanet_blocks,
                    "src": src_blocks, "ld_adain": ld_blocks,
                    "ld_adain2": ld_blocks}.get(self.network) \
                or _STD_Q8[self.network]
            self._folded[key] = make(self.model, dtype)
        return self._folded[key]

    def _wct_args(self) -> Dict[str, Any]:
        return {"method": self.model.method, "wct_dtype": self.model.wct_dtype}

    def calibrate_q8(self, content: torch.Tensor,
                     style: torch.Tensor) -> Dict[str, Any]:
        """PTQ calibration: {'act_scales': (L,) float32} from one forward of
        (content, style), in rpst's type for each network: folded bfloat16
        for the flagship and mst (rpst's ``calibrate_multi_adain_q8``,
        ``calibrate_mst_q8``), folded float32 for sel_multi_adain and ccam
        (``calibrate_sel_multi_adain_q8``, ``calibrate_ccam_q8``),
        standard-layout bfloat16 on at most 2 images for adain, wct,
        seg_adain (adain's on its nested stacks), mrf and spade
        (``calibrate_adain_q8``, ``calibrate_wct_q8``, ``calibrate_mrf_q8``,
        ``calibrate_spade_q8``, LD v1 / v2 ``calibrate_ld_q8``), the whole
        batch for the feature models (``calibrate_sanet_q8``,
        ``calibrate_src_q8``)."""
        self._check_q8()
        c = self.cfg
        if self.network in _LD_Q8:
            return calibrate_ld_q8(self.std_weights(torch.bfloat16), content,
                                   style, c.stylized_layers)
        if self.network == "sel_multi_adain":
            return calibrate_sel_multi_adain_q8(
                self.folded_weights(torch.float32),
                self.folded_extras(torch.float32), content, style)
        if self.network == "ccam":
            return calibrate_ccam_q8(
                self.folded_weights(torch.float32),
                self.folded_extras(torch.float32), content, style,
                c.stylized_layers)
        if self.network == "mst":
            return calibrate_mst_q8(self.folded_weights(torch.bfloat16),
                                    content, style, **self._mst_args())
        if self.network in ("sanet", "dynamic_sanet"):
            return calibrate_sanet_q8(
                self._feature_vgg(), self.std_weights(torch.bfloat16),
                self.q8_weights(), content, style, **self._blockwise())
        if self.network == "src":
            return calibrate_src_q8(
                self._feature_vgg(), self.std_weights(torch.bfloat16),
                self.q8_weights(), content, style)
        if self.network in ("adain", "seg_adain"):
            return calibrate_adain_q8(self.std_weights(torch.bfloat16),
                                      content, style)
        if self.network == "mrf":
            return calibrate_mrf_q8(self.std_weights(torch.bfloat16),
                                    content, style)
        if self.network == "spade":
            return calibrate_spade_q8(self.std_weights(torch.bfloat16),
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
        applies to the flagship's folded encoder only (rpst offers it to no
        other network). Runs under ``torch.inference_mode``."""
        self._check_q8()
        with torch.inference_mode():
            if self.network in _LD_Q8:
                return stylize_ld_q8(self.std_weights(dtype),
                                     self.q8_weights(), scales, content,
                                     style, self.cfg.stylized_layers,
                                     dtype=dtype)
            if self.network in ("sel_multi_adain", "ccam", "mst"):
                args = (self.folded_weights(dtype), self.q8_weights())
                if self.network == "sel_multi_adain":
                    return stylize_sel_multi_adain_folded_q8(
                        *args, self.folded_extras(dtype), scales, content,
                        style, dtype=dtype)
                if self.network == "ccam":
                    return stylize_ccam_folded_q8(
                        *args, self.folded_extras(torch.float32), scales,
                        content, style, self.cfg.stylized_layers,
                        dtype=dtype)
                return stylize_mst_folded_q8(*args, scales, content, style,
                                             dtype=dtype, **self._mst_args())
            if self.network in ("sanet", "dynamic_sanet"):
                return stylize_sanet_q8(
                    self._feature_vgg(), self.std_weights(dtype),
                    self.q8_weights(), scales, content, style, dtype=dtype,
                    attention=self.model.attention, **self._blockwise())
            if self.network == "src":
                return stylize_src_q8(
                    self._feature_vgg(), self.std_weights(dtype),
                    self.q8_weights(), scales, content, style, dtype=dtype)
            if self._std_q8():
                args = (self.std_weights(dtype), self.q8_weights(), scales,
                        content, style)
                if self.network in ("adain", "seg_adain"):
                    return stylize_adain_q8(*args, dtype=dtype)
                if self.network == "mrf":
                    return stylize_mrf_q8(*args, dtype=dtype)
                if self.network == "spade":
                    return stylize_spade_q8(*args, self.model.rp_decoder,
                                            dtype=dtype)
                return stylize_wct_q8(*args, dtype=dtype, **self._wct_args())
            return stylize_multi_adain_folded_q8(
                self.folded_weights(dtype), self.q8_weights(), scales,
                content, style, dtype=dtype, fuse_pairs=fuse_pairs)

    def _mst_args(self) -> Dict[str, Any]:
        c = self.cfg
        return {"stylized_layers": c.stylized_layers,
                "n_clusters": c.n_clusters, "mst_lambda": c.mst_lambda}

    def _blockwise(self) -> Dict[str, str]:
        """dynamic_sanet's attention route for its int8 path."""
        if self.network != "dynamic_sanet":
            return {}
        return {"blockwise": self.model.transform.blockwise}

    def _check_q8(self) -> None:
        if not self.q8_infer():
            raise ValueError("the int8 path needs adain without masks, wct, "
                             "mrf, seg_adain, spade with spade_norm "
                             "'instance', "
                             "sanet or dynamic_sanet with img_size a multiple "
                             "of 16, src without masks with img_size a "
                             "multiple of 8, ld_adain / ld_adain2 without "
                             "masks or inception with hidden_dim * "
                             "2^(ld_layer_num - 1) a multiple of 128 "
                             "(ld_adain2: an even img_size), or a folded "
                             "constant stack (multi_adain, sel_multi_adain, "
                             "ccam, mst) with 4 * hidden_dim a multiple of "
                             "128")

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
        """The RP stacks' weights folded for the folded paths, (encoder,
        decoder), cached per dtype until the next ``load_state_dict``."""
        dtype = dtype or self.folded_dtype()
        if dtype not in self._folded:
            self._folded[dtype] = folded_blocks(self.model, dtype)
        return self._folded[dtype]

    def folded_extras(self, dtype: Optional[torch.dtype] = None,
                      live: bool = False):
        """What a variant's folded path needs beside the stacks:
        sel_multi_adain's ``se_weights`` of its bottleneck in ``dtype``,
        ccam's ``ccam_{i}.scale`` parameters; None for the others. Detached
        and cached per dtype for serving, or ``live`` (the training step's,
        not cached)."""
        dtype = dtype or self.folded_dtype()
        if self.network == "sel_multi_adain":
            if live:
                return se_weights(self.model.attention_block, dtype,
                                  detach=False)
            key = ("se", dtype)
            if key not in self._folded:
                self._folded[key] = se_weights(self.model.attention_block,
                                               dtype)
            return self._folded[key]
        if self.network == "ccam":
            return [m.scale if live else m.scale.detach()
                    for m in self.model.channel_attentions]
        return None

    def stylize_folded(self, blocks, extras, content, style, dtype,
                       conv=None, train: bool = False,
                       batch_encode: bool = False,
                       ops: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """The network's folded forward on ``blocks`` (``folded_blocks`` or
        ``live_folded_blocks``) and ``extras`` (``folded_extras``); ``conv``
        the RP layer function (B1 by default), ``train`` sel_multi_adain's
        batch-statistic BatchNorms; ``ops`` the family function's other
        swappable pieces (``adain``, ``bottleneck``, ``ccam``: a row
        shard's, ``fast_path_spatial.spatial_ops``)."""
        kw = {} if conv is None else {"conv": conv}
        kw.update(ops or {})
        c = self.cfg
        if self.network == "sel_multi_adain":
            return stylize_sel_multi_adain_folded(
                blocks, extras, content, style, dtype=dtype, train=train,
                **kw)
        if self.network == "ccam":
            return stylize_ccam_folded(blocks, extras, content, style,
                                       c.stylized_layers, dtype=dtype, **kw)
        if self.network == "mst":
            return stylize_mst_folded(blocks, content, style, dtype=dtype,
                                      **self._mst_args(), **kw)
        return stylize_multi_adain_folded(blocks, content, style,
                                          dtype=dtype,
                                          batch_encode=batch_encode, **kw)

    def _mix(self, parts: Dict[str, torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        total = (c.content_weight * parts["content_loss"]
                 + c.style_weight * parts["style_loss"])
        if "mrf_loss" in parts:
            total = total + c.mrf_weight * parts["mrf_loss"]
        if "l_identity1_loss" in parts:
            total = total + (c.l_identity1_weight * parts["l_identity1_loss"]
                             + c.l_identity2_weight
                             * parts["l_identity2_loss"])
        if "seg_loss" in parts:
            total = total + c.seg_loss_weight * parts["seg_loss"]
        return total

    def loss(self, vgg: VGG19Encoder, content: torch.Tensor,
             style: torch.Tensor, targets=None,
             conv_act: ConvAct = folded_conv_act,
             content_label: Optional[torch.Tensor] = None,
             folded: Optional[bool] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss (rpst's ``ModelBundle.loss``):
        (total, parts) with parts ``style_loss``, ``content_loss`` and
        ``total_loss`` (sanet and dynamic_sanet: also ``l_identity1_loss``
        and ``l_identity2_loss``, from ``SAModel.loss`` on the 5-stage
        ``vgg``; src: ``SourceNet.loss`` on the 4-stage one; mrf: also
        ``mrf_loss``, from ``MRFRP.loss``; seg_adain: ``SegAdaINRP.loss``,
        with ``seg_loss`` when ``content_label`` (N, H, W) is given),
        differentiable in ``self.model``'s parameters.

        Folded (``folded_infer()``: the flagship and its three variants):
        the network's folded forward (``stylize_folded``) on the live folded
        weights, sel_multi_adain's BatchNorms on the batch statistics (their
        running statistics move), then the folded VGG loss, every folded
        conv through ``conv_act`` (B1's autograd Function; a benchmark
        passes B1's plain version to time the plain path), the RP layers
        with ``listed=True`` (their kernels are ``fold_conv_kernel``'s
        output, so B3 computes only the 36 blocks the fold reads). The
        style and content targets are ``targets`` when given ((t_stats,
        t_relu4) from ``train.target_cache.DeviceTargetCache``: one VGG
        sweep, the stylized pass); else, where ``q8_targets_active``, from
        the int8 VGG chain on B5; else the folded float pass. Standard: the
        module's forward in train mode, then ``perceptual_rp_losses``, under
        bfloat16 autocast when compute_dtype says so; ``folded=False``
        takes it for a folded config too (the row-sharded standard layout,
        ``fast_path_spatial.loss_std_spatial``)."""
        c = self.cfg
        if targets is not None and (not self.folded_infer()
                                    or folded is False):
            raise ValueError("precomputed loss targets (the target cache) "
                             "need a folded-family config (folded_infer)")
        if content_label is not None and self.network != "seg_adain":
            raise ValueError("content labels are seg_adain's")
        if self.from_features or self.network in ("mrf", "seg_adain"):
            kw = ({"content_label": content_label}
                  if self.network == "seg_adain" else {})
            with torch.autocast(self.device.type, dtype=torch.bfloat16,
                                enabled=c.compute_dtype == "bfloat16"):
                parts = self.model.loss(vgg, content, style, **kw)
        elif self.folded_infer() and folded is not False:
            dtype = self.folded_dtype()
            stylized = self.stylize_folded(
                live_folded_blocks(self.model, dtype),
                self.folded_extras(dtype, live=True), content, style, dtype,
                conv=lambda x, k, b: conv_act(x, k, b, 0.2, listed=True),
                train=True)
            if targets is not None:
                parts, _ = perceptual_rp_losses_folded_pretargets(
                    vgg, stylized, *targets, c.content_weight,
                    c.style_weight, dtype=dtype, conv_act=conv_act)
            elif self.q8_targets_active(content.shape[0]):
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
        loss takes the folded float targets, as rpst does. Any folded
        family's loss reads it (rpst's gate is ``folded_infer``)."""
        from ..policy import TRAIN_Q8_TARGETS_MIN_BATCH
        return (bool(self.cfg.get("train_q8_targets", False))
                and self.q8_target_scales is not None
                and self.cfg.img_size % 8 == 0
                and batch >= TRAIN_Q8_TARGETS_MIN_BATCH)

    def stylize(self, content: torch.Tensor, style: torch.Tensor,
                c_labels: Optional[torch.Tensor] = None,
                s_labels: Optional[torch.Tensor] = None,
                batch_encode: bool = False,
                folded: Optional[bool] = None) -> torch.Tensor:
        """Inference: (N, H, W, 3) content and style on the bundle's device
        -> (N, H, W, 3) float32. ``folded`` (default ``folded_infer()``
        when no labels are given, rpst's rule) picks the folded path;
        otherwise the standard model runs in eval mode (BatchNorm on its
        running statistics; the test mode of ``_TEST_MODE_MODELS``: the
        channel shuffle, the masks), under bfloat16 autocast when
        compute_dtype says so (the feature models: on the features of one 2N
        pass of ``bundle.vgg``; sanet's attention on B6 and both SANets'
        transforms in float32). ``c_labels`` / ``s_labels`` (N, H, W)
        integer label maps reach the test-mode networks, adain, seg_adain
        and src (which read them only with ``use_mask``; adain's and
        seg_adain's never, as rpst builds them). Runs under
        ``torch.inference_mode``."""
        labelled = c_labels is not None
        if folded is None:
            folded = self.folded_infer() and not labelled
        elif folded and (labelled or not self.folded_infer()):
            raise ValueError("folded execution needs exec_strategy: folded, "
                             "a network/config the folded path covers and "
                             "no labels")
        with torch.inference_mode():
            if folded:
                return self.stylize_folded(
                    self.folded_weights(), self.folded_extras(), content,
                    style, self.folded_dtype(), batch_encode=batch_encode)
            training = self.model.training
            self.model.eval()
            try:
                labels = {"c_labels": c_labels, "s_labels": s_labels}
                with self._autocast():
                    if self.from_features:
                        kw = (dict(labels, test_mode=True)
                              if self.network == "src" else {})
                        return self.model(*self._features(content, style),
                                          **kw).float()
                    if self.network in _TEST_MODE_MODELS:
                        kw = dict(labels, test_mode=True)
                    elif self.network in ("adain", "seg_adain"):
                        kw = labels
                    else:
                        kw = {}
                    return self.model(content, style, **kw).float()
            finally:
                self.model.train(training)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.cfg.compute_dtype == "bfloat16")

    def _features(self, content, style):
        """The content and style feature lists of one 2N pass of
        ``bundle.vgg``."""
        n = content.shape[0]
        feats = self._feature_vgg()(torch.cat([content, style]))
        return [f[:n] for f in feats], [f[n:] for f in feats]

    def stylize_with_aux(self, content: torch.Tensor, style: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Stylize and return visualization maps (rpst's
        ``ModelBundle.stylize_with_aux``): dynamic_sanet's claim maps per
        module, ``{"relu4_1": {"claim_value", "claim_before",
        "claim_after"}, "relu5_1": ...}``, on the dense route; every other
        network returns ``stylize`` and no maps."""
        if self.network != "dynamic_sanet":
            return self.stylize(content, style), {}
        with torch.inference_mode(), self._autocast():
            out, aux = self.model.stylize_with_aux(
                *self._features(content, style))
            return out.float(), aux


def build_model(cfg: Config, device="cpu") -> ModelBundle:
    """The bundle for ``cfg.network`` with PyTorch-default-initialized
    weights on ``device`` (seed them with ``nn.blocks.init_torch_default``
    or load them with ``bundle.load_state_dict``)."""
    n = cfg.network
    if n in _NOT_PORTED:
        raise ValueError(f"network {n!r} is not ported to rpst_torch yet: "
                         f"ROADMAP.md section A {_NOT_PORTED[n]}")
    device = torch.device(device)
    labels = dict(max_seg_labels=cfg.max_seg_labels)
    if n == "adain":
        # rpst builds adain without use_mask: its labels fuse plainly
        model = AdaINRP(rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim,
                        device=device)
    elif n == "wct":
        model = WCTRP(rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim,
                      method=cfg.wct_method, wct_dtype=cfg.wct_dtype,
                      device=device)
    elif n == "sanet":
        model = SAModel(adaptive=False, img_size=cfg.img_size, device=device)
    elif n == "dynamic_sanet":
        model = SAModel(adaptive=True, img_size=cfg.img_size,
                        ada_module=cfg.ada_module,
                        blockwise=cfg.adaptive_blockwise, device=device)
    elif n == "src":
        model = SourceNet(use_mask=bool(cfg.use_mask), **labels,
                          device=device)
    elif n == "mrf":
        model = MRFRP(rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim,
                      k=cfg.k, mrf_chunk=cfg.mrf_chunk, device=device)
    elif n == "spade":
        model = SpadeRP(rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim,
                        ndf=cfg.ndf, spade_norm=cfg.spade_norm,
                        device=device)
    elif n == "seg_adain":
        model = SegAdaINRP(rp_blocks=cfg.rp_blocks,
                           hidden_dim=cfg.hidden_dim, class_num=cfg.class_num,
                           seg_hidden_dim=cfg.seg_hidden_dim,
                           seg_loss_weight=cfg.seg_loss_weight, device=device)
    elif n in _LD:
        model = LDAdaINRP(variant=1 if n == "ld_adain" else int(n[-1]),
                          layer_num=cfg.ld_layer_num,
                          hidden_dim=cfg.hidden_dim,
                          stylized_layers=cfg.stylized_layers,
                          inception_num=cfg.inception_num,
                          use_mask=bool(cfg.use_mask), **labels,
                          device=device)
    elif n in _FOLDED_FAMILY:
        stack = dict(rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim,
                     enc_stack_way=_stack_way(cfg),
                     inception_num=cfg.inception_num,
                     attention=cfg.attention, device=device)
        shuffle = dict(shuffle=bool(cfg.shuffle),
                       shuffle_layers=cfg.shuffle_layers, sort=bool(cfg.sort))
        if n == "multi_adain":
            model = MultiScaleAdaINRP(**stack, **shuffle,
                                      use_mask=bool(cfg.use_mask), **labels)
        elif n == "sel_multi_adain":
            model = SELastRP(**stack, use_mask=bool(cfg.use_mask), **labels)
        elif n == "ccam":
            model = CCAMRP(**stack, **shuffle,
                           stylized_layers=cfg.stylized_layers,
                           use_mask=bool(cfg.use_mask), **labels)
        else:
            model = MSTRP(**stack, stylized_layers=cfg.stylized_layers,
                          n_clusters=cfg.n_clusters,
                          mst_lambda=cfg.mst_lambda)
    else:
        raise ValueError(f"unknown network {n!r}")
    model.eval()  # serving; training calls .train() (BatchNorm state)
    return ModelBundle(network=n, model=model, cfg=cfg, device=device)


def _stack_way(cfg: Config) -> str:
    """rpst's reading of ``enc_stack_way``: 'adain' / 'NONE' in reference
    YAMLs mean the constant stack."""
    way = cfg.enc_stack_way
    return way if way in ("deeper", "constant") else "constant"


def build_vgg(cfg: Config, device="cpu") -> Tuple[VGG19Encoder, str]:
    """The frozen VGG of the perceptual loss (and of the feature models'
    features), with
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
