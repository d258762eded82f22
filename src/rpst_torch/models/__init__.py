"""Model registry of the port; counterpart of ``rpst.models``.

This slice ports one network, the flagship ``multi_adain`` (constant RP
stack). ``build_model`` raises ``ValueError`` for the other 16, naming the
ROADMAP.md slice that brings each.

A :class:`ModelBundle` holds the ``nn.Module`` with its weights on one
device and exposes what the serving CLI calls:
  * ``stylize(content, style)`` -> image, NHWC in [0, 1] on the bundle's
    device (the reference's ``network.test`` path),
  * ``folded_exec()`` / ``folded_infer()``: whether the config asks for, and
    the model supports, folded execution,
  * ``load_state_dict(sd)``: weights in the port's names (see ``bridge``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..config import Config
from .adain_rp import MultiScaleAdaINRP
from .fast_path import folded_blocks, stylize_multi_adain_folded

__all__ = ["build_model", "ModelBundle", "MultiScaleAdaINRP"]

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
        self._folded.clear()

    def folded_weights(self, dtype: Optional[torch.dtype] = None):
        """The model's weights folded for ``stylize_multi_adain_folded``,
        cached per dtype until the next ``load_state_dict``."""
        dtype = dtype or self.folded_dtype()
        if dtype not in self._folded:
            self._folded[dtype] = folded_blocks(self.model, dtype)
        return self._folded[dtype]

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
    model.eval()
    return ModelBundle(network=n, model=model, cfg=cfg, device=device)
