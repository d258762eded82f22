"""The port's config loader; counterpart of ``rpst.config``.

It reads the same flat YAML files (or a dict) as rpst. ``DEFAULTS`` holds
the keys the port reads, with rpst's defaults; any other key is kept as it
is, so every rpst config loads here. The port owns this loader so that
nothing it runs imports the reference package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import yaml

DEFAULTS: Dict[str, Any] = {
    "network": "multi_adain",
    "rp_blocks": 5,
    "hidden_dim": 32,
    "inception_num": 0,
    "enc_stack_way": "constant",
    "attention": "none",
    "shuffle": False,
    "shuffle_layers": 1,
    "sort": False,
    # ccam / mst: the fused scales (None -> rp_blocks), MST's k-means
    # cluster count and Potts weight (the reference's lambda is 0)
    "stylized_layers": None,
    # the LD family's layer count (None -> rp_blocks)
    "ld_layer_num": None,
    "n_clusters": 3,
    "mst_lambda": 0.0,
    "use_mask": False,
    "max_seg_labels": 64,  # the label universe of masked AdaIN
    "img_size": 512,
    "seed": 0,
    "compute_dtype": "float32",  # 'float32' | 'bfloat16'
    "wct_method": "closed-form",  # | 'original'
    "wct_dtype": "float32",  # | 'float64' (the reference whitens in float64)
    "exec_strategy": "standard",  # 'standard' | 'folded'
    # dynamic_sanet: the threshold module ('aea': sigmoid, 'relu': tanh +
    # relu + softmax) and the adaptive attention's route ('never': dense
    # (HWc, HWs) matrices, 'always': streamed by query blocks, 'auto':
    # streamed on a CUDA device from rpst_torch.policy.ADAPTIVE_STREAM_ROWS
    # rows on both sides)
    "ada_module": "aea",
    "adaptive_blockwise": "auto",
    # mrf: the top-k of its affinity mask and the MRF loss's streaming (0:
    # dense (HW, HW) matrices; > 0: row chunks of that many positions)
    "k": 5,
    "mrf_chunk": 0,
    # spade: the generator's base width and param-free norm ('instance' |
    # 'batch' | 'syncbatch', the latter two flax's BatchNorm)
    "ndf": 2,
    "spade_norm": "instance",
    # seg_adain: the segmentation head's classes and width, its loss weight
    # (0: no head) and the Cityscapes side-by-side folder that feeds it
    "class_num": 19,
    "seg_hidden_dim": 32,
    "seg_loss_weight": 1.0,
    "seg_dir": "",
    # training (train_torch.py)
    "lr": 1e-4,
    "lr_decay": 0.0,
    "content_weight": 1.0,
    "style_weight": 1.0,
    "mrf_weight": 0.0,
    "l_identity1_weight": 50.0,  # sanet's two identity losses
    "l_identity2_weight": 1.0,
    "batch_size": 1,
    "max_iter": 1_000_000,
    "log_iter": 1,
    # capture a torch.profiler device trace spanning ``profile_steps``
    # steps starting at iteration ``profile_iter`` (0 = off); written to
    # <output>/logs/trace for TensorBoard / Perfetto (SURVEY §5: the
    # reference's only observability is wall-clock prints)
    "profile_iter": 0,
    "profile_steps": 3,
    "snapshot_save_iter": 10000,
    "test_iter": 10000,
    "num_workers": 8,
    "content_dir": "",
    "style_dir": "",
    "test_dir": "",
    "test_dataset": "paired",  # | 'photoreal' | 'iden_photoreal' | 'fmt'
    "output": "output/run",
    "checkpoint_path": "",
    "resume": False,
    "vgg": "",
    # multi-device training (rpst schema.py:121-127): a {data?, spatial?}
    # rank grid; the distributed keys start one process per rank from
    # outside (torchrun's environment where they are unset)
    "mesh_shape": None,
    "distributed": False,
    "coordinator_address": "",
    "num_processes": -1,
    "process_id": -1,
    # the row-sharded folded route of multi_adain / ccam / sel_multi_adain
    # on a mesh (rpst schema.py:153; off: data parallel)
    "folded_train_pallas": True,
    "grad_accum": 1,
    "remat": False,
    # int8 no-grad VGG loss targets of the folded families' loss (B5)
    "train_q8_targets": False,
}

_NETWORKS = (
    "src", "adain", "multi_adain", "sel_multi_adain", "wct", "ccam", "mst",
    "ld_adain", "ld_adain2", "ld_adain3", "ld_adain4", "ld_adain5",
    "dynamic_sanet", "sanet", "mrf", "spade", "seg_adain",
)
_STACK_WAYS = ("deeper", "constant", "adain", "NONE", "shallower",
               "dec_shallower")


class Config:
    """Flat config with attribute and item access."""

    def __init__(self, raw: Dict[str, Any]):
        object.__setattr__(self, "_raw", dict(raw))

    def __getitem__(self, key: str) -> Any:
        return self._raw[key]

    def __contains__(self, key: str) -> bool:
        return key in self._raw

    def __getattr__(self, key: str) -> Any:
        raw = object.__getattribute__(self, "_raw")
        if key in raw:
            return raw[key]
        raise AttributeError(key)

    def get(self, key: str, default: Any = None) -> Any:
        return self._raw.get(key, default)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._raw)

    def replace(self, **kwargs: Any) -> "Config":
        return Config({**self._raw, **kwargs})


def load_config(path_or_dict, overrides: Optional[Dict[str, Any]] = None
                ) -> Config:
    """A YAML path or a dict, over ``DEFAULTS``, then ``overrides``; keys
    set to null take the default, as in rpst."""
    if isinstance(path_or_dict, (str, Path)):
        with open(path_or_dict) as f:
            user = yaml.safe_load(f) or {}
    else:
        user = dict(path_or_dict)
    cfg = dict(DEFAULTS)
    cfg.update({k: v for k, v in user.items() if v is not None})
    cfg.update(overrides or {})
    if cfg["stylized_layers"] is None:
        cfg["stylized_layers"] = cfg["rp_blocks"]
    if cfg["ld_layer_num"] is None:
        cfg["ld_layer_num"] = cfg["rp_blocks"]
    if cfg["attention"] in (False, None):
        cfg["attention"] = "none"
    if cfg["network"] not in _NETWORKS:
        raise ValueError(f"unknown network {cfg['network']!r}; expected one "
                         f"of {_NETWORKS}")
    if cfg["rp_blocks"] < 2:
        raise ValueError("rp_blocks must be >= 2")
    if cfg["enc_stack_way"] not in _STACK_WAYS:
        raise ValueError(f"unknown enc_stack_way {cfg['enc_stack_way']!r}")
    if cfg["attention"] not in ("none", "se", "sk"):
        raise ValueError(f"unknown attention {cfg['attention']!r}")
    if cfg["ada_module"] not in ("aea", "relu"):
        raise ValueError(f"unknown ada_module {cfg['ada_module']!r}")
    if cfg["adaptive_blockwise"] not in ("auto", "always", "never"):
        raise ValueError(
            f"unknown adaptive_blockwise {cfg['adaptive_blockwise']!r}")
    return Config(cfg)
