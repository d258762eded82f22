"""Weights into the port: flax parameter trees and reference checkpoints.

Two sources, one target (the port's ``state_dict`` names, which follow the
flax tree: ``rp_shared_encoder.block_{i}.PadConv_0.Conv_0.weight``):

  * ``from_flax_params(tree)``: a nested dict of numpy arrays as rpst's
    flax model holds it (kernels HWIO) -> state_dict (kernels OIHW), the
    conversion ``tests/reference_oracle.py``'s ``inject_*`` helpers make;
  * ``from_reference_checkpoint(ckpt)``: the reference ``.pth`` layout
    ``{'encoder': sd, 'decoder': sd}`` with ``{i}.conv.weight`` keys, which
    ``tools/export_reference_checkpoint.py`` writes from an rpst checkpoint.
    A model trained with ``train.py`` is served here with no JAX installed.

``load_weights(path)`` reads either file: ``.pth`` (reference layout) or
``.npz`` whose keys are flax paths (``rp_decoder/block_0/PadConv_0/Conv_0/
kernel``, optionally under a leading ``params/``).
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path
from typing import Dict

import numpy as np
import torch

_STACKS = {"encoder": "rp_shared_encoder", "decoder": "rp_decoder"}


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def from_flax_params(tree) -> Dict[str, torch.Tensor]:
    """rpst params tree (``{'rp_shared_encoder': {'block_0': {'PadConv_0':
    {'Conv_0': {'kernel', 'bias'}}}}, ...}``) -> port state_dict."""
    sd = {}
    for key, value in _flatten(tree):
        arr = np.array(value, np.float32)  # a writable copy
        if key.endswith(".kernel"):
            if arr.ndim != 4:
                raise ValueError(f"{key}: expected an HWIO conv kernel, got "
                                 f"shape {arr.shape}")
            sd[key[:-len("kernel")] + "weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif key.endswith(".bias"):
            sd[key] = torch.from_numpy(arr)
        else:
            raise ValueError(f"unexpected flax param {key!r}")
    return sd


def from_reference_checkpoint(ckpt) -> Dict[str, torch.Tensor]:
    """``{'encoder': {'{i}.conv.weight': OIHW, '{i}.conv.bias': ...},
    'decoder': {...}}`` of numpy arrays or CPU tensors -> port state_dict."""
    sd = {}
    for part, stack in _STACKS.items():
        if part not in ckpt:
            raise KeyError(f"reference checkpoint has no {part!r} "
                           f"(keys {sorted(ckpt)})")
        for key, value in ckpt[part].items():
            parts = key.split(".")
            if len(parts) != 3 or parts[1] != "conv":
                raise ValueError(f"{part}.{key}: only plain Conv2dBlocks are "
                                 "ported (no inception/attention state)")
            sd[f"{stack}.block_{parts[0]}.PadConv_0.Conv_0.{parts[2]}"] = \
                torch.tensor(np.asarray(value, np.float32))
    return sd


def flax_tree_from_npz(npz) -> dict:
    """Flat ``a/b/c`` keys of an npz -> nested dict; keys without a ``/``
    (non-parameter arrays) are skipped, a leading ``params/`` is dropped."""
    tree: dict = {}
    for key in npz.files:
        if "/" not in key:
            continue
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    return tree


def load_weights(path) -> Dict[str, torch.Tensor]:
    """A ``.pth`` reference checkpoint or an ``.npz`` of flax paths ->
    port state_dict."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as npz:
            return from_flax_params(flax_tree_from_npz(npz))
    if path.suffix in (".pth", ".pt"):
        return from_reference_checkpoint(
            torch.load(path, map_location="cpu", weights_only=True))
    raise ValueError(f"--weights must be .pth or .npz, got {path}")
