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

The frozen VGG encoder (``nn.vgg.VGG19Encoder``, names ``conv_{i}.Conv_0``)
has three sources, all to the same state_dict:

  * ``vgg_from_flax(vgg_vars)``: rpst's ``vgg_vars`` tree
    (``conv_{i}/Conv_0/{kernel,bias}``, HWIO);
  * ``vgg_from_torch(sd)``: ``vgg_normalised.pth``, its convs at the
    nn.Sequential indices ``_TORCH_CONV_INDICES``;
  * ``vgg_from_npz(npz)``: ``tools/convert_vgg.py``'s ``w{i}``/``b{i}``
    (HWIO).

``load_vgg_weights(path)`` reads a ``.pth`` or ``.npz``;
``vgg_weights_from_seed(seed)`` draws a VGG from numpy alone, so that a
machine without JAX rebuilds the same weights.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .nn.vgg import _STAGES, _TORCH_CONV_INDICES, num_convs

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


# ---------------------------------------------------------------- VGG

def vgg_from_flax(vgg_vars) -> Dict[str, torch.Tensor]:
    """rpst's ``vgg_vars`` (``{'params': {'conv_{i}': {'Conv_0': {'kernel',
    'bias'}}}}``, or the inner tree) -> VGG19Encoder state_dict."""
    return from_flax_params(vgg_vars.get("params", vgg_vars))


def _vgg_sd(weights, num_stages: int) -> Dict[str, torch.Tensor]:
    """[(HWIO kernel, bias)] in conv order -> VGG19Encoder state_dict."""
    sd = {}
    for i in range(num_convs(num_stages)):
        w, b = weights[i]
        sd[f"conv_{i}.Conv_0.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(w, np.float32).transpose(3, 2, 0, 1)))
        sd[f"conv_{i}.Conv_0.bias"] = torch.tensor(np.asarray(b, np.float32))
    return sd


def vgg_from_torch(sd, num_stages: int = 4) -> Dict[str, torch.Tensor]:
    """``vgg_normalised.pth`` (``{idx}.weight`` OIHW, ``{idx}.bias``) ->
    VGG19Encoder state_dict."""
    return _vgg_sd([(np.asarray(sd[f"{i}.weight"], np.float32)
                     .transpose(2, 3, 1, 0), sd[f"{i}.bias"])
                    for i in _TORCH_CONV_INDICES[:num_convs(num_stages)]],
                   num_stages)


def vgg_from_npz(npz, num_stages: int = 4) -> Dict[str, torch.Tensor]:
    """``tools/convert_vgg.py`` output (``w{i}`` HWIO, ``b{i}``) ->
    VGG19Encoder state_dict."""
    return _vgg_sd([(npz[f"w{i}"], npz[f"b{i}"])
                    for i in range(num_convs(num_stages))], num_stages)


def load_vgg_weights(path, num_stages: int = 4) -> Dict[str, torch.Tensor]:
    """A ``vgg_normalised.pth`` or a converted ``.npz`` -> state_dict."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as npz:
            return vgg_from_npz(npz, num_stages)
    if path.suffix in (".pth", ".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return vgg_from_torch({k: v.numpy() for k, v in sd.items()},
                              num_stages)
    raise ValueError(f"VGG weights must be .pth or .npz, got {path}")


def vgg_weights_from_seed(seed: int, num_stages: int = 4) -> dict:
    """A random VGG as rpst's ``vgg_vars`` tree of float32 numpy arrays
    (HWIO kernels), drawn in conv order from ``numpy.random.default_rng(
    seed)``: He-normal kernels (std sqrt(2 / fan_in)), so that relu4_1
    keeps its scale and the content loss means something, and N(0, 0.01)
    biases. ``vgg_from_flax`` turns it into a state_dict."""
    rng = np.random.default_rng(seed)
    specs = [(1, 3, 3)] + [(3, i, o) for stage in _STAGES[:num_stages]
                           for i, o in stage]
    params = {}
    for idx, (k, cin, cout) in enumerate(specs):
        std = np.sqrt(2.0 / (k * k * cin))
        kernel = (rng.standard_normal((k, k, cin, cout)) * std)
        bias = rng.standard_normal(cout) * 0.01
        params[f"conv_{idx}"] = {"Conv_0": {
            "kernel": kernel.astype(np.float32),
            "bias": bias.astype(np.float32)}}
    return {"params": params}
