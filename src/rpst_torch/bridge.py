"""Weights into the port: flax parameter trees and reference checkpoints.

Two sources, one target (the port's ``state_dict`` names, which follow the
flax tree: ``rp_shared_encoder.block_{i}.PadConv_0.Conv_0.weight`` for the
flagship's Conv2dBlock stacks, ``encoder.conv_{i}.Conv_0.weight`` for the
``RPSequence`` stacks of adain and wct, ``transform.sanet4_1.f.weight`` ..
``transform.merge_conv.Conv_0.weight`` and ``decoder.conv{i}.Conv_0.weight``
for the static SANet):

  * ``from_flax_params(tree)``: a nested dict of numpy arrays as rpst's
    flax model holds it (kernels HWIO) -> state_dict (kernels OIHW), the
    conversion ``tests/reference_oracle.py``'s ``inject_*`` helpers make;
    it walks any conv subtree (1x1 kernels too), so the flagship's,
    adain's, wct's and sanet's ``params`` all cross through it;
  * ``from_reference_checkpoint(ckpt)``: the reference ``.pth`` layout
    ``{'encoder': sd, 'decoder': sd}``, which
    ``tools/export_reference_checkpoint.py`` writes from an rpst
    checkpoint: ``{i}.conv.weight`` keys for the flagship (rpstack),
    ``{2i}.weight`` keys of ``nn.Sequential(Conv2d, ReLU)`` for adain and
    wct (rpseq), and ``{'transform': sd, 'decoder': sd}`` for sanet (the
    decoder's convs at the Sequential indices ``_MIRROR_DECODER_IDXS``). A
    model trained with ``train.py`` is served here with no JAX installed.

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
machine without JAX rebuilds the same weights, and
``rpseq_weights_from_seed`` does the same for adain's and wct's stacks
(their full-width weights are 12 MB, too large to keep in a fixture);
``sanet_weights_from_seed`` for the static SANet's transform and decoder
(~30 MB at its fixed width).
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .nn.vgg import _STAGES, _TORCH_CONV_INDICES, num_convs

_STACKS = {"encoder": "rp_shared_encoder", "decoder": "rp_decoder"}
# the reference VGG-mirror decoder Sequential (base.py:25-55): the positions
# of conv0..conv8 among its pad / relu / upsample layers
_MIRROR_DECODER_IDXS = (1, 5, 8, 11, 14, 18, 21, 25, 28)


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
    """``{'encoder': sd, 'decoder': sd}`` of numpy arrays or CPU tensors ->
    port state_dict. ``{i}.conv.weight`` keys (OIHW) are the flagship's
    Conv2dBlock stacks; ``{2i}.weight`` keys are the conv + ReLU Sequentials
    of adain and wct, whose conv i sits at index 2i."""
    if "transform" in ckpt:
        return _sanet_from_reference(ckpt)
    sd = {}
    for part, stack in _STACKS.items():
        if part not in ckpt:
            raise KeyError(f"reference checkpoint has no {part!r} "
                           f"(keys {sorted(ckpt)})")
        for key, value in ckpt[part].items():
            parts = key.split(".")
            if len(parts) == 3 and parts[1] == "conv":
                name = f"{stack}.block_{parts[0]}.PadConv_0.Conv_0.{parts[2]}"
            elif len(parts) == 2 and parts[0].isdigit() \
                    and int(parts[0]) % 2 == 0:
                name = f"{part}.conv_{int(parts[0]) // 2}.Conv_0.{parts[1]}"
            else:
                raise ValueError(f"{part}.{key}: only plain Conv2dBlocks and "
                                 "conv + ReLU Sequentials are ported (no "
                                 "inception/attention state)")
            sd[name] = torch.tensor(np.asarray(value, np.float32))
    return sd


def _sanet_from_reference(ckpt) -> Dict[str, torch.Tensor]:
    """``{'transform': sd, 'decoder': sd}`` (static SANet) -> port
    state_dict; the adaptive modules' ``attention_layer`` keys raise."""
    if "decoder" not in ckpt:
        raise KeyError(f"reference checkpoint has no 'decoder' (keys "
                       f"{sorted(ckpt)})")
    sd = {}
    for key, value in ckpt["transform"].items():
        if "attention_layer" in key:
            raise ValueError(f"transform.{key}: the adaptive SANet is not "
                             "ported yet (ROADMAP.md section A slice 6b)")
        name = key.replace("merge_conv.", "merge_conv.Conv_0.")
        sd[f"transform.{name}"] = torch.tensor(np.asarray(value, np.float32))
    for key, value in ckpt["decoder"].items():
        idx, leaf = key.split(".")
        if int(idx) not in _MIRROR_DECODER_IDXS:
            raise ValueError(f"decoder.{key}: not a conv of the VGG-mirror "
                             "decoder")
        i = _MIRROR_DECODER_IDXS.index(int(idx))
        sd[f"decoder.conv{i}.Conv_0.{leaf}"] = torch.tensor(
            np.asarray(value, np.float32))
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


def rpseq_weights_from_seed(seed: int, rp_blocks: int = 5,
                            hidden_dim: int = 32) -> dict:
    """adain's / wct's ``params`` tree (``encoder`` and ``decoder``
    RPSequences, HWIO float32 numpy kernels) drawn from
    ``numpy.random.default_rng(seed)`` in conv order: He-uniform kernels,
    U(+-sqrt(6 / fan_in)), so that the signal keeps its scale through the
    ten conv + ReLU layers and the output depends on the images, and
    U(+-1/sqrt(fan_in)) biases.
    ``from_flax_params`` turns it into the port's state_dict; rpst takes it
    as its flax ``params``."""
    from .nn.blocks import rp_decrease_dims, rp_increase_dims
    rng = np.random.default_rng(seed)
    enc_out = hidden_dim * 2 ** (rp_blocks - 1)
    stacks = {"encoder": rp_increase_dims(rp_blocks, 3, hidden_dim, enc_out),
              "decoder": rp_decrease_dims(rp_blocks, enc_out, enc_out // 2, 3)}
    tree: dict = {}
    for name, dims in stacks.items():
        tree[name] = {}
        for i, (cin, cout) in enumerate(dims):
            bound = (9 * cin) ** -0.5
            he = (6.0 / (9 * cin)) ** 0.5
            tree[name][f"conv_{i}"] = {"Conv_0": {
                "kernel": rng.uniform(-he, he, (3, 3, cin, cout))
                .astype(np.float32),
                "bias": rng.uniform(-bound, bound, cout).astype(np.float32)}}
    return tree


def sanet_weights_from_seed(seed: int) -> dict:
    """The static SANet's ``params`` tree (``transform``: two attention
    modules and the merge conv; ``decoder``: conv0 .. conv8; HWIO float32
    numpy kernels) drawn from ``numpy.random.default_rng(seed)`` in module
    order. The 3x3 convs are He-uniform, U(+-sqrt(6 / fan_in)), so that the
    signal keeps its scale through the decoder's ReLUs; the 1x1 attention
    convs, which no ReLU follows, are U(+-1/sqrt(fan_in)) (PyTorch's
    default), which puts the attention logits of mean-variance-normalized
    512-channel features at a standard deviation near 8: a peaked softmax,
    as a trained model's is. Biases are U(+-1/sqrt(fan_in)).
    ``from_flax_params`` turns it into the port's state_dict; rpst takes it
    as its flax ``params``."""
    from .nn.decoder import MIRROR_DIMS
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout, he):
        fan_in = k * k * cin
        lim = (6.0 / fan_in) ** 0.5 if he else fan_in ** -0.5
        return {"kernel": rng.uniform(-lim, lim, (k, k, cin, cout))
                .astype(np.float32),
                "bias": rng.uniform(-fan_in ** -0.5, fan_in ** -0.5, cout)
                .astype(np.float32)}

    transform = {name: {leaf: conv(1, 512, 512, False)
                        for leaf in ("f", "g", "h", "out_conv")}
                 for name in ("sanet4_1", "sanet5_1")}
    transform["merge_conv"] = {"Conv_0": conv(3, 512, 512, True)}
    decoder = {f"conv{i}": {"Conv_0": conv(3, cin, cout, True)}
               for i, (cin, cout) in enumerate(MIRROR_DIMS)}
    return {"transform": transform, "decoder": decoder}
