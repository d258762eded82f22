"""Weights into the port: flax parameter trees and reference checkpoints.

Two sources, one target (the port's ``state_dict`` names, which follow the
flax tree: ``rp_shared_encoder.block_{i}.PadConv_0.Conv_0.weight`` for the
flagship's Conv2dBlock stacks, ``encoder.conv_{i}.Conv_0.weight`` for the
``RPSequence`` stacks of adain and wct, ``transform.sanet4_1.f.weight`` ..
``transform.merge_conv.Conv_0.weight`` and ``decoder.conv{i}.Conv_0.weight``
for the SANets, with ``transform.sanet4_1.attention_layer.f_psi.{0,2}.weight``
for the adaptive one's threshold MLP, ``decoder.conv{i}.Conv_0.weight``
alone for SourceNet, ``ms.rp_shared_encoder...`` with
``attention_block.*`` (the SE bottleneck) or ``ccam_{i}.scale`` for
sel_multi_adain and ccam, ``rp_content_encoder.conv_{i}.Conv_0.weight``,
``rp_style_encoder...`` and ``rp_decoder...`` for mrf and spade (spade's
generator ``rp_decoder.head.norm_s.mlp_shared.weight``, ``...conv_s``,
``...conv_0``, ``...conv_img``), ``adain_rp.encoder...`` and
``seg_head.seg_head.block_{i}.PadConv_0.Conv_0.weight`` for seg_adain,
``rp_enc{i}_small_revf.PadConv_0.Conv_0.weight``,
``rp_enc{i}_big_revf...`` (v1's Conv2dBlock, or the pooled branch's
``conv1x1.weight``, ``conv_a.Conv_0.weight``, ``conv_b...``),
``rp_dec{i}...`` and v5's ``up_{i}.kernel`` for the LD family):

  * ``from_flax_params(tree)``: a nested dict of numpy arrays as rpst's
    flax model holds it (kernels HWIO) -> state_dict (kernels OIHW), the
    conversion ``tests/reference_oracle.py``'s ``inject_*`` helpers make;
    it walks any conv subtree (1x1 kernels too), so the flagship's,
    adain's, wct's, the SANets', SourceNet's and the LD family's ``params``
    all cross through it (the LD v5 upsamplers' ``up_{i}/kernel`` keeps its
    name and flax's (s, s, C, Co) layout: ``NonOverlapConvTranspose`` reads
    it so); dynamic_sanet's ``aea/psi0`` and ``aea/psi1`` Dense kernels
    (in, out) become ``attention_layer.f_psi.0`` and ``.2`` Linear weights
    (out, in), as do the SE layer's ``Dense_0`` / ``Dense_1``; a
    BatchNorm's ``scale`` becomes its ``weight``, and
    ``from_flax_batch_stats`` maps rpst's ``batch_stats`` (``mean``,
    ``var``) onto the BatchNorm buffers (sel_multi_adain's, spade's
    ``pf_bn``);
  * ``from_reference_checkpoint(ckpt)``: the reference ``.pth`` layout
    ``{'encoder': sd, 'decoder': sd}``, which
    ``tools/export_reference_checkpoint.py`` writes from an rpst
    checkpoint: ``{i}.conv.weight`` keys for the flagship (rpstack), with
    ``{i}.inception.{j}.0.*`` for its inception 1x1 convs and
    ``{i}.attention_block.*`` for an encoder block's SE bottleneck
    (``attention: se``: convs, BatchNorms with their running statistics,
    ``se.fc.{0,2}``) onto the block's ``SEBottleneck_0``,
    ``{2i}.weight`` keys of ``nn.Sequential(Conv2d, ReLU)`` for adain and
    wct (rpseq), ``{'transform': sd, 'decoder': sd}`` for sanet and
    dynamic_sanet (the decoder's convs at the Sequential indices
    ``_MIRROR_DECODER_IDXS``; the adaptive modules' ``attention_layer.
    f_psi.*`` keys under the port's own names), and ``{'decoder': sd}``
    for SourceNet. A model trained with ``train.py`` is served here with no
    JAX installed.

``load_weights(path)`` reads either file: ``.pth`` (reference layout) or
``.npz`` whose keys are flax paths (``rp_decoder/block_0/PadConv_0/Conv_0/
kernel``, optionally under a leading ``params/``; ``batch_stats/...`` keys
go through ``from_flax_batch_stats``).

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
(~30 MB at its fixed width), ``dynamic_sanet_weights_from_seed`` for the
adaptive one (its psi widths follow the image size),
``src_weights_from_seed`` for SourceNet's decoder, and
``mrf_weights_from_seed``, ``spade_weights_from_seed`` and
``seg_adain_weights_from_seed`` for the slice-5b networks (30-40 MB at full
width), ``ld_weights_from_seed`` for the LD family.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Tuple

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


# the LD v5 upsamplers' kernel: kept in flax's (s, s, C, Co) layout
_UP_KERNEL = re.compile(r"(^|\.)up_\d+\.kernel$")
# dynamic_sanet's threshold MLP: rpst's Dense names -> the reference's
# (and the port's) Sequential positions
PSI_NAMES = {".aea.psi0.": ".attention_layer.f_psi.0.",
        ".aea.psi1.": ".attention_layer.f_psi.2."}


def from_flax_params(tree) -> Dict[str, torch.Tensor]:
    """rpst params tree (``{'rp_shared_encoder': {'block_0': {'PadConv_0':
    {'Conv_0': {'kernel', 'bias'}}}}, ...}``) -> port state_dict. Conv
    kernels (HWIO) become OIHW weights, Dense kernels (in, out) Linear
    weights (out, in), a BatchNorm's ``scale`` (``bn*``, a Conv2dBlock's
    ``BatchNorm_0``) its ``weight``; a CCAM module's ``scale`` and a
    Conv2dBlock's ``prelu_alpha`` keep their names. The inception 1x1
    convs (``inception_{j}``) and the SK bottleneck (``SKBottleneck_0/
    {conv1, bn1, SKLayer_0/{branch_i, fc1, fc2}, conv3, bn3}``, grouped
    branch kernels (3, 3, C / groups, Co) -> (Co, C / groups, 3, 3)) are
    plain convs and BatchNorms to it."""
    sd = {}
    for key, value in _flatten(tree):
        arr = np.array(value, np.float32)  # a writable copy
        psi = [k for k in PSI_NAMES if k in f".{key}"]
        if psi:
            key = f".{key}".replace(psi[0], PSI_NAMES[psi[0]])[1:]
        if _UP_KERNEL.search(key):
            pass
        elif key.endswith(".kernel"):
            key = key[:-len("kernel")] + "weight"
            if arr.ndim == 2:
                arr = arr.T.copy()
            elif arr.ndim == 4:
                arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
            else:
                raise ValueError(f"{key}: expected an HWIO conv kernel or a "
                                 f"Dense kernel (in, out), got shape "
                                 f"{arr.shape}")
        elif key.endswith(".scale") and key.split(".")[-2].startswith(
                ("bn", "BatchNorm_")):
            key = key[:-len("scale")] + "weight"
        elif key.rpartition(".")[2] not in ("bias", "scale", "prelu_alpha"):
            raise ValueError(f"unexpected flax param {key!r}")
        sd[key] = torch.from_numpy(arr)
    return sd


def from_flax_batch_stats(tree) -> Dict[str, torch.Tensor]:
    """rpst's ``batch_stats`` collection (``{'attention_block': {'bn1':
    {'mean', 'var'}}}``) -> the port's BatchNorm buffers
    (``attention_block.bn1.running_mean`` / ``.running_var``)."""
    names = {"mean": "running_mean", "var": "running_var"}
    sd = {}
    for key, value in _flatten(tree):
        stem, _, leaf = key.rpartition(".")
        if leaf not in names:
            raise ValueError(f"unexpected flax batch stat {key!r}")
        sd[f"{stem}.{names[leaf]}"] = torch.from_numpy(
            np.array(value, np.float32))
    return sd


# the reference SE bottleneck's keys under ``{i}.attention_block`` -> the
# port's under ``block_{i}.SEBottleneck_0`` (the flax names)
_SE_REF_NAMES = {"se.fc.0": "SELayer_0.Dense_0", "se.fc.2": "SELayer_0.Dense_1"}


def _se_from_reference(stem: str, leaf: str):
    """The port's name of a reference ``attention_block`` key (``conv1.
    weight``, ``bn1.running_mean``, ``se.fc.0.weight``), or None for the
    BatchNorm's ``num_batches_tracked``, which the port does not keep."""
    if leaf == "num_batches_tracked":
        return None
    return f"{_SE_REF_NAMES.get(stem, stem)}.{leaf}"


def from_reference_checkpoint(ckpt) -> Dict[str, torch.Tensor]:
    """``{'encoder': sd, 'decoder': sd}`` of numpy arrays or CPU tensors ->
    port state_dict. ``{i}.conv.weight`` keys (OIHW) are the flagship's
    Conv2dBlock stacks, ``{i}.inception.{j}.0.*`` their inception 1x1
    convs, ``{i}.attention_block.*`` their SE bottlenecks;
    ``{2i}.weight`` keys are the conv + ReLU Sequentials
    of adain and wct, whose conv i sits at index 2i. ``{'transform': sd,
    'decoder': sd}`` is a SANet's, ``{'decoder': sd}`` SourceNet's."""
    if "transform" in ckpt:
        return _sanet_from_reference(ckpt)
    if set(ckpt) == {"decoder"} and _is_mirror_decoder(ckpt["decoder"]):
        return _mirror_decoder_from_reference(ckpt["decoder"])
    sd = {}
    for part, stack in _STACKS.items():
        if part not in ckpt:
            raise KeyError(f"reference checkpoint has no {part!r} "
                           f"(keys {sorted(ckpt)})")
        for key, value in ckpt[part].items():
            parts = key.split(".")
            if len(parts) == 3 and parts[1] == "conv":
                name = f"{stack}.block_{parts[0]}.PadConv_0.Conv_0.{parts[2]}"
            elif (len(parts) == 5 and parts[1] == "inception"
                  and parts[3] == "0"):
                # Sequential(Conv2d 1x1, ...) at {i}.inception.{j}
                name = f"{stack}.block_{parts[0]}.inception_{parts[2]}." \
                       f"{parts[4]}"
            elif len(parts) >= 4 and parts[1] == "attention_block":
                se = _se_from_reference(".".join(parts[2:-1]), parts[-1])
                if se is None:
                    continue
                name = f"{stack}.block_{parts[0]}.SEBottleneck_0.{se}"
            elif len(parts) == 2 and parts[0].isdigit() \
                    and int(parts[0]) % 2 == 0:
                name = f"{part}.conv_{int(parts[0]) // 2}.Conv_0.{parts[1]}"
            else:
                raise ValueError(f"{part}.{key}: only plain Conv2dBlocks "
                                 "(with their inception convs and SE "
                                 "attention, the keys rpst's export writes) "
                                 "and conv + ReLU Sequentials are read")
            sd[name] = torch.tensor(np.asarray(value, np.float32))
    return sd


def _sanet_from_reference(ckpt) -> Dict[str, torch.Tensor]:
    """``{'transform': sd, 'decoder': sd}`` (sanet, or dynamic_sanet with
    its ``attention_layer.f_psi.*`` keys, already the port's names) -> port
    state_dict."""
    if "decoder" not in ckpt:
        raise KeyError(f"reference checkpoint has no 'decoder' (keys "
                       f"{sorted(ckpt)})")
    sd = {}
    for key, value in ckpt["transform"].items():
        name = key.replace("merge_conv.", "merge_conv.Conv_0.")
        sd[f"transform.{name}"] = torch.tensor(np.asarray(value, np.float32))
    return {**sd, **_mirror_decoder_from_reference(ckpt["decoder"])}


def _is_mirror_decoder(dec) -> bool:
    """Are all keys ``{idx}.weight`` / ``{idx}.bias`` of the VGG-mirror
    decoder Sequential's convs (a flagship decoder alone is not)?"""
    def conv_key(key):
        idx, _, leaf = key.partition(".")
        return (idx.isdigit() and int(idx) in _MIRROR_DECODER_IDXS
                and leaf in ("weight", "bias"))
    return bool(dec) and all(conv_key(k) for k in dec)


def _mirror_decoder_from_reference(dec) -> Dict[str, torch.Tensor]:
    """The reference VGG-mirror decoder Sequential's conv keys -> the port's
    ``decoder.conv{i}.Conv_0`` names."""
    sd = {}
    for key, value in dec.items():
        idx, leaf = key.split(".")
        if int(idx) not in _MIRROR_DECODER_IDXS:
            raise ValueError(f"decoder.{key}: not a conv of the VGG-mirror "
                             "decoder")
        i = _MIRROR_DECODER_IDXS.index(int(idx))
        sd[f"decoder.conv{i}.Conv_0.{leaf}"] = torch.tensor(
            np.asarray(value, np.float32))
    return sd


def tp_shares(tree, index: int, tp: int, min_channels: int = 32) -> dict:
    """A flax param tree (numpy, full shapes) cut to the shares of model
    rank ``index`` of ``tp``: every leaf rpst's ``_tp_leaf_spec`` shards
    (a 4-D kernel on its last dim, a 1-D vector, where that size divides by
    ``tp`` and reaches ``min_channels``) sliced to this rank's part, the
    rest whole. ``from_flax_params`` of it is what ``dist.tp.shard_model``
    keeps on that rank."""
    from .dist.tp import flax_leaf_spec
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = tp_shares(v, index, tp, min_channels)
            continue
        v = np.asarray(v)
        dim = flax_leaf_spec(v.shape, tp, min_channels)
        if dim is not None:
            step = v.shape[dim] // tp
            v = np.take(v, range(index * step, (index + 1) * step), axis=dim)
        out[k] = v
    return out


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
    """A ``.pth`` reference checkpoint, the port's own training checkpoint
    (``<output>/checkpoints/<step>/state.pt``: its ``params``, the
    one-device layout whatever mesh trained it) or an ``.npz`` of flax
    paths -> port state_dict."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as npz:
            tree = flax_tree_from_npz(npz)
        stats = tree.pop("batch_stats", {})
        return {**from_flax_params(tree), **from_flax_batch_stats(stats)}
    if path.suffix in (".pth", ".pt"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if "params" in ckpt and "opt_state" in ckpt:  # train_torch.py's
            return dict(ckpt["params"])
        return from_reference_checkpoint(ckpt)
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


def _conv_draw(rng, k: int, cin: int, cout: int, he: bool = True,
               bias: bool = True) -> dict:
    """One conv's flax leaves drawn from ``rng``: an HWIO kernel, He-uniform
    U(+-sqrt(6 / fan_in)) (``he``) or U(+-1/sqrt(fan_in)), then a
    U(+-1/sqrt(fan_in)) bias."""
    fan_in = k * k * cin
    lim = (6.0 / fan_in) ** 0.5 if he else fan_in ** -0.5
    out = {"kernel": rng.uniform(-lim, lim, (k, k, cin, cout))
           .astype(np.float32)}
    if bias:
        out["bias"] = rng.uniform(-fan_in ** -0.5, fan_in ** -0.5,
                                  cout).astype(np.float32)
    return out


def _rpseq_draw(rng, dims) -> dict:
    """An ``RPSequence``'s tree (``conv_{i}/Conv_0``), He-uniform."""
    return {f"conv_{i}": {"Conv_0": _conv_draw(rng, 3, cin, cout)}
            for i, (cin, cout) in enumerate(dims)}


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
    return {"encoder": _rpseq_draw(rng, rp_increase_dims(
                rp_blocks, 3, hidden_dim, enc_out)),
            "decoder": _rpseq_draw(rng, rp_decrease_dims(
                rp_blocks, enc_out, enc_out // 2, 3))}


def mrf_weights_from_seed(seed: int, rp_blocks: int = 5,
                          hidden_dim: int = 32) -> dict:
    """MRFRP's ``params`` tree (``rp_content_encoder``, ``rp_style_encoder``,
    ``rp_decoder``; HWIO float32 numpy kernels) drawn from
    ``numpy.random.default_rng(seed)`` in that order, as
    ``rpseq_weights_from_seed`` draws (He-uniform kernels,
    U(+-1/sqrt(fan_in)) biases)."""
    from .nn.blocks import rp_decrease_dims, rp_increase_dims
    rng = np.random.default_rng(seed)
    enc_out = hidden_dim * 2 ** (rp_blocks - 1)
    enc = rp_increase_dims(rp_blocks, 3, hidden_dim, enc_out)
    return {"rp_content_encoder": _rpseq_draw(rng, enc),
            "rp_style_encoder": _rpseq_draw(rng, enc),
            "rp_decoder": _rpseq_draw(rng, rp_decrease_dims(
                rp_blocks, 2 * enc_out, enc_out, 3))}


def spade_weights_from_seed(seed: int, rp_blocks: int = 5,
                            hidden_dim: int = 32, ndf: int = 2) -> dict:
    """SpadeRP's ``params`` tree drawn from ``numpy.random.default_rng(
    seed)``: the two encoders as ``mrf_weights_from_seed``'s, then the
    generator block by block (``head``, ``rp_middle_0``, ``rp_middle_1``,
    ``d1`` .. ``d4``; in each ``conv_s`` (bias-free), ``norm_s``, ``conv_0``,
    ``norm_0``, ``conv_1``, ``norm_1``, each norm's ``mlp_shared``,
    ``mlp_gamma``, ``mlp_beta``) and ``conv_img``. The convs that an
    activation or a norm follows are He-uniform; ``mlp_gamma``,
    ``mlp_beta`` and ``conv_img`` U(+-1/sqrt(fan_in)), PyTorch's default,
    so that the modulation 1 + gamma stays near 1. The param-free norms
    have no parameters."""
    from .nn.blocks import rp_increase_dims
    rng = np.random.default_rng(seed)
    enc_out = hidden_dim * 2 ** (rp_blocks - 1)
    enc = rp_increase_dims(rp_blocks, 3, hidden_dim, enc_out)
    tree = {"rp_content_encoder": _rpseq_draw(rng, enc),
            "rp_style_encoder": _rpseq_draw(rng, enc)}

    def spade(norm_nc):
        return {"mlp_shared": _conv_draw(rng, 3, enc_out, 128),
                "mlp_gamma": _conv_draw(rng, 3, 128, norm_nc, he=False),
                "mlp_beta": _conv_draw(rng, 3, 128, norm_nc, he=False)}

    widths = [(enc_out, 16 * ndf), (16 * ndf, 16 * ndf), (16 * ndf, 16 * ndf),
              (16 * ndf, 8 * ndf), (8 * ndf, 4 * ndf), (4 * ndf, 2 * ndf),
              (2 * ndf, ndf)]
    dec: dict = {}
    for name, (fin, fout) in zip(("head", "rp_middle_0", "rp_middle_1",
                                  "d1", "d2", "d3", "d4"), widths):
        fmid = min(fin, fout)
        blk = {}
        if fin != fout:
            blk["conv_s"] = _conv_draw(rng, 1, fin, fout, bias=False)
            blk["norm_s"] = spade(fin)
        blk["conv_0"] = _conv_draw(rng, 3, fin, fmid)
        blk["norm_0"] = spade(fin)
        blk["conv_1"] = _conv_draw(rng, 3, fmid, fout)
        blk["norm_1"] = spade(fmid)
        dec[name] = blk
    dec["conv_img"] = _conv_draw(rng, 3, ndf, 3, he=False)
    tree["rp_decoder"] = dec
    return tree


def seg_adain_weights_from_seed(seed: int, rp_blocks: int = 5,
                                hidden_dim: int = 32,
                                seg_hidden_dim: int = 32,
                                class_num: int = 19) -> dict:
    """SegAdaINRP's ``params`` tree: ``adain_rp`` as
    ``rpseq_weights_from_seed(seed)`` draws it, then, from the same stream,
    the segmentation head ``seg_head/seg_head/block_{i}/PadConv_0/Conv_0``
    (the constant stack over the encoder's features, He-uniform)."""
    from .nn.blocks import (rp_constant_dims, rp_decrease_dims,
                            rp_increase_dims)
    rng = np.random.default_rng(seed)
    enc_out = hidden_dim * 2 ** (rp_blocks - 1)
    adain = {"encoder": _rpseq_draw(rng, rp_increase_dims(
                 rp_blocks, 3, hidden_dim, enc_out)),
             "decoder": _rpseq_draw(rng, rp_decrease_dims(
                 rp_blocks, enc_out, enc_out // 2, 3))}
    head = {f"block_{i}": {"PadConv_0": {"Conv_0": _conv_draw(rng, 3, cin,
                                                               cout)}}
            for i, (cin, cout) in enumerate(rp_constant_dims(
                rp_blocks, enc_out, seg_hidden_dim, class_num))}
    return {"adain_rp": adain, "seg_head": {"seg_head": head}}


def _sanet_tree(rng, psi_dims=None) -> dict:
    """The SANets' ``params`` tree drawn from ``rng`` in module order (see
    ``sanet_weights_from_seed``); ``psi_dims`` (relu4_1, relu5_1 style
    positions) adds each adaptive module's ``aea`` threshold MLP after its
    convs."""
    from .nn.decoder import MIRROR_DIMS

    def dense(cin, cout):
        lim = cin ** -0.5 if cin else 0.0
        return {"kernel": rng.uniform(-lim, lim, (cin, cout))
                .astype(np.float32),
                "bias": np.zeros(cout, np.float32)}

    transform = {}
    for i, name in enumerate(("sanet4_1", "sanet5_1")):
        transform[name] = {leaf: _conv_draw(rng, 1, 512, 512, he=False)
                           for leaf in ("f", "g", "h", "out_conv")}
        if psi_dims is not None:
            hw = psi_dims[i]
            transform[name]["aea"] = {"psi0": dense(hw, hw // 16),
                                      "psi1": dense(hw // 16, 1)}
    transform["merge_conv"] = {"Conv_0": _conv_draw(rng, 3, 512, 512)}
    decoder = {f"conv{i}": {"Conv_0": _conv_draw(rng, 3, cin, cout)}
               for i, (cin, cout) in enumerate(MIRROR_DIMS)}
    return {"transform": transform, "decoder": decoder}


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
    return _sanet_tree(np.random.default_rng(seed))


def dynamic_sanet_weights_from_seed(seed: int, img_size: int) -> dict:
    """The adaptive SANet's ``params`` tree at ``img_size``: the static
    one's draws, with each attention module's ``aea`` psi0 (HWs, HWs // 16)
    and psi1 (HWs // 16, 1) Dense kernels drawn after its convs, HWs =
    (img_size // 8) ** 2 at relu4_1 and (img_size // 16) ** 2 at relu5_1.
    The psi kernels are U(+-1/sqrt(fan_in)) with zero biases, rpst's
    ``_linear`` init (``sanet.py:37-43``)."""
    return _sanet_tree(np.random.default_rng(seed),
                       ((img_size // 8) ** 2, (img_size // 16) ** 2))


def src_weights_from_seed(seed: int) -> dict:
    """SourceNet's ``params`` tree (``decoder``: conv0 .. conv8, He-uniform
    kernels and U(+-1/sqrt(fan_in)) biases, as the SANets' decoder) drawn
    from ``numpy.random.default_rng(seed)``."""
    return {"decoder": _sanet_tree(np.random.default_rng(seed))["decoder"]}


def ld_weights_from_seed(network: str, seed: int, layer_num: int = 5,
                         hidden_dim: int = 16,
                         stylized_layers: int = 5) -> dict:
    """An LD network's ``params`` tree (``ld_adain`` .. ``ld_adain5``: per
    layer ``rp_enc{i}_small_revf`` then ``rp_enc{i}_big_revf``, then the
    decoder ``rp_dec{i}``, then v5's ``up_{i}``) drawn from
    ``numpy.random.default_rng(seed)`` in that order: He-uniform kernels
    U(+-sqrt(6 / fan_in)) and U(+-1/sqrt(fan_in)) biases for the convs, as
    ``rpseq_weights_from_seed`` draws, and the upsamplers' kernels normal
    with variance 1 / fan_in beside zero biases (flax's ``ConvTranspose``
    defaults)."""
    from .models.ld_adain import ld_decoder_dims, ld_widths
    variant = 1 if network == "ld_adain" else int(network[-1])
    rng = np.random.default_rng(seed)
    tree: dict = {}
    cin = 3
    for i, w in enumerate(ld_widths(variant, layer_num, hidden_dim)):
        tree[f"rp_enc{i}_small_revf"] = {
            "PadConv_0": {"Conv_0": _conv_draw(rng, 3, cin, w)}}
        if variant == 1:
            tree[f"rp_enc{i}_big_revf"] = {"PadConv_0": {
                "Conv_0": _conv_draw(rng, 3 if i == 0 else 7, cin, w)}}
        else:
            tree[f"rp_enc{i}_big_revf"] = {
                "conv1x1": _conv_draw(rng, 1, cin, w),
                "conv_a": {"Conv_0": _conv_draw(rng, 3, w, w)},
                "conv_b": {"Conv_0": _conv_draw(rng, 3, w, w)}}
        cin = 2 * w if variant in (1, 2) else w
    for i, (c_in, c_out) in enumerate(ld_decoder_dims(
            variant, layer_num, hidden_dim, stylized_layers)):
        tree[f"rp_dec{i}"] = {"PadConv_0": {"Conv_0": _conv_draw(
            rng, 3, c_in, c_out)}}
    if variant == 5:
        for i in range(layer_num):
            s = 2 ** (i + 1)
            tree[f"up_{i}"] = {
                "kernel": (rng.standard_normal((s, s, hidden_dim, hidden_dim))
                           * (s * s * hidden_dim) ** -0.5).astype(np.float32),
                "bias": np.zeros(hidden_dim, np.float32)}
    return tree


def weights_from_seed(cfg, seed: int = 0) -> dict:
    """The seeded ``params`` tree of ``cfg.network`` at the config's
    widths, as each family's fixtures draw it: adain / wct
    ``rpseq_weights_from_seed``, mrf, spade, seg_adain, src and the LD
    family their own draws."""
    n = cfg.network
    width = dict(rp_blocks=cfg.rp_blocks, hidden_dim=cfg.hidden_dim)
    if n in ("adain", "wct"):
        return rpseq_weights_from_seed(seed, **width)
    if n == "mrf":
        return mrf_weights_from_seed(seed, **width)
    if n == "spade":
        return spade_weights_from_seed(seed, ndf=cfg.ndf, **width)
    if n == "seg_adain":
        return seg_adain_weights_from_seed(
            seed, seg_hidden_dim=cfg.seg_hidden_dim,
            class_num=cfg.class_num, **width)
    if n == "src":
        return src_weights_from_seed(seed)
    if n.startswith("ld_adain"):
        return ld_weights_from_seed(n, seed, cfg.ld_layer_num,
                                    cfg.hidden_dim, cfg.stylized_layers)
    raise ValueError(f"no seeded draw for {n!r}")


def flax_weights_from_seed(model: torch.nn.Module, seed: int
                           ) -> Tuple[dict, dict]:
    """(params, batch_stats) flax trees for ``model``'s parameters and
    BatchNorm buffers, drawn from ``numpy.random.default_rng(seed)`` in the
    state_dict's order (so a machine without JAX rebuilds them; the
    slice-4-remainder fixture's models: deeper stacks, inception, SK,
    the Conv2dBlock norms and prelu): conv kernels (HWIO) He-uniform, conv
    and Linear biases U(+-1/sqrt(fan_in)), Linear kernels (in, out)
    U(+-1/sqrt(in)), BatchNorm scales U(0.5, 1.5), biases U(-0.2, 0.2),
    running means N(0, 0.2^2) and variances U(0.5, 1.5), a prelu slope
    U(0.1, 0.4), a CCAM scale U(0, 0.1). ``from_flax_params`` /
    ``from_flax_batch_stats`` of the two give the port's state_dict."""
    from .nn.attention import BatchNorm
    rng = np.random.default_rng(seed)
    bns = {name for name, m in model.named_modules()
           if isinstance(m, BatchNorm)}
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        for part in path[:-1]:
            tree = tree.setdefault(part, {})
        tree[path[-1]] = value.astype(np.float32)

    fan_in = {}
    for name, t in model.state_dict().items():
        stem, _, leaf = name.rpartition(".")
        path = stem.split(".") if stem else []
        shape = tuple(t.shape)
        if stem in bns:
            if leaf == "weight":
                put(params, path + ["scale"], rng.uniform(0.5, 1.5, shape))
            elif leaf == "bias":
                put(params, path + ["bias"], rng.uniform(-0.2, 0.2, shape))
            elif leaf == "running_mean":
                put(stats, path + ["mean"], rng.normal(0.0, 0.2, shape))
            elif leaf == "running_var":
                put(stats, path + ["var"], rng.uniform(0.5, 1.5, shape))
            continue
        if leaf == "weight" and len(shape) == 4:
            fan = int(np.prod(shape[1:]))
            lim = (6.0 / fan) ** 0.5
            fan_in[stem] = fan
            put(params, path + ["kernel"], rng.uniform(
                -lim, lim, shape).transpose(2, 3, 1, 0))
        elif leaf == "weight" and len(shape) == 2:
            fan_in[stem] = shape[1]
            lim = shape[1] ** -0.5
            put(params, path + ["kernel"], rng.uniform(-lim, lim, shape).T)
        elif leaf == "bias":
            lim = fan_in.get(stem, shape[0]) ** -0.5
            put(params, path + ["bias"], rng.uniform(-lim, lim, shape))
        elif leaf == "prelu_alpha":
            put(params, path + [leaf], np.asarray(rng.uniform(0.1, 0.4)))
        elif leaf == "scale":
            put(params, path + [leaf], rng.uniform(0.0, 0.1, shape))
        else:
            raise ValueError(f"no draw for {name!r}")
    return params, stats
