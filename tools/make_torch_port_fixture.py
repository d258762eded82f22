#!/usr/bin/env python
"""Write the JAX reference fixtures that hold the PyTorch port against rpst
on a machine that has no JAX (``chip_smoke.py``):

  * tests/fixtures/torch_port_flagship.npz: the flagship's folded stylize
    (serving);
  * tests/fixtures/torch_port_train.npz (``--train``): the flagship's folded
    training loss, its gradients and a 3-step loss trajectory;
  * tests/fixtures/torch_port_q8.npz (``--q8``): the flagship's int8 (q8)
    serving;
  * tests/fixtures/torch_port_adain.npz, torch_port_wct.npz (``--adain``,
    ``--wct``): adain's / wct's standard and int8 serving at full width;
  * tests/fixtures/torch_port_q8_targets.npz (``--q8-targets``): the int8
    VGG loss targets of ``train_q8_targets``;
  * tests/fixtures/torch_port_sanet.npz (``--sanet``): the static SANet's
    standard and int8 serving and its training loss and gradients;
  * tests/fixtures/torch_port_dynamic_sanet.npz, torch_port_src.npz
    (``--dynamic-sanet``, ``--src``): the same for the adaptive SANet and
    SourceNet.

The flagship is multi_adain with the constant stack at full width
(rp_blocks 5, hidden_dim 32, attention none), as bench.py builds it. The
file holds:
  * ``params/<flax path>``: the flax params from ``model.init`` at
    ``jax.random.PRNGKey(seed)``, as float32 numpy (HWIO kernels);
  * ``content``, ``style``: a (1, size, size, 3) pair from numpy's
    ``default_rng(seed)``;
  * ``out``: ``rpst.models.fast_path.stylize_multi_adain_folded`` on them in
    float32 (XLA ring path, jitted, run on the CPU).

The train fixture holds:
  * ``params/<flax path>``, ``content``, ``style`` as above, at batch 2;
  * ``vgg_seed``: the VGG is ``rpst_torch.bridge.vgg_weights_from_seed(
    vgg_seed)`` (numpy only, so it is stored as its seed), put into rpst's
    ``vgg_vars``;
  * ``content_loss``, ``style_loss``, ``total_loss`` and ``grads/<flax
    path>``: rpst's ``ModelBundle.loss`` and ``jax.value_and_grad`` at the
    first step, ``exec_strategy: folded`` in float32 (the XLA ring path on
    the CPU);
  * ``lr``, ``lr_decay`` and ``trajectory``: the total loss of each of 3
    steps of rpst's ``make_train_step`` (Adam, lr / (1 + decay (count+1)))
    on the same batch.

The q8 fixture holds:
  * ``params/<flax path>``, ``content``, ``style``: those of the flagship
    fixture;
  * ``act_scales``: rpst's ``calibrate_multi_adain_q8`` on (content, style);
  * ``out_f32``, ``out_bf16``: rpst's ``stylize_multi_adain_folded_q8`` with
    those scales, ``interpret=True`` on the CPU, at dtype float32 and
    bfloat16 (both stored as float32);
  * ``enc_q_<i>``, ``enc_scale_<i>``: the (int8, scale) encoder features of
    the content encode (rpst's ``_encode_q8`` with ``fuse_stats``, float32),
    and ``enc_mean_<i>``, ``enc_std_<i>`` for the layers whose statistics
    come from the kernel sums (``_stats_from_sums``).

The adain and wct fixtures (rp_blocks 5, hidden_dim 32, batch 2) hold:
  * ``weights_seed``: the params are ``rpst_torch.bridge.
    rpseq_weights_from_seed(weights_seed)`` (numpy only; 12 MB of weights
    stored as their seed), put into rpst's flax ``params``;
  * ``content``, ``style``; ``out_f32``: the flax model's float32 forward;
  * ``act_scales``: rpst's ``calibrate_adain_q8`` / ``calibrate_wct_q8``;
  * ``out_q8_f32``, ``out_q8_bf16``: rpst's ``stylize_adain_q8`` /
    ``stylize_wct_q8`` with those scales, ``interpret=True``.

The q8-targets fixture (batch 4) holds:
  * ``vgg_seed``, ``content``, ``style`` and ``stylized`` (a third random
    image batch standing for the model's output);
  * ``act_scales``: rpst's ``calibrate_vgg_targets_q8``;
  * ``tap_2``, ``tap_3``: relu3_1 and relu4_1 of the 2N (style, content)
    batch from rpst's ``vgg_target_taps_q8`` (float32, ``interpret=True``,
    the Pallas engine), the two taps behind the six int8 layers;
    ``tap_mean_<i>``, ``tap_std_<i>``: the instance statistics of all four;
  * ``style_loss``, ``content_loss``, ``total_loss``: rpst's
    ``perceptual_rp_losses_q8targets`` (float32, weights 1 and 2).

The sanet fixture (batch 2, the model's fixed width of 512) holds:
  * ``weights_seed``, ``vgg_seed``: the params are ``rpst_torch.bridge.
    sanet_weights_from_seed(weights_seed)`` and the 5-stage VGG
    ``vgg_weights_from_seed(vgg_seed, 5)`` (numpy only; ~30 MB and ~50 MB
    stored as their seeds); ``content``, ``style``;
  * ``out_f32``: rpst's ``ModelBundle.stylize`` in float32 (on the CPU its
    attention takes the dense route);
  * ``act_scales``, ``out_q8_f32``, ``out_q8_bf16``: rpst's
    ``calibrate_sanet_q8`` and ``stylize_sanet_q8`` (``interpret=True``);
  * ``content_loss``, ``style_loss``, ``l_identity1_loss``,
    ``l_identity2_loss``, ``total_loss``: rpst's ``ModelBundle.loss`` with
    ``configs/train_static_sanet.yaml``'s weights (1, 3, 50, 1), and from
    its ``jax.value_and_grad``: ``gradnorm/<flax path>`` (the norm of every
    leaf's gradient), ``grads/<flax path>`` for every bias in full, and
    ``gradpatch/<flax path>``, the [..., :8, :8] corner of every kernel's.

The dynamic_sanet fixture (batch 2, the model's fixed width of 512,
``configs/train_dynamic_sanet.yaml``'s ``ada_module: relu`` and loss
weights) holds the sanet fixture's keys, with the params from
``rpst_torch.bridge.dynamic_sanet_weights_from_seed(weights_seed, size)``
(psi0 / psi1 under ``transform/sanet{4,5}_1/aea``), and:
  * ``out_f32`` on rpst's dense route (``adaptive_blockwise: never``, what
    the CPU takes under ``auto``), ``out_f32_always`` on its streamed route,
    ``out_f32_aea``: the same weights with ``ada_module: aea``, dense;
  * ``aux/<relu4_1|relu5_1>/<claim_value|claim_before|claim_after>``:
    rpst's ``ModelBundle.stylize_with_aux``;
  * ``q8_tap_3``, ``q8_tap_4``: relu4_1 and relu5_1 of the 2N (content,
    style) batch from rpst's int8 VGG encode in float32 (interpret mode),
    the inputs of the q8 stylize's transform.

The src fixture (batch 2, ``use_mask`` off, loss weights 1 and 2) holds
``weights_seed`` (``src_weights_from_seed``), ``vgg_seed`` (a 4-stage
VGG), ``content``, ``style``, ``out_f32``, ``act_scales``, ``out_q8_f32``,
``out_q8_bf16`` (rpst's ``calibrate_src_q8`` / ``stylize_src_q8``),
``style_loss``, ``content_loss``, ``total_loss`` and the gradient keys of
the sanet fixture.

The sel_multi_adain, ccam and mst fixtures (``--sel-multi-adain``,
``--ccam``, ``--mst``: the flagship's stack at full width, rp_blocks 5,
hidden_dim 32, 64px, batch 2; ccam and mst at their yamls' stylized_layers
5 and 1, ``shuffle`` off, loss weights 1 and 2) hold:
  * ``params/<flax path>`` from ``model.init`` at ``PRNGKey(seed)``, the
    RP stacks' kernels redrawn He-uniform from numpy (``_he_stacks``: the
    default init shrinks the signal under AdaIN's eps), ccam's five
    ``scale`` set to 0.3 .. 0.7 (they start at 0, which would hide the
    attention) and sel_multi_adain's BatchNorm scale / bias drawn from
    numpy, and ``batch_stats/<path>`` (sel_multi_adain: one train-mode
    apply's);
  * ``content``, ``style``, ``vgg_seed``;
  * ``out_folded``, ``out_folded_bf16``: rpst's folded stylize in float32
    and bfloat16 (stored float32); ``out_std``: the standard module's
    (test mode); ccam's ``out_std_shuffle``: with ``shuffle: true``;
  * ``content_loss``, ``style_loss``, ``total_loss``, ``grads/<path>``:
    rpst's folded float32 ``ModelBundle.loss`` and ``jax.value_and_grad``;
    ``grads_std/<path>``: the standard path's, and ``grads_f64/<path>``:
    the standard path's in float64 (``slice4_grads_f64``; rpst's float32
    gradients sit up to ~2.5e-2 of a tensor's max from each other and from
    these for sel_multi_adain and ccam at this size, the error the port's
    gradients are held to);
    sel_multi_adain's ``stats_after/<path>``: the loss's updated
    ``batch_stats``; ``lr``, ``lr_decay``, ``trajectory``,
    ``trajectory_std``: 3 steps of ``make_train_step``, folded and
    standard (Adam's first steps move each weight by about lr whatever its
    gradient's size, so float32 noise in a small gradient moves the
    trajectory: the two paths' spread is what it can be held to);
  * ``act_scales``, ``out_q8_f32``, ``out_q8_bf16``: rpst's calibration and
    int8 folded stylize (``interpret=True``);
  * mst's ``s_labels``, ``c_labels``, ``label_gap``: the deepest scale's
    k-means labels of the style channels and the matched cluster of each
    content channel per sample, and the smallest margin between a
    channel's nearest and second-nearest center over both (squared
    distance for k-means, cosine distance for the match, each relative to
    its scale): labels can flip only below it.

The target-cache fixture (``--target-cache``) holds, on the train
fixture's params, content, style and VGG: ``t_mean_<i>``, ``t_std_<i>``,
``t_relu4``: rpst's ``vgg_perceptual_stats`` of the (style, content) batch
(the targets ``DeviceTargetCache`` stores), and ``content_loss``,
``style_loss``, ``total_loss``, ``grads/<path>``: rpst's folded loss and
gradients with those targets given (``ModelBundle.loss(targets=...)``).

The slice-5b fixtures (``--mrf``, ``--spade``, ``--seg-adain``,
``--wct-train``; 64px, batch 2, full width: rp_blocks 5, hidden_dim 32;
spade's condition 512 channels, ndf 2, the instance norm; seg_adain's head
32 wide over 19 classes; loss weights content 1, style 2, mrf 1, seg 1),
and the adain training fixture (``--adain-train``: the same keys as
wct_train's, without the freeze, at the widths of
``configs/train_deeper_rp_adain.yaml``: rp_blocks 5, hidden_dim 16)
hold:
  * ``weights_seed``: the params are ``rpst_torch.bridge.
    {mrf,spade,seg_adain}_weights_from_seed(weights_seed)`` (wct:
    ``rpseq_weights_from_seed``), numpy only, 30-40 MB stored as their seed;
    ``vgg_seed``, ``content``, ``style``, ``lr``, ``lr_decay``; seg_adain's
    ``label`` (2, 64, 64) int32 train ids in -1 .. 18;
  * ``out_f32``, ``out_bf16`` (not wct): rpst's ``ModelBundle.stylize`` in
    float32 and at compute_dtype bfloat16 (stored float32);
  * ``act_scales``, ``out_q8_f32``, ``out_q8_bf16`` (not wct): rpst's
    calibration and int8 stylize (``interpret=True``);
  * the loss parts (``mrf_loss``, ``seg_loss`` where the network has them)
    and, from ``jax.value_and_grad`` of ``ModelBundle.loss`` (seg_adain
    with the labels), ``gradnorm/<path>``, ``grads/<path>`` for every bias
    and ``gradpatch/<path>`` (the [..., :8, :8] corner) for every kernel,
    the same three under ``f64/`` from rpst's float64 loss at the same
    point (the gradient's own float32 error; stored as float32);
  * ``trajectory``: the total loss of 3 steps of rpst's ``make_train_step``
    (seg_adain ``with_labels``; wct with ``make_optimizer(cfg,
    ("encoder",))``, the resume's freeze) on the same batch.

The LD fixtures (``--ld`` writes all five, ``--ld-adain`` ..
``--ld-adain5`` one; 32px, the smallest size at which v5's 32x upsampler
lines up, batch 2, the yamls' widths: hidden 16 for v1, 8 for v2, 32 for
v3-v5, 5 layers, all 5 stylized, ``use_mask`` off, loss weights content 1,
style 2, lr 1e-4) hold the slice-5b fixtures' keys (the ``f64/`` gradients
with rpst's feature statistics in float64 too: ``ld_f64_stats``), the params
``rpst_torch.bridge.ld_weights_from_seed(network, weights_seed, ...)``,
``act_scales``, ``out_q8_f32`` and ``out_q8_bf16`` for v1 and v2 only
(rpst's ``calibrate_ld_q8`` / ``stylize_ld_q8`` and ``calibrate_ld2_q8`` /
``stylize_ld2_q8`` with ``conv_impl='pallas'``, the 3x3 convs on the
standard-layout kernel in interpret mode and v1's 7x7 convs on its
compiler's int8 conv), and the int8 features at the first eligible layer of
the q8 f32 pass, for the first image of the 2N batch: v1's ``q8_in`` (the
layer-3 input quantized with ``act_scales[0]``) and ``q8_out`` (the int8
concat of its 3x3 small and 7x7 big branch, requantized with
``act_scales[1]``); v2's ``q8_in`` (conv_a's input, the 1x1 head's output
quantized with ``act_scales[1]``) and ``q8_out`` (conv_a's int8 output at
``act_scales[2]``).

The masks fixture (``--masks``: tests/fixtures/torch_port_masks.npz; 64px,
batch 2, one (content, style) batch and one pair of label maps per sample
from ``tools/make_photoreal_set.label_maps``, which exercise the four
cases of the masked AdaIN's filter) holds, for each case of ``MASKS`` (the
flagship yaml's multi_adain at full width with ``attention: se`` and
``use_mask``, and the same with ``sort`` (``multi_adain_sort``); ccam, sel_multi_adain, src, seg_adain and LD v1 with
``use_mask`` at a small width):
  * ``content``, ``style``, ``c_labels``, ``s_labels`` (int32), ``vgg_seed``;
  * ``<case>/config``: the case's config keys as a JSON string;
  * ``<case>/params/<path>`` and ``<case>/batch_stats/<path>`` (the SE
    BatchNorms' running statistics drawn from numpy, their scales and
    biases too; the RP stacks He-uniform, ``_he_stacks``; ccam's scales
    0.3 .. 0.7), or ``<case>/weights_seed`` where the port's ``bridge``
    draws the params (src, seg_adain, LD v1);
  * ``<case>/out_f32``, ``<case>/out_bf16``: rpst's ``ModelBundle.stylize``
    with the labels in float32 and at compute_dtype bfloat16 (stored
    float32); ``<case>/out_nomask``: float32 without labels;
  * for ``multi_adain``: ``<case>/content_loss``, ``style_loss``,
    ``total_loss`` and ``<case>/grads/<path>`` of rpst's float32
    ``ModelBundle.loss`` (the standard path in train mode: the SE
    BatchNorms on batch statistics), ``<case>/stats_after/<path>``, its
    moved running statistics, and ``<case>/grads_f64/<path>``, the same
    gradients in float64 (``masks_grads_f64``).

Usage:
  python tools/make_torch_port_fixture.py --masks
  python tools/make_torch_port_fixture.py --mrf | --spade | --seg-adain
      | --wct-train | --adain-train
  python tools/make_torch_port_fixture.py --ld | --ld-adain | ... |
      --ld-adain5
  python tools/make_torch_port_fixture.py --adain | --wct | --q8-targets
  python tools/make_torch_port_fixture.py --sanet | --dynamic-sanet | --src
  python tools/make_torch_port_fixture.py --sel-multi-adain | --ccam | --mst
      [--grads-f64]
  python tools/make_torch_port_fixture.py --target-cache
  python tools/make_torch_port_fixture.py [--seed 0] [--size 64] [dst.npz]
  python tools/make_torch_port_fixture.py --train [--seed 0] [--size 64] [dst]
  python tools/make_torch_port_fixture.py --q8 [--seed 0] [--size 64] [dst]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

DEFAULT_DST = REPO / "tests" / "fixtures" / "torch_port_flagship.npz"
TRAIN_DST = REPO / "tests" / "fixtures" / "torch_port_train.npz"
Q8_DST = REPO / "tests" / "fixtures" / "torch_port_q8.npz"
RPSEQ_DST = {n: REPO / "tests" / "fixtures" / f"torch_port_{n}.npz"
             for n in ("adain", "wct")}
Q8_TARGETS_DST = REPO / "tests" / "fixtures" / "torch_port_q8_targets.npz"
SANET_DST = REPO / "tests" / "fixtures" / "torch_port_sanet.npz"
SANET = dict(network="sanet", content_weight=1.0, style_weight=3.0,
             l_identity1_weight=50.0, l_identity2_weight=1.0)
DYNAMIC_SANET_DST = (REPO / "tests" / "fixtures"
                     / "torch_port_dynamic_sanet.npz")
DYNAMIC_SANET = dict(SANET, network="dynamic_sanet", ada_module="relu")
SRC_DST = REPO / "tests" / "fixtures" / "torch_port_src.npz"
SRC = dict(network="src", use_mask=False, content_weight=1.0,
           style_weight=2.0)
WIDE = dict(rp_blocks=5, hidden_dim=32)
TRAIN = dict(batch=2, vgg_seed=1, lr=1e-3, lr_decay=0.5, steps=3)
FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=5,
                hidden_dim=32, inception_num=0, attention="none")
SLICE4 = {"sel_multi_adain": dict(FLAGSHIP, network="sel_multi_adain"),
          "ccam": dict(FLAGSHIP, network="ccam", stylized_layers=5,
                       shuffle=False, shuffle_layers=1),
          "mst": dict(FLAGSHIP, network="mst", stylized_layers=1,
                      n_clusters=3, mst_lambda=0.0)}
SLICE4_DST = {n: REPO / "tests" / "fixtures" / f"torch_port_{n}.npz"
              for n in SLICE4}
SLICE4_LOSS = dict(content_weight=1.0, style_weight=2.0)
CCAM_SCALES = (0.3, 0.4, 0.5, 0.6, 0.7)
TARGET_CACHE_DST = REPO / "tests" / "fixtures" / "torch_port_target_cache.npz"
# the slice-5b networks' fixture configs (full width, the loss weights the
# fixtures' parts and gradients are taken at)
SLICE5B = {
    "mrf": dict(WIDE, network="mrf", k=5, mrf_chunk=0, mrf_weight=1.0),
    "spade": dict(WIDE, network="spade", ndf=2, spade_norm="instance"),
    "seg_adain": dict(WIDE, network="seg_adain", seg_hidden_dim=32,
                      class_num=19, seg_loss_weight=1.0),
    "wct_train": dict(WIDE, network="wct"),
    # configs/train_deeper_rp_adain.yaml's widths
    "adain_train": dict(network="adain", rp_blocks=5, hidden_dim=16)}
# the LD family at its yamls' widths (configs/train_ld*_rp_adain.yaml)
LD = ("ld_adain", "ld_adain2", "ld_adain3", "ld_adain4", "ld_adain5")
LD_HIDDEN = {"ld_adain": 16, "ld_adain2": 8}
SLICE5B.update({n: dict(network=n, rp_blocks=5, ld_layer_num=5,
                        stylized_layers=5, hidden_dim=LD_HIDDEN.get(n, 32),
                        inception_num=0, use_mask=False) for n in LD})
# the LD fixtures' learning rate: configs/train_ld4_multiscale_rp_adain.yaml's
# (at TRAIN's 1e-3 the seeded LD v1's third loss moves 5% between the port's
# own float32 and float64 runs: a trajectory float32 cannot pin)
LD_LR = 1e-4
LD_SIZE = 32
MASKS_DST = REPO / "tests" / "fixtures" / "torch_port_masks.npz"
SMALL = dict(rp_blocks=3, hidden_dim=16)
# the masks fixture's cases: the flagship yaml's settings at full width,
# the others narrow (``use_mask`` on for all; the labels reach seg_adain's
# stylize, which reads none of them, as rpst's)
MASKS = {
    "multi_adain": dict(FLAGSHIP, attention="se", sort=False, shuffle=False,
                        use_mask=True, content_weight=1.0, style_weight=1.0),
    "multi_adain_sort": dict(FLAGSHIP, attention="se", sort=True,
                             shuffle=False, use_mask=True),
    "ccam": dict(SMALL, network="ccam", stylized_layers=3, shuffle=False,
                 use_mask=True),
    "sel_multi_adain": dict(SMALL, network="sel_multi_adain", use_mask=True),
    "src": dict(network="src", use_mask=True),
    "seg_adain": dict(SMALL, network="seg_adain", seg_hidden_dim=16,
                      class_num=19, use_mask=True),
    "ld_adain": dict(network="ld_adain", rp_blocks=3, ld_layer_num=3,
                     stylized_layers=3, hidden_dim=8, inception_num=0,
                     use_mask=True)}
SLICE5B_LOSS = dict(content_weight=1.0, style_weight=2.0)
SLICE5B_DST = {n: REPO / "tests" / "fixtures" / f"torch_port_{n}.npz"
               for n in SLICE5B}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def make_fixture(seed: int = 0, size: int = 64) -> dict:
    """The fixture's arrays, computed afresh with JAX on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst.models.fast_path import stylize_multi_adain_folded

    rng = np.random.default_rng(seed)
    content = rng.random((1, size, size, 3), dtype=np.float32)
    style = rng.random((1, size, size, 3), dtype=np.float32)
    bundle = build_model(load_config(dict(FLAGSHIP, img_size=size)))
    params = jax.jit(bundle.model.init)(
        jax.random.PRNGKey(seed), jnp.asarray(content),
        jnp.asarray(style))["params"]
    stylize = jax.jit(lambda p, c, s: stylize_multi_adain_folded(
        p, c, s, dtype=jnp.float32, use_pallas=False))
    out = stylize(params, jnp.asarray(content), jnp.asarray(style))
    arrays = {f"params/{k}": np.asarray(v, np.float32)
              for k, v in _flat(params)}
    arrays.update(content=content, style=style,
                  out=np.asarray(out, np.float32))
    return arrays


def make_train_fixture(seed: int = 0, size: int = 64) -> dict:
    """The train fixture's arrays, computed afresh with JAX on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst.train.step import TrainState, make_optimizer, make_train_step
    from rpst_torch.bridge import vgg_weights_from_seed

    rng = np.random.default_rng(seed)
    shape = (TRAIN["batch"], size, size, 3)
    content = rng.random(shape, dtype=np.float32)
    style = rng.random(shape, dtype=np.float32)
    cfg = load_config(dict(FLAGSHIP, img_size=size, exec_strategy="folded",
                           lr=TRAIN["lr"], lr_decay=TRAIN["lr_decay"]))
    bundle = build_model(cfg)
    c, s = jnp.asarray(content), jnp.asarray(style)
    params = jax.jit(bundle.model.init)(jax.random.PRNGKey(seed), c[:1],
                                        s[:1])["params"]
    vgg_vars = jax.tree.map(jnp.asarray,
                            vgg_weights_from_seed(TRAIN["vgg_seed"]))

    def loss_fn(p):
        total, (parts, _) = bundle.loss({"params": p}, vgg_vars, c, s,
                                        train=True)
        return total, parts

    (_, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    # the step donates its state: copy the params out first
    arrays = {f"params/{k}": np.asarray(v, np.float32).copy()
              for k, v in _flat(params)}
    tx = make_optimizer(cfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       extra={}, opt_state=tx.init(params),
                       rng=jax.random.PRNGKey(seed))
    step = make_train_step(bundle, tx)
    trajectory = []
    for _ in range(TRAIN["steps"]):
        state, step_parts = step(state, vgg_vars, c, s)
        trajectory.append(float(step_parts["total_loss"]))
    arrays.update({f"grads/{k}": np.asarray(v, np.float32)
                   for k, v in _flat(grads)})
    arrays.update({k: np.float32(parts[k]) for k in
                   ("content_loss", "style_loss", "total_loss")})
    arrays.update(content=content, style=style,
                  vgg_seed=np.int64(TRAIN["vgg_seed"]),
                  lr=np.float32(TRAIN["lr"]),
                  lr_decay=np.float32(TRAIN["lr_decay"]),
                  trajectory=np.asarray(trajectory, np.float32))
    return arrays


def make_q8_fixture(seed: int = 0, size: int = 64) -> dict:
    """The q8 fixture's arrays, computed afresh with JAX on the CPU (rpst's
    int8 kernels in interpret mode)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.models import fast_path_q8 as q8
    from rpst.models.fast_path import _folded_blocks

    arrays = make_fixture(seed, size)
    arrays.pop("out")
    params = _unflat({k[len("params/"):]: v for k, v in arrays.items()
                      if k.startswith("params/")})
    c, s = jnp.asarray(arrays["content"]), jnp.asarray(arrays["style"])
    scales = q8.calibrate_multi_adain_q8(params, c, s)
    arrays["act_scales"] = np.asarray(scales["act_scales"], np.float32)
    for name, dt in (("out_f32", jnp.float32), ("out_bf16", jnp.bfloat16)):
        out = q8.stylize_multi_adain_folded_q8(params, scales, c, s,
                                               dtype=dt, interpret=True)
        arrays[name] = np.asarray(out, np.float32)
    enc = _folded_blocks(params["rp_shared_encoder"])
    it = iter(range(len(arrays["act_scales"])))
    conv_q = q8._make_conv_q(jnp.float32, 16, True)
    feats, stats = q8._encode_q8(enc, arrays["act_scales"], it, c,
                                 jnp.float32, conv_q, fuse_stats=True)
    for i, ((q, scale), st) in enumerate(zip(feats, stats)):
        arrays[f"enc_q_{i}"] = np.asarray(q, np.int8)
        arrays[f"enc_scale_{i}"] = np.float32(scale)
        if st is not None:
            arrays[f"enc_mean_{i}"] = np.asarray(st[0], np.float32)
            arrays[f"enc_std_{i}"] = np.asarray(st[1], np.float32)
    jax.block_until_ready(arrays["out_f32"])
    return arrays


def make_rpseq_fixture(network: str, seed: int = 0, size: int = 64) -> dict:
    """The adain / wct fixture's arrays, computed afresh with JAX on the
    CPU (rpst's int8 kernel in interpret mode)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst.models import fast_path_q8 as q8
    from rpst_torch.bridge import rpseq_weights_from_seed

    rng = np.random.default_rng(seed)
    content = rng.random((2, size, size, 3), dtype=np.float32)
    style = rng.random((2, size, size, 3), dtype=np.float32)
    params = jax.tree.map(jnp.asarray, rpseq_weights_from_seed(seed, **WIDE))
    bundle = build_model(load_config(dict(WIDE, network=network,
                                          img_size=size)))
    c, s = jnp.asarray(content), jnp.asarray(style)
    out = jax.jit(lambda p, a, b: bundle.model.apply(
        {"params": p}, a, b, train=False))(params, c, s)
    calibrate, stylize = {
        "adain": (q8.calibrate_adain_q8, q8.stylize_adain_q8),
        "wct": (q8.calibrate_wct_q8, q8.stylize_wct_q8)}[network]
    scales = calibrate(params, c, s)
    arrays = dict(weights_seed=np.int64(seed), content=content, style=style,
                  out_f32=np.asarray(out, np.float32),
                  act_scales=np.asarray(scales["act_scales"], np.float32))
    for name, dt in (("out_q8_f32", jnp.float32),
                     ("out_q8_bf16", jnp.bfloat16)):
        arrays[name] = np.asarray(stylize(params, scales, c, s, dtype=dt,
                                          interpret=True), np.float32)
    return arrays


def make_q8_targets_fixture(seed: int = 0, size: int = 64) -> dict:
    """The q8-targets fixture's arrays, computed afresh with JAX on the CPU
    (rpst's int8 kernel in interpret mode)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.models import fast_path_q8 as q8
    from rpst.nn.vgg_folded import perceptual_rp_losses_q8targets
    from rpst.ops.stats import calc_mean_std
    from rpst_torch.bridge import vgg_weights_from_seed

    rng = np.random.default_rng(seed)
    content, style, stylized = (rng.random((4, size, size, 3),
                                           dtype=np.float32)
                                for _ in range(3))
    vgg_vars = jax.tree.map(jnp.asarray,
                            vgg_weights_from_seed(TRAIN["vgg_seed"]))
    c, s, x = (jnp.asarray(a) for a in (content, style, stylized))
    scales = q8.calibrate_vgg_targets_q8(vgg_vars, c, s)
    taps = q8.vgg_target_taps_q8(vgg_vars, scales,
                                 jnp.concatenate([s, c], axis=0), jnp.float32,
                                 interpret=True, conv_impl="pallas")
    parts, total = perceptual_rp_losses_q8targets(
        vgg_vars, scales, x, s, c, 1.0, 2.0, dtype=jnp.float32,
        interpret=True)
    arrays = dict(vgg_seed=np.int64(TRAIN["vgg_seed"]), content=content,
                  style=style, stylized=stylized,
                  act_scales=np.asarray(scales["act_scales"], np.float32),
                  tap_2=np.asarray(taps[2], np.float32),
                  tap_3=np.asarray(taps[3], np.float32),
                  style_loss=np.float32(parts["style_loss"]),
                  content_loss=np.float32(parts["content_loss"]),
                  total_loss=np.float32(total))
    for i, t in enumerate(taps):
        m, sd = calc_mean_std(t.astype(jnp.float32))
        arrays[f"tap_mean_{i}"] = np.asarray(m[:, 0, 0, :], np.float32)
        arrays[f"tap_std_{i}"] = np.asarray(sd[:, 0, 0, :], np.float32)
    return arrays


def _loss_and_grads(bundle, vgg_vars, params, c, s, arrays):
    """rpst's loss parts and, from its ``jax.value_and_grad``, every leaf's
    gradient norm, every bias's gradient in full and the [..., :8, :8]
    corner of every kernel's, into ``arrays``."""
    import jax
    import numpy as np

    def loss_fn(p):
        total, (parts, _) = bundle.loss({"params": p}, vgg_vars, c, s,
                                        train=True)
        return total, parts

    (_, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    arrays.update({k: np.float32(v) for k, v in parts.items()})
    for k, v in _flat(grads):
        g = np.asarray(v, np.float32)
        arrays[f"gradnorm/{k}"] = np.float32(np.linalg.norm(g))
        if k.endswith("bias"):
            arrays[f"grads/{k}"] = g
        else:
            arrays[f"gradpatch/{k}"] = g[..., :8, :8].copy()


def _feature_fixture(cfg: dict, params, num_stages: int, seed: int,
                     size: int, q8_pair):
    """(bundle, vgg_vars, c, s, arrays) with the stylize, the int8 stylize
    (``q8_pair`` = (calibrate, stylize), interpret mode) and the loss of a
    feature model, computed afresh with JAX on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst_torch.bridge import vgg_weights_from_seed

    rng = np.random.default_rng(seed)
    content = rng.random((2, size, size, 3), dtype=np.float32)
    style = rng.random((2, size, size, 3), dtype=np.float32)
    params = jax.tree.map(jnp.asarray, params)
    vgg_vars = jax.tree.map(jnp.asarray, vgg_weights_from_seed(
        TRAIN["vgg_seed"], num_stages))
    bundle = build_model(load_config(dict(cfg, img_size=size)))
    c, s = jnp.asarray(content), jnp.asarray(style)
    out = jax.jit(bundle.stylize)({"params": params}, vgg_vars, c, s)
    calibrate, stylize = q8_pair
    scales = calibrate(params, vgg_vars, c, s)
    arrays = dict(weights_seed=np.int64(seed),
                  vgg_seed=np.int64(TRAIN["vgg_seed"]), content=content,
                  style=style, out_f32=np.asarray(out, np.float32),
                  act_scales=np.asarray(scales["act_scales"], np.float32))
    for name, dt in (("out_q8_f32", jnp.float32),
                     ("out_q8_bf16", jnp.bfloat16)):
        arrays[name] = np.asarray(stylize(params, vgg_vars, scales, c, s, dt),
                                  np.float32)
    _loss_and_grads(bundle, vgg_vars, params, c, s, arrays)
    return bundle, vgg_vars, c, s, arrays


def make_sanet_fixture(seed: int = 0, size: int = 64) -> dict:
    """The sanet fixture's arrays, computed afresh with JAX on the CPU
    (rpst's int8 kernel in interpret mode)."""
    from rpst.models import fast_path_q8 as q8
    from rpst_torch.bridge import sanet_weights_from_seed

    def calibrate(p, vgg_vars, c, s):
        return q8.calibrate_sanet_q8({"params": p}, vgg_vars, c, s)

    def stylize(p, vgg_vars, scales, c, s, dt):
        return q8.stylize_sanet_q8({"params": p}, vgg_vars, scales, c, s,
                                   dtype=dt, interpret=True)

    return _feature_fixture(SANET, sanet_weights_from_seed(seed), 5, seed,
                            size, (calibrate, stylize))[-1]


def make_dynamic_sanet_fixture(seed: int = 0, size: int = 64) -> dict:
    """The dynamic_sanet fixture's arrays (``ada_module: relu``; rpst's
    int8 kernel in interpret mode, the attention on its dense route)."""
    import jax
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst.models import fast_path_q8 as q8
    from rpst_torch.bridge import dynamic_sanet_weights_from_seed

    ada = dict(adaptive=True, ada_module=DYNAMIC_SANET["ada_module"])

    def calibrate(p, vgg_vars, c, s):
        return q8.calibrate_sanet_q8({"params": p}, vgg_vars, c, s, **ada)

    def stylize(p, vgg_vars, scales, c, s, dt):
        return q8.stylize_sanet_q8({"params": p}, vgg_vars, scales, c, s,
                                   dtype=dt, interpret=True, **ada)

    bundle, vgg_vars, c, s, arrays = _feature_fixture(
        dict(DYNAMIC_SANET, adaptive_blockwise="never"),
        dynamic_sanet_weights_from_seed(seed, size), 5, seed, size,
        (calibrate, stylize))
    variables = {"params": jax.tree.map(
        jax.numpy.asarray, dynamic_sanet_weights_from_seed(seed, size))}
    for key, over in (("out_f32_always", dict(adaptive_blockwise="always")),
                      ("out_f32_aea", dict(adaptive_blockwise="never",
                                           ada_module="aea"))):
        other = build_model(load_config(dict(DYNAMIC_SANET, img_size=size,
                                             **over)))
        arrays[key] = np.asarray(jax.jit(other.stylize)(variables, vgg_vars,
                                                        c, s), np.float32)
    _, aux = jax.jit(bundle.stylize_with_aux)(variables, vgg_vars, c, s)
    for layer, maps in aux.items():
        for name, v in maps.items():
            arrays[f"aux/{layer}/{name}"] = np.asarray(v, np.float32)
    # the int8 encode's relu4_1 / relu5_1 taps of the float32 q8 stylize
    # (2N batch), the adaptive transform's inputs
    taps = q8._vgg_encode_q8(
        vgg_vars["params"], jax.numpy.concatenate([c, s]), 5,
        jax.numpy.float32,
        q8._make_conv_q_std(jax.numpy.float32, 16, True, "reflect"),
        q8._ScaleStream(arrays["act_scales"]))
    for i in (3, 4):
        arrays[f"q8_tap_{i}"] = np.asarray(taps[i], np.float32)
    return arrays


def make_src_fixture(seed: int = 0, size: int = 64) -> dict:
    """The src fixture's arrays (rpst's int8 kernel in interpret mode),
    with rpst's float64 readings (``src_f64_readings``)."""
    from rpst.models import fast_path_q8 as q8
    from rpst_torch.bridge import src_weights_from_seed

    def stylize(p, vgg_vars, scales, c, s, dt):
        return q8.stylize_src_q8(p, vgg_vars, scales, c, s, dtype=dt,
                                 interpret=True)

    arrays = _feature_fixture(SRC, src_weights_from_seed(seed), 4, seed,
                              size, (q8.calibrate_src_q8, stylize))[-1]
    arrays.update(src_f64_readings(arrays))
    return arrays


def mst_labels(cf, sf, n_clusters: int = 3):
    """rpst's MST labels of one sample's (H, W, C) features: the k-means
    labels of the style channels, the matched cluster of each content
    channel (lambda 0: the argmin), and the smallest relative margin
    between a channel's nearest and second-nearest choice."""
    import jax.numpy as jnp
    import numpy as np

    from rpst.ops.kmeans import _pairwise_sq_dist, kmeans

    c = cf.shape[-1]
    s_ch = jnp.asarray(sf, jnp.float32).reshape(-1, c).T
    c_ch = jnp.asarray(cf, jnp.float32).reshape(-1, c).T
    s_labels, centers = kmeans(s_ch, n_clusters)
    d_s = np.sort(np.asarray(_pairwise_sq_dist(s_ch, centers)), axis=1)
    dots = c_ch @ centers.T
    norm = (jnp.linalg.norm(c_ch, axis=1, keepdims=True)
            @ jnp.linalg.norm(centers, axis=1, keepdims=True).T)
    d_c = np.asarray(1.0 - dots / jnp.maximum(norm, 1e-12))
    c_labels = d_c.argmin(axis=1)
    d_c = np.sort(d_c, axis=1)
    gap = min(float(((d_s[:, 1] - d_s[:, 0]) / d_s[:, 1].max()).min()),
              float(((d_c[:, 1] - d_c[:, 0])
                     / max(float(np.abs(d_c).max()), 1e-12)).min()))
    return (np.asarray(s_labels, np.int32), c_labels.astype(np.int32), gap)


def _he_stacks(ms: dict, rng) -> dict:
    """The RP stacks' kernels drawn He-uniform, U(+-sqrt(6 / fan_in)), and
    biases U(+-1/sqrt(fan_in)) from ``rng`` (block order, encoder first):
    with ``model.init``'s PyTorch-default kernels the encoder's signal
    shrinks ~2.5x a layer, to a deepest std of ~9e-4, under AdaIN's eps,
    where the float32 gradients of both frameworks sit up to 2e-2 of their
    max from the float64 ones."""
    import numpy as np
    out = {}
    for stack in ("rp_shared_encoder", "rp_decoder"):
        out[stack] = {}
        for blk in sorted(ms[stack], key=lambda b: int(b.split("_")[1])):
            kernel = ms[stack][blk]["PadConv_0"]["Conv_0"]["kernel"]
            fan_in = int(np.prod(kernel.shape[:3]))
            he, lim = (6.0 / fan_in) ** 0.5, fan_in ** -0.5
            out[stack][blk] = {"PadConv_0": {"Conv_0": {
                "kernel": rng.uniform(-he, he, kernel.shape)
                .astype(np.float32),
                "bias": rng.uniform(-lim, lim, kernel.shape[3])
                .astype(np.float32)}}}
    return out


def make_slice4_fixture(network: str, seed: int = 0, size: int = 64) -> dict:
    """The sel_multi_adain / ccam / mst fixture's arrays, computed afresh
    with JAX on the CPU (rpst's int8 kernel in interpret mode)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst.models import fast_path as fp
    from rpst.models import fast_path_q8 as q8
    from rpst.ops.folded import unfold
    from rpst.train.step import TrainState, make_optimizer, make_train_step
    from rpst_torch.bridge import vgg_weights_from_seed

    rng = np.random.default_rng(seed)
    shape = (TRAIN["batch"], size, size, 3)
    content = rng.random(shape, dtype=np.float32)
    style = rng.random(shape, dtype=np.float32)
    base = dict(SLICE4[network], img_size=size, lr=TRAIN["lr"],
                lr_decay=TRAIN["lr_decay"], **SLICE4_LOSS)
    cfg = load_config(dict(base, exec_strategy="folded"))
    bundle = build_model(cfg)
    c, s = jnp.asarray(content), jnp.asarray(style)
    variables = jax.jit(bundle.model.init)(jax.random.PRNGKey(seed), c, s)
    variables = jax.tree.map(np.asarray, dict(variables))
    params = dict(variables["params"])
    params["ms"] = _he_stacks(params["ms"], rng)
    extra = {}
    if network == "ccam":
        for i, v in enumerate(CCAM_SCALES):
            params[f"ccam_{i}"] = {"scale": np.full((1,), v, np.float32)}
    if network == "sel_multi_adain":
        att = jax.tree.map(np.array, params["attention_block"])
        for bn in ("bn1", "bn2", "bn3"):
            n = att[bn]["scale"].shape[0]
            att[bn]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            att[bn]["bias"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
        params["attention_block"] = att
        _, muts = jax.jit(lambda v: bundle.model.apply(
            v, c, s, train=True, mutable=["batch_stats"]))(
            {"params": params, **{k: v for k, v in variables.items()
                                  if k != "params"}})
        extra = {"batch_stats": jax.tree.map(np.asarray,
                                             muts["batch_stats"])}
    params = jax.tree.map(jnp.asarray, params)
    var = {"params": params, **extra}
    vgg_vars = jax.tree.map(jnp.asarray,
                            vgg_weights_from_seed(TRAIN["vgg_seed"]))
    arrays = {f"params/{k}": np.asarray(v, np.float32).copy()
              for k, v in _flat(params)}
    arrays.update({f"batch_stats/{k}": np.asarray(v, np.float32)
                   for k, v in _flat(extra.get("batch_stats", {}))})
    arrays.update(content=content, style=style,
                  vgg_seed=np.int64(TRAIN["vgg_seed"]),
                  lr=np.float32(TRAIN["lr"]),
                  lr_decay=np.float32(TRAIN["lr_decay"]))
    arrays["out_folded"] = np.asarray(jax.jit(bundle.stylize)(
        var, vgg_vars, c, s), np.float32)
    bf16 = build_model(load_config(dict(base, exec_strategy="folded",
                                        compute_dtype="bfloat16")))
    arrays["out_folded_bf16"] = np.asarray(jax.jit(bf16.stylize)(
        var, vgg_vars, c, s), np.float32)
    std = build_model(load_config(base))
    arrays["out_std"] = np.asarray(jax.jit(std.stylize)(var, vgg_vars, c, s),
                                   np.float32)
    if network == "ccam":
        shuffled = build_model(load_config(dict(base, shuffle=True)))
        arrays["out_std_shuffle"] = np.asarray(jax.jit(shuffled.stylize)(
            var, vgg_vars, c, s), np.float32)

    def loss_fn(p):
        total, (parts, muts) = bundle.loss({"params": p, **extra}, vgg_vars,
                                           c, s, train=True)
        return total, (parts, muts)

    (_, (parts, muts)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    arrays.update({k: np.float32(parts[k]) for k in
                   ("content_loss", "style_loss", "total_loss")})
    arrays.update({f"grads/{k}": np.asarray(v, np.float32)
                   for k, v in _flat(grads)})
    arrays.update({f"stats_after/{k}": np.asarray(v, np.float32)
                   for k, v in _flat(muts.get("batch_stats", {}))})
    # the standard path's gradients: the spread between rpst's two float32
    # paths is what its own gradients can be held to
    std_grads = jax.jit(jax.grad(lambda p: std.loss(
        {"params": p, **extra}, vgg_vars, c, s, train=True)[0]))(params)
    arrays.update({f"grads_std/{k}": np.asarray(v, np.float32)
                   for k, v in _flat(std_grads)})
    tx = make_optimizer(cfg)
    for key, b in (("trajectory", bundle), ("trajectory_std", std)):
        # the step donates its state: it runs on copies
        own = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                           {"params": params, "extra": extra})
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=own["params"], extra=own["extra"],
                           opt_state=tx.init(own["params"]),
                           rng=jax.random.PRNGKey(seed))
        step = make_train_step(b, tx)
        trajectory = []
        for _ in range(TRAIN["steps"]):
            state, step_parts = step(state, vgg_vars, c, s)
            trajectory.append(float(step_parts["total_loss"]))
        arrays[key] = np.asarray(trajectory, np.float32)

    if network == "sel_multi_adain":
        scales = q8.calibrate_sel_multi_adain_q8(var, c, s)
        run = lambda dt: q8.stylize_sel_multi_adain_folded_q8(  # noqa: E731
            var, scales, c, s, dtype=dt, interpret=True)
    elif network == "ccam":
        scales = q8.calibrate_ccam_q8(var, c, s, cfg.stylized_layers)
        run = lambda dt: q8.stylize_ccam_folded_q8(  # noqa: E731
            var, scales, c, s, cfg.stylized_layers, dtype=dt,
            interpret=True)
    else:
        mst = dict(stylized_layers=cfg.stylized_layers,
                   n_clusters=cfg.n_clusters, mst_lambda=cfg.mst_lambda)
        scales = q8.calibrate_mst_q8(params, c, s, **mst)
        run = lambda dt: q8.stylize_mst_folded_q8(  # noqa: E731
            params, scales, c, s, dtype=dt, interpret=True, **mst)
    arrays["act_scales"] = np.asarray(scales["act_scales"], np.float32)
    for name, dt in (("out_q8_f32", jnp.float32),
                     ("out_q8_bf16", jnp.bfloat16)):
        arrays[name] = np.asarray(run(dt), np.float32)

    if network == "mst":
        enc = fp._folded_blocks(params["ms"]["rp_shared_encoder"])

        def deepest(img):
            x = fp.fold(img)
            for k, b in enc:
                x = fp._lrelu(fp.folded_conv(x, k, b))
            return unfold(x)

        cf, sf = jax.jit(deepest)(c), jax.jit(deepest)(s)
        labels = [mst_labels(cf[i], sf[i], cfg.n_clusters)
                  for i in range(cf.shape[0])]
        arrays["s_labels"] = np.stack([lab[0] for lab in labels])
        arrays["c_labels"] = np.stack([lab[1] for lab in labels])
        arrays["label_gap"] = np.float32(min(lab[2] for lab in labels))
    return arrays


def slice4_grads_f64(network: str, arrays: dict,
                     f64_stats: bool = False) -> dict:
    """rpst's standard-path gradients in float64 at a slice-4 fixture's
    point (its params, batch_stats, images and VGG): ``grads_f64/<path>``.
    Where rpst's two float32 gradients sit as far from these as from each
    other or further, float32 rounding that both paths share (the same
    elementwise ops on almost the same inputs round alike) is what the
    port's gradients can be held to. With ``f64_stats`` the feature
    statistics run in float64 too (``ld_f64_stats``; rpst rounds them to
    float32 even for float64 features, which leaves ccam's float64
    gradients 2% of max from the port's float64 ones):
    ``grads_f64s/<path>``, the float64 function the card's float64
    gradients are held to (``chip_smoke.py`` phase 34). Turns on JAX's
    float64 mode."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst_torch.bridge import vgg_weights_from_seed

    jax.config.update("jax_enable_x64", True)

    def tree(prefix):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _unflat(
            {k[len(prefix):]: v for k, v in arrays.items()
             if k.startswith(prefix)}))

    params, stats = tree("params/"), tree("batch_stats/")
    extra = {"batch_stats": stats} if stats else {}
    c, s = (jnp.asarray(arrays[k], jnp.float64) for k in ("content", "style"))
    vgg_vars = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                            vgg_weights_from_seed(int(arrays["vgg_seed"])))
    std = build_model(load_config(dict(
        SLICE4[network], img_size=c.shape[1], lr=TRAIN["lr"],
        lr_decay=TRAIN["lr_decay"], **SLICE4_LOSS)))
    undo = ld_f64_stats() if f64_stats else (lambda: None)
    try:
        grads = jax.jit(jax.grad(lambda p, e, v, x, y: std.loss(
            {"params": p, **e}, v, x, y, train=True)[0]))(params, extra,
                                                           vgg_vars, c, s)
    finally:
        undo()
    key = "grads_f64s" if f64_stats else "grads_f64"
    out = {f"{key}/{k}": np.asarray(v, np.float64) for k, v in _flat(grads)}
    assert all(v.dtype == np.float64 for v in out.values())
    return out


def make_target_cache_fixture(seed: int = 0, size: int = 64) -> dict:
    """The target-cache fixture's arrays on the train fixture's inputs,
    computed afresh with JAX on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst.nn.vgg_folded import vgg_perceptual_stats
    from rpst_torch.bridge import vgg_weights_from_seed

    with np.load(TRAIN_DST) as npz:
        train = {k: npz[k] for k in npz.files}
    params = jax.tree.map(jnp.asarray, _unflat(
        {k[len("params/"):]: v for k, v in train.items()
         if k.startswith("params/")}))
    c, s = jnp.asarray(train["content"]), jnp.asarray(train["style"])
    n = c.shape[0]
    vgg_vars = jax.tree.map(jnp.asarray,
                            vgg_weights_from_seed(int(train["vgg_seed"])))
    bundle = build_model(load_config(dict(FLAGSHIP, img_size=size,
                                          exec_strategy="folded")))
    stats, relu4 = jax.jit(lambda x: vgg_perceptual_stats(
        vgg_vars, x, jnp.float32))(jnp.concatenate([s, c], axis=0))
    t_stats = [(m[:n], sd[:n]) for m, sd in stats]
    t_relu4 = relu4[n:]

    def loss_fn(p):
        total, (parts, _) = bundle.loss({"params": p}, vgg_vars, c, s,
                                        train=True,
                                        targets=(t_stats, t_relu4))
        return total, parts

    (_, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    arrays = {f"t_mean_{i}": np.asarray(m, np.float32)
              for i, (m, _) in enumerate(t_stats)}
    arrays.update({f"t_std_{i}": np.asarray(sd, np.float32)
                   for i, (_, sd) in enumerate(t_stats)})
    arrays["t_relu4"] = np.asarray(t_relu4, np.float32)
    arrays.update({k: np.float32(parts[k]) for k in
                   ("content_loss", "style_loss", "total_loss")})
    arrays.update({f"grads/{k}": np.asarray(v, np.float32)
                   for k, v in _flat(grads)})
    return arrays


def slice5b_params(network: str, seed: int) -> dict:
    """The slice-5b fixture's flax ``params`` (numpy), drawn as the port's
    ``bridge`` draws them."""
    from rpst_torch import bridge
    cfg = SLICE5B[network]
    width = dict(rp_blocks=cfg["rp_blocks"], hidden_dim=cfg["hidden_dim"])
    if network == "mrf":
        return bridge.mrf_weights_from_seed(seed, **width)
    if network == "spade":
        return bridge.spade_weights_from_seed(seed, ndf=cfg["ndf"], **width)
    if network == "seg_adain":
        return bridge.seg_adain_weights_from_seed(
            seed, seg_hidden_dim=cfg["seg_hidden_dim"],
            class_num=cfg["class_num"], **width)
    if network in LD:
        return bridge.ld_weights_from_seed(
            network, seed, cfg["ld_layer_num"], cfg["hidden_dim"],
            cfg["stylized_layers"])
    return bridge.rpseq_weights_from_seed(seed, **width)


def ld_q8_features(network: str, params, scales, content, style) -> dict:
    """rpst's int8 features at the first eligible layer of the float32 q8
    pass (the module docstring's ``q8_in`` / ``q8_out``), re-run with rpst's
    own pieces in the order its pass runs them, for the first image."""
    import jax.numpy as jnp
    import numpy as np

    from rpst.models import fast_path_q8 as q8

    f32 = jnp.float32
    act = [float(a) for a in scales["act_scales"]]
    conv_q = q8._make_conv_q_std(f32, 16, True, "reflect", alpha=0.2)
    x = jnp.concatenate([content, style], axis=0).astype(f32)
    if network == "ld_adain":
        enc, _ = q8._ld_stacks(params)
        for i, ((ks, bs), (kg, bg)) in enumerate(enc):
            if q8._q8_eligible(ks) and q8._q8_eligible(kg):
                x_q = q8.quantize_activations(x, act[0])
                out = jnp.concatenate([
                    conv_q(x_q, act[0], ks, bs, out_scale=act[1]),
                    q8._xla_conv_q8(x_q, act[0], kg, bg, f32,
                                    out_scale=act[1])], axis=-1)
                return {"q8_layer": np.int64(i),
                        "q8_in": np.asarray(x_q[:1]),
                        "q8_out": np.asarray(out[:1])}
            x = jnp.concatenate([q8._lrelu_conv(x, ks, bs, f32),
                                 q8._lrelu_conv(x, kg, bg, f32)], axis=-1)
    else:
        from rpst.models.ld_adain import _resize_nearest
        enc, _ = q8._ld2_stacks(params)
        for i, ((ks, bs), c1, (ka, ba), (kb_, bb)) in enumerate(enc):
            h, w = x.shape[1], x.shape[2]
            t = q8._conv1x1(x, *c1, f32)
            if all(q8._q8_eligible(k) for k in (ks, ka, kb_)):
                conv_relu = q8._make_conv_q_std(f32, 16, True, "reflect",
                                                alpha=0.0)
                t_q = q8.quantize_activations(t, act[1])
                a = conv_relu(t_q, act[1], ka, ba, out_scale=act[2])
                return {"q8_layer": np.int64(i),
                        "q8_in": np.asarray(t_q[:1]),
                        "q8_out": np.asarray(a[:1])}
            sm = q8._lrelu_conv(x, ks, bs, f32)
            bg = q8._reflect_conv(q8._reflect_conv(t, ka, ba, f32), kb_, bb,
                                  f32)
            bg = q8._maxpool2x_any(bg)
            bg = jnp.pad(bg, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
            x = jnp.concatenate([sm, _resize_nearest(bg, h, w)], axis=-1)
    raise ValueError(f"{network}: no eligible layer")


def _grad_keys(grads, prefix=""):
    """``gradnorm/``, ``grads/`` (biases in full) and ``gradpatch/`` (the
    [..., :8, :8] corner of the kernels) of a gradient tree."""
    import numpy as np
    out = {}
    for k, v in _flat(grads):
        g = np.asarray(v)
        out[f"{prefix}gradnorm/{k}"] = np.asarray(np.linalg.norm(g), g.dtype)
        if k.endswith("bias"):
            out[f"{prefix}grads/{k}"] = g
        else:
            out[f"{prefix}gradpatch/{k}"] = g[..., :8, :8].copy()
    return out


def make_slice5b_fixture(network: str, seed: int = 0,
                         size: int = 64) -> dict:
    """The mrf / spade / seg_adain / wct_train / adain_train fixture's
    arrays, computed afresh with JAX on the CPU (rpst's int8 kernel in
    interpret mode)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst.models import fast_path_q8 as q8
    from rpst.train.step import TrainState, make_optimizer, make_train_step
    from rpst_torch.bridge import vgg_weights_from_seed

    rng = np.random.default_rng(seed)
    shape = (TRAIN["batch"], size, size, 3)
    content = rng.random(shape, dtype=np.float32)
    style = rng.random(shape, dtype=np.float32)
    lr = LD_LR if network in LD else TRAIN["lr"]
    base = dict(SLICE5B[network], img_size=size, lr=lr,
                lr_decay=TRAIN["lr_decay"], **SLICE5B_LOSS)
    cfg = load_config(base)
    bundle = build_model(cfg)
    np_params = slice5b_params(network, seed)
    params = jax.tree.map(jnp.asarray, np_params)
    vgg_vars = jax.tree.map(jnp.asarray,
                            vgg_weights_from_seed(TRAIN["vgg_seed"]))
    c, s = jnp.asarray(content), jnp.asarray(style)
    arrays = dict(weights_seed=np.int64(seed),
                  vgg_seed=np.int64(TRAIN["vgg_seed"]), content=content,
                  style=style, lr=np.float32(lr),
                  lr_decay=np.float32(TRAIN["lr_decay"]))
    label = None
    if network == "seg_adain":
        arrays["label"] = rng.integers(-1, cfg.class_num, shape[:3],
                                       dtype=np.int32)
        label = jnp.asarray(arrays["label"])

    if network not in ("wct_train", "adain_train"):
        var = {"params": params}
        sl = cfg.stylized_layers
        arrays["out_f32"] = np.asarray(jax.jit(bundle.stylize)(
            var, vgg_vars, c, s), np.float32)
        bf16 = build_model(load_config(dict(base, compute_dtype="bfloat16")))
        arrays["out_bf16"] = np.asarray(jax.jit(bf16.stylize)(
            var, vgg_vars, c, s), np.float32)
        if network == "mrf":
            scales = q8.calibrate_mrf_q8(params, c, s)
            run = lambda dt: q8.stylize_mrf_q8(  # noqa: E731
                params, scales, c, s, dtype=dt, interpret=True)
        elif network == "spade":
            scales = q8.calibrate_spade_q8(params, c, s)
            run = lambda dt: q8.stylize_spade_q8(  # noqa: E731
                params, scales, c, s, ndf=cfg.ndf, spade_norm=cfg.spade_norm,
                dtype=dt, interpret=True)
        elif network in ("ld_adain", "ld_adain2"):
            v1 = network == "ld_adain"
            scales = (q8.calibrate_ld_q8 if v1 else q8.calibrate_ld2_q8)(
                params, c, s, stylized_layers=sl)
            stylize = q8.stylize_ld_q8 if v1 else q8.stylize_ld2_q8
            run = lambda dt: stylize(  # noqa: E731
                params, scales, c, s, stylized_layers=sl, dtype=dt,
                interpret=True, conv_impl="pallas")
            arrays.update(ld_q8_features(network, params, scales, c, s))
        elif network == "seg_adain":
            scales = q8.calibrate_adain_q8(params["adain_rp"], c, s)
            run = lambda dt: q8.stylize_adain_q8(  # noqa: E731
                params["adain_rp"], scales, c, s, dtype=dt, interpret=True)
        else:  # LD v3-v5: no int8 path
            run = None
        if run is not None:
            arrays["act_scales"] = np.asarray(scales["act_scales"],
                                              np.float32)
            for name, dt in (("out_q8_f32", jnp.float32),
                             ("out_q8_bf16", jnp.bfloat16)):
                arrays[name] = np.asarray(run(dt), np.float32)

    def loss_fn(p, v, x, y, lab):
        total, (parts, _) = bundle.loss({"params": p}, v, x, y, train=True,
                                        content_label=lab)
        return total, parts

    (_, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, vgg_vars, c, s, label)
    arrays.update({k: np.float32(v) for k, v in parts.items()})
    arrays.update(_grad_keys(jax.tree.map(
        lambda a: np.asarray(a, np.float32), grads)))

    freeze = ("encoder",) if network == "wct_train" else ()
    tx = make_optimizer(cfg, freeze)
    own = jax.tree.map(lambda a: jnp.asarray(np.array(a)), np_params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=own, extra={},
                       opt_state=tx.init(own), rng=jax.random.PRNGKey(seed))
    step = make_train_step(bundle, tx, with_labels=label is not None)
    trajectory = []
    for _ in range(TRAIN["steps"]):
        state, step_parts = (step(state, vgg_vars, c, s, label)
                             if label is not None
                             else step(state, vgg_vars, c, s))
        trajectory.append(float(step_parts["total_loss"]))
    arrays["trajectory"] = np.asarray(trajectory, np.float32)
    if freeze:  # the frozen encoder left bit-unchanged by rpst's steps
        before = dict(_flat(np_params["encoder"]))
        for k, v in _flat(state.params["encoder"]):
            assert np.array_equal(np.asarray(v), before[k]), k

    # the same loss and gradients in float64: each gradient's own float32
    # error, where it is larger than the bounds' floor; the LD family's with
    # the feature statistics in float64 too (ld_f64_stats)
    jax.config.update("jax_enable_x64", True)
    undo = ld_f64_stats() if network in LD else (lambda: None)
    try:
        def f64(tree):
            return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        (_, parts64), g64 = jax.jit(jax.value_and_grad(loss_fn,
                                                       has_aux=True))(
            f64(np_params), f64(vgg_weights_from_seed(TRAIN["vgg_seed"])),
            jnp.asarray(content, jnp.float64),
            jnp.asarray(style, jnp.float64), label)
        arrays.update(_grad_keys(jax.tree.map(
            lambda a: np.asarray(a, np.float32), g64), "f64/"))
        # the float64 loss parts: mrf's k-th similarity choice is
        # discontinuous, so its test holds each framework's float32 parts
        # to these
        arrays.update({f"f64/{k}": np.float64(v) for k, v in
                       parts64.items()})
    finally:
        undo()
        jax.config.update("jax_enable_x64", False)
    return arrays


def src_f64_readings(arrays: dict) -> dict:
    """rpst's float64 readings at the src fixture's point (turns JAX's
    float64 mode on and off again): the loss parts ``f64/<part>`` and the
    gradients in ``_loss_and_grads``'s keys under ``f64/`` (src's float32
    gradients are noisy, so its test holds each framework's float32 error
    against these), and the float64 stylize ``out_f64`` (the reference each
    framework's int8 output is read against)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst_torch.bridge import src_weights_from_seed, vgg_weights_from_seed

    jax.config.update("jax_enable_x64", True)
    try:
        def f64(tree):
            return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        bundle = build_model(load_config(dict(
            SRC, img_size=arrays["content"].shape[1])))
        params = f64(src_weights_from_seed(int(arrays["weights_seed"])))
        vgg_vars = f64(vgg_weights_from_seed(int(arrays["vgg_seed"]), 4))
        c, s = (jnp.asarray(arrays[k], jnp.float64)
                for k in ("content", "style"))
        own = {}
        _loss_and_grads(bundle, vgg_vars, params, c, s, own)
        out = {f"f64/{k}": np.asarray(v, np.float64) for k, v in own.items()}
        out["out_f64"] = np.asarray(jax.jit(bundle.stylize)(
            {"params": params}, vgg_vars, c, s), np.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    return out


SLICE4R_DST = REPO / "tests" / "fixtures" / "torch_port_slice4r.npz"
# the slice-4-remainder fixture's models: the deeper yaml's
# (configs/train_deeper_multiscale_rp_adain.yaml: deeper stacks, 3 inception
# convs a block, hidden 16, use_mask), a constant multi_adain with SK
# attention at full width (its SK branches group by 32), and the SE
# flagship yaml's model under grad_accum 2
SLICE4R = {
    "deeper": dict(network="multi_adain", enc_stack_way="deeper",
                   rp_blocks=5, hidden_dim=16, inception_num=3,
                   use_mask=True, content_weight=1.0, style_weight=1.0),
    "sk": dict(FLAGSHIP, attention="sk", content_weight=1.0,
               style_weight=2.0),
    "se_accum2": dict(FLAGSHIP, attention="se", use_mask=True,
                      content_weight=1.0, style_weight=1.0, grad_accum=2),
}
# the Conv2dBlock cases: (in, out, options)
SLICE4R_BLOCKS = {
    "block_bn": (32, 32, dict(inception_num=1, norm="bn",
                              activation="prelu", attention="sk")),
    "block_in": (16, 16, dict(norm="in", activation="prelu")),
}


def _s4r_grad_keys(grads, prefix):
    """Vectors and scalars in full (``grads/``), a conv kernel's [..., :8,
    :8] corner and a Dense kernel in full (``gradpatch/``), every leaf's
    norm (``gradnorm/``)."""
    import numpy as np
    out = {}
    for k, v in _flat(grads):
        g = np.asarray(v)
        out[f"{prefix}gradnorm/{k}"] = np.asarray(np.linalg.norm(g), g.dtype)
        if g.ndim <= 1:
            out[f"{prefix}grads/{k}"] = g
        else:
            out[f"{prefix}gradpatch/{k}"] = g[..., :8, :8].copy()
    return out


def make_slice4r_fixture(seed: int = 0, size: int = 64) -> dict:
    """The slice-4-remainder fixture's arrays (``--slice4r``), computed
    afresh with JAX on the CPU. The weights are
    ``rpst_torch.bridge.flax_weights_from_seed`` of the port's model (stored
    as their seed); ``content``, ``style`` (2, size, size, 3) and the label
    maps ``c_labels`` / ``s_labels`` of ``tools/make_photoreal_set.py``.
    Block cases hold their ``config`` (in / out widths and options) too.
    Per model case ``<case>/``: ``config`` (the config's JSON),
    ``out_f64`` (rpst's stylize in float64, its masked AdaIN and feature
    statistics too), ``out_f32`` and ``out_bf16`` (rpst's
    stylize in test mode, masked where the case sets ``use_mask``), the
    loss parts, the gradients (``_s4r_grad_keys``) in float32 and under
    ``f64/`` in float64 with the feature statistics in float64
    (``ld_f64_stats``), and ``stats_after/<path>`` the running statistics
    after the step's train forward(s); ``se_accum2`` is rpst's
    ``_accumulate_grads`` over 2 microbatches (its float64 gradients the
    mean of the two microbatches' float64 gradients). Per block case
    ``<case>/``: its input ``x`` (2, 12, 10, in), ``out_eval`` (running
    statistics), ``out_train`` and ``stats_after``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from make_photoreal_set import label_maps
    from rpst.config import load_config
    from rpst.models import build_model
    from rpst.nn.blocks import Conv2dBlock as JaxConv2dBlock
    from rpst.train.step import TrainState, _accumulate_grads
    from rpst_torch import bridge
    from rpst_torch.config import load_config as port_config
    from rpst_torch.models import build_model as port_build
    from rpst_torch.nn.blocks import Conv2dBlock

    rng = np.random.default_rng(seed)
    shape = (TRAIN["batch"], size, size, 3)
    content = rng.random(shape, dtype=np.float32)
    style = rng.random(shape, dtype=np.float32)
    maps = [label_maps(size, rng) for _ in range(shape[0])]
    cl = np.stack([m[0] for m in maps]).astype(np.int32)
    sl = np.stack([m[1] for m in maps]).astype(np.int32)
    arrays = dict(weights_seed=np.int64(seed),
                  vgg_seed=np.int64(TRAIN["vgg_seed"]), content=content,
                  style=style, c_labels=cl, s_labels=sl)
    vgg_np = bridge.vgg_weights_from_seed(TRAIN["vgg_seed"])
    vgg_vars = jax.tree.map(jnp.asarray, vgg_np)
    c, s = jnp.asarray(content), jnp.asarray(style)
    for case, cfg in SLICE4R.items():
        arrays[f"{case}/config"] = np.asarray(json.dumps(cfg))
        cfg = dict(cfg, img_size=size)
        params, stats = bridge.flax_weights_from_seed(
            port_build(port_config(cfg)).model, seed)
        variables = {"params": params}
        if stats:
            variables["batch_stats"] = stats
        bundle = build_model(load_config(cfg))
        labels = ((jnp.asarray(cl), jnp.asarray(sl)) if cfg.get("use_mask")
                  else ())
        arrays[f"{case}/out_f32"] = np.asarray(jax.jit(bundle.stylize)(
            variables, vgg_vars, c, s, *labels), np.float32)
        bf16 = build_model(load_config(dict(cfg, compute_dtype="bfloat16")))
        arrays[f"{case}/out_bf16"] = np.asarray(jax.jit(bf16.stylize)(
            variables, vgg_vars, c, s, *labels), np.float32)
        extra = {k: v for k, v in variables.items() if k != "params"}

        def loss_fn(p, e, x, y, lab, vv=vgg_vars, b=bundle):
            total, (parts, muts) = b.loss({"params": p, **e}, vv, x, y,
                                          train=True)
            return total, (parts, muts)
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                          static_argnums=())
        accum = int(cfg.get("grad_accum", 1))
        if accum > 1:
            state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               extra=extra, opt_state=None,
                               rng=jax.random.PRNGKey(0))
            _, parts, muts, grads = _accumulate_grads(
                lambda p, e, x, y, lab: grad_fn(p, e, x, y, None), state,
                accum, c, s)
        else:
            (_, (parts, muts)), grads = grad_fn(params, extra, c, s, None)
        arrays.update({f"{case}/{k}": np.float32(v) for k, v in
                       parts.items()})
        arrays.update(_s4r_grad_keys(jax.tree.map(
            lambda a: np.asarray(a, np.float32), grads), f"{case}/"))
        for k, v in _flat(muts.get("batch_stats", {})):
            arrays[f"{case}/stats_after/{k}"] = np.asarray(v, np.float32)
        jax.config.update("jax_enable_x64", True)
        undo = ld_f64_stats()
        undo_mask = _f64_masked_adain()
        try:
            def f64(tree):
                return jax.tree.map(
                    lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)
            p64, e64, v64 = f64(params), f64(extra), f64(vgg_np)
            c64, s64 = (jnp.asarray(a, jnp.float64) for a in (content,
                                                               style))
            arrays[f"{case}/out_f64"] = np.asarray(jax.jit(bundle.stylize)(
                {"params": p64, **e64}, v64, c64, s64, *labels), np.float64)
            mb = shape[0] // accum

            def g64(x, y):
                return jax.jit(jax.grad(lambda p: loss_fn(
                    p, e64, x, y, None, v64)[0]))(p64)
            gs = [g64(c64[i * mb:(i + 1) * mb], s64[i * mb:(i + 1) * mb])
                  for i in range(accum)]
            mean = jax.tree.map(lambda *g: sum(g) / accum, *gs)
            arrays.update(_s4r_grad_keys(jax.tree.map(np.asarray, mean),
                                         f"{case}/f64/"))
        finally:
            undo_mask()
            undo()
            jax.config.update("jax_enable_x64", False)
    for case, (cin, feat, opts) in SLICE4R_BLOCKS.items():
        x = rng.normal(size=(2, 12, 10, cin)).astype(np.float32)
        params, stats = bridge.flax_weights_from_seed(
            Conv2dBlock(cin, feat, **opts), seed)
        variables = {"params": params}
        if stats:
            variables["batch_stats"] = stats
        mod = JaxConv2dBlock(features=feat, padding=1, **opts)
        arrays[f"{case}/config"] = np.asarray(json.dumps(
            dict(opts, in_features=cin, features=feat)))
        arrays[f"{case}/x"] = x
        arrays[f"{case}/out_eval"] = np.asarray(mod.apply(
            variables, jnp.asarray(x)), np.float32)
        out, muts = mod.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        arrays[f"{case}/out_train"] = np.asarray(out, np.float32)
        for k, v in _flat(muts.get("batch_stats", {})):
            arrays[f"{case}/stats_after/{k}"] = np.asarray(v, np.float32)
    return arrays


def _f64_masked_adain():
    """rpst's masked AdaIN in its features' own type until the returned undo
    is called (rpst's casts to float32, also for float64 features): the
    slice-4r fixture's float64 stylize ``out_f64``, the oracle that each
    framework's float32 stylize is read against."""
    import jax.numpy as jnp

    from rpst.ops import segment
    old = segment.masked_adain

    def masked_adain(content_feat, style_feat, content_labels, style_labels,
                     num_labels):
        dt = content_feat.dtype
        h, w, c = content_feat.shape
        cf, sf = content_feat.reshape(-1, c), style_feat.reshape(-1, c)
        cl, sl = content_labels.reshape(-1), style_labels.reshape(-1)
        lids = jnp.arange(num_labels, dtype=cl.dtype)
        c_mean, c_std, c_count = segment._per_label_stats(
            cf, (cl[None, :] == lids[:, None]).astype(dt))
        s_mean, s_std, s_count = segment._per_label_stats(
            sf, (sl[None, :] == lids[:, None]).astype(dt))
        valid = ((c_count > 10) & (s_count > 10)
                 & (c_count < 100 * s_count) & (s_count < 100 * c_count))
        in_range = (cl >= 0) & (cl < num_labels)
        safe = jnp.clip(cl, 0, num_labels - 1)
        pix = (valid[safe] & in_range)[:, None]
        norm = (cf - c_mean[safe]) / c_std[safe] * s_std[safe] + s_mean[safe]
        return jnp.where(pix, norm, cf).reshape(h, w, c)
    segment.masked_adain = masked_adain

    def undo():
        segment.masked_adain = old
    return undo


def _bn_draw(tree, rng, stats: bool):
    """Every BatchNorm of a flax tree redrawn from ``rng``: its scale
    U(0.5, 1.5) and bias U(-0.2, 0.2) (``stats`` False: a params tree), or
    its running mean U(-0.2, 0.2) and variance U(0.5, 1.5) (a batch_stats
    tree), so that eval mode's statistics are not the identity."""
    import numpy as np
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _bn_draw(v, rng, stats)
            continue
        a = np.asarray(v, np.float32)
        if (stats and k == "mean") or (not stats and k == "bias"
                                       and a.ndim == 1 and "scale" in tree):
            a = rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        elif (stats and k == "var") or (not stats and k == "scale"
                                        and a.ndim == 1 and "bias" in tree):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        out[k] = a
    return out


def mask_case_params(case: str, seed: int, c, s):
    """(params, batch_stats) numpy trees of a masks-fixture case, and the
    seed the port's ``bridge`` draws them from (None where they are
    stored)."""
    import jax
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst_torch import bridge
    cfg = MASKS[case]
    rng = np.random.default_rng(seed + 1)
    if case == "src":
        return bridge.src_weights_from_seed(seed), {}, seed
    if case == "seg_adain":
        return bridge.seg_adain_weights_from_seed(
            seed, seg_hidden_dim=cfg["seg_hidden_dim"],
            class_num=cfg["class_num"], rp_blocks=cfg["rp_blocks"],
            hidden_dim=cfg["hidden_dim"]), {}, seed
    if case == "ld_adain":
        return bridge.ld_weights_from_seed(
            case, seed, cfg["ld_layer_num"], cfg["hidden_dim"],
            cfg["stylized_layers"]), {}, seed
    bundle = build_model(load_config(dict(cfg, img_size=c.shape[1])))
    variables = jax.tree.map(np.asarray, dict(jax.jit(
        lambda c, s: bundle.model.init(jax.random.PRNGKey(seed), c, s))(
        c, s)))
    params = dict(variables["params"])
    if case.startswith("multi_adain"):
        he = _he_stacks(params, rng)
        for stack in he:
            for blk, leaves in he[stack].items():
                params[stack] = dict(params[stack])
                params[stack][blk] = dict(params[stack][blk], **leaves)
    else:
        params["ms"] = dict(params["ms"])
        he = _he_stacks(params["ms"], rng)
        for stack in he:
            params["ms"][stack] = {
                blk: dict(params["ms"][stack][blk], **leaves)
                for blk, leaves in he[stack].items()}
    if case == "ccam":
        for i in range(cfg["rp_blocks"]):
            params[f"ccam_{i}"] = {
                "scale": np.full((1,), CCAM_SCALES[i], np.float32)}
    params = _bn_draw(params, rng, stats=False)
    stats = _bn_draw(variables.get("batch_stats", {}), rng, stats=True)
    return params, stats, None


def make_masks_fixture(seed: int = 0, size: int = 64) -> dict:
    """The masks fixture's arrays, computed afresh with JAX on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst_torch.bridge import vgg_weights_from_seed
    sys.path.insert(0, str(REPO / "tools"))
    from make_photoreal_set import label_maps

    rng = np.random.default_rng(seed)
    shape = (TRAIN["batch"], size, size, 3)
    content = rng.random(shape, dtype=np.float32)
    style = rng.random(shape, dtype=np.float32)
    maps = [label_maps(size, rng) for _ in range(TRAIN["batch"])]
    c_labels = np.stack([m[0] for m in maps]).astype(np.int32)
    s_labels = np.stack([m[1] for m in maps]).astype(np.int32)
    c, s = jnp.asarray(content), jnp.asarray(style)
    cl, sl = jnp.asarray(c_labels), jnp.asarray(s_labels)
    vgg_vars = jax.tree.map(jnp.asarray,
                            vgg_weights_from_seed(TRAIN["vgg_seed"]))
    arrays = dict(content=content, style=style, c_labels=c_labels,
                  s_labels=s_labels, vgg_seed=np.int64(TRAIN["vgg_seed"]))
    for case, cfg in MASKS.items():
        arrays[f"{case}/config"] = np.array(json.dumps(cfg))
        params, stats, weights_seed = mask_case_params(case, seed, c, s)
        if weights_seed is None:
            arrays.update({f"{case}/params/{k}": np.asarray(v, np.float32)
                           for k, v in _flat(params)})
            arrays.update({f"{case}/batch_stats/{k}":
                           np.asarray(v, np.float32)
                           for k, v in _flat(stats)})
        else:
            arrays[f"{case}/weights_seed"] = np.int64(weights_seed)
        var = {"params": jax.tree.map(jnp.asarray, params)}
        if stats:
            var["batch_stats"] = jax.tree.map(jnp.asarray, stats)
        for key, dt, labels in (("out_f32", "float32", (cl, sl)),
                                ("out_bf16", "bfloat16", (cl, sl)),
                                ("out_nomask", "float32", (None, None))):
            b = build_model(load_config(dict(cfg, img_size=size,
                                             compute_dtype=dt)))
            out = jax.jit(lambda v, c, s, cl, sl, b=b: b.stylize(
                v, vgg_vars, c, s, cl, sl))(var, c, s, *labels)
            arrays[f"{case}/{key}"] = np.asarray(out, np.float32)
        if case != "multi_adain":
            continue
        bundle = build_model(load_config(dict(cfg, img_size=size)))

        def loss_fn(p):
            total, (parts, muts) = bundle.loss(
                {"params": p, "batch_stats": var["batch_stats"]}, vgg_vars,
                c, s, train=True)
            return total, (parts, muts)

        (_, (parts, muts)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(var["params"])
        arrays.update({f"{case}/{k}": np.float32(parts[k]) for k in
                       ("content_loss", "style_loss", "total_loss")})
        arrays.update({f"{case}/grads/{k}": np.asarray(v, np.float32)
                       for k, v in _flat(grads)})
        arrays.update({f"{case}/stats_after/{k}": np.asarray(v, np.float32)
                       for k, v in _flat(muts["batch_stats"])})
    arrays.update(masks_grads_f64(arrays))
    return arrays


def masks_grads_f64(arrays: dict) -> dict:
    """rpst's float64 gradients of the masks fixture's SE flagship loss at
    its point: ``multi_adain/grads_f64/<path>``, the measure of each
    gradient's own float32 error (the SE BatchNorms' backward amplifies
    float32 rounding). Turns on JAX's float64 mode."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst_torch.bridge import vgg_weights_from_seed

    jax.config.update("jax_enable_x64", True)

    def tree(prefix):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _unflat(
            {k[len(prefix):]: v for k, v in arrays.items()
             if k.startswith(prefix)}))

    var = {"params": tree("multi_adain/params/"),
           "batch_stats": tree("multi_adain/batch_stats/")}
    c, s = (jnp.asarray(arrays[k], jnp.float64) for k in ("content", "style"))
    vgg_vars = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                            vgg_weights_from_seed(int(arrays["vgg_seed"])))
    bundle = build_model(load_config(dict(MASKS["multi_adain"],
                                          img_size=c.shape[1])))
    grads = jax.jit(jax.grad(lambda p, st, v, x, y: bundle.loss(
        {"params": p, "batch_stats": st}, v, x, y, train=True)[0]))(
        var["params"], var["batch_stats"], vgg_vars, c, s)
    return {f"multi_adain/grads_f64/{k}": np.asarray(v, np.float64)
            for k, v in _flat(grads)}


def _f64_calc_mean_std(feat, eps: float = 1e-5):
    """rpst's ``calc_mean_std`` with the reductions in the features' own
    type (rpst's casts them to float32, also for float64 features)."""
    import jax.numpy as jnp
    mean = jnp.mean(feat, axis=(1, 2), keepdims=True)
    n = feat.shape[1] * feat.shape[2]
    var = jnp.sum((feat - mean) ** 2, axis=(1, 2),
                  keepdims=True) / max(n - 1, 1)
    return mean, jnp.sqrt(var + eps)


def ld_f64_stats():
    """Run rpst's feature statistics (AdaIN, the style loss) in float64 for
    the LD fixtures' float64 gradients (and the slice-4 fixtures'
    ``grads_f64s``), until the returned undo is called.
    With the statistics rounded to float32, as rpst computes them, the two
    frameworks' float64 gradients of the LD family sit up to 4e-4 of max
    apart (each rounds its float32 sums in another order, and the LD losses
    amplify that); with them in float64 the loss agrees to 1e-15 and the
    gradients to 5e-8 of max, which shows the same function. The port's
    tests hold their float64 run to these under the same change."""
    from rpst.models import base
    from rpst.ops import stats
    old = stats.calc_mean_std, base.calc_mean_std
    stats.calc_mean_std = base.calc_mean_std = _f64_calc_mean_std

    def undo():
        stats.calc_mean_std, base.calc_mean_std = old
    return undo


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=None,
                    help="image size (default 64; the LD fixtures 32)")
    ap.add_argument("--train", action="store_true",
                    help="write the train fixture instead")
    ap.add_argument("--q8", action="store_true",
                    help="write the q8 fixture instead")
    ap.add_argument("--adain", action="store_true",
                    help="write the adain fixture instead")
    ap.add_argument("--wct", action="store_true",
                    help="write the wct fixture instead")
    ap.add_argument("--q8-targets", action="store_true",
                    help="write the q8-targets fixture instead")
    ap.add_argument("--sanet", action="store_true",
                    help="write the sanet fixture instead")
    ap.add_argument("--dynamic-sanet", action="store_true",
                    help="write the dynamic_sanet fixture instead")
    ap.add_argument("--src", action="store_true",
                    help="write the src fixture instead")
    ap.add_argument("--sel-multi-adain", action="store_true",
                    help="write the sel_multi_adain fixture instead")
    ap.add_argument("--ccam", action="store_true",
                    help="write the ccam fixture instead")
    ap.add_argument("--mst", action="store_true",
                    help="write the mst fixture instead")
    ap.add_argument("--target-cache", action="store_true",
                    help="write the target-cache fixture instead")
    for name in SLICE5B:
        ap.add_argument(f"--{name.replace('_', '-')}", action="store_true",
                        help=f"write the {name} fixture instead")
    ap.add_argument("--ld", action="store_true",
                    help="write the five LD fixtures instead")
    ap.add_argument("--masks", action="store_true",
                    help="write the masks fixture instead")
    ap.add_argument("--grads-f64", action="store_true",
                    help="with a slice-4 network: only (re)compute the "
                         "fixture's float64 gradients")
    ap.add_argument("--slice4r", action="store_true",
                    help="tests/fixtures/torch_port_slice4r.npz: the deeper "
                         "yaml's model, SK attention, the SE flagship under "
                         "grad_accum 2, the Conv2dBlock norms and prelu")
    ap.add_argument("dst", nargs="?", default=None)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    slice4 = [n for n in SLICE4 if getattr(args, n)]
    slice5b = [n for n in SLICE5B if getattr(args, n)]
    if args.masks:
        arrays = make_masks_fixture(args.seed, args.size or 64)
        dst = args.dst or str(MASKS_DST)
        np.savez_compressed(dst, **arrays)
        print(f"wrote {dst} ({len(arrays)} arrays)")
        return
    if args.ld:
        for network in LD:
            arrays = make_slice5b_fixture(network, args.seed,
                                          args.size or LD_SIZE)
            np.savez_compressed(SLICE5B_DST[network], **arrays)
            print(f"wrote {SLICE5B_DST[network]} ({len(arrays)} arrays)")
        return
    if args.slice4r:
        sys.path.insert(0, str(REPO / "tools"))
        arrays = make_slice4r_fixture(args.seed, args.size or 64)
        dst = args.dst or str(SLICE4R_DST)
        np.savez_compressed(dst, **arrays)
        print(f"wrote {dst} ({len(arrays)} arrays)")
        return
    size = args.size or (LD_SIZE if slice5b and slice5b[0] in LD else 64)
    args.size = size
    if slice5b:
        arrays = make_slice5b_fixture(slice5b[0], args.seed, args.size)
        args.dst = args.dst or str(SLICE5B_DST[slice5b[0]])
    elif slice4:
        args.dst = args.dst or str(SLICE4_DST[slice4[0]])
        if args.grads_f64:
            with np.load(args.dst) as npz:
                arrays = {k: npz[k] for k in npz.files
                          if not k.startswith(("grads_f64/", "grads_f64s/"))}
        else:
            arrays = make_slice4_fixture(slice4[0], args.seed, args.size)
        arrays.update(slice4_grads_f64(slice4[0], arrays))
        arrays.update(slice4_grads_f64(slice4[0], arrays, f64_stats=True))
    elif args.target_cache:
        arrays = make_target_cache_fixture(args.seed, args.size)
        args.dst = args.dst or str(TARGET_CACHE_DST)
    elif args.adain or args.wct:
        network = "adain" if args.adain else "wct"
        arrays = make_rpseq_fixture(network, args.seed, args.size)
        args.dst = args.dst or str(RPSEQ_DST[network])
    elif args.q8_targets:
        arrays = make_q8_targets_fixture(args.seed, args.size)
        args.dst = args.dst or str(Q8_TARGETS_DST)
    elif args.sanet:
        arrays = make_sanet_fixture(args.seed, args.size)
        args.dst = args.dst or str(SANET_DST)
    elif args.dynamic_sanet:
        arrays = make_dynamic_sanet_fixture(args.seed, args.size)
        args.dst = args.dst or str(DYNAMIC_SANET_DST)
    elif args.src:
        arrays = make_src_fixture(args.seed, args.size)
        args.dst = args.dst or str(SRC_DST)
    elif args.train:
        arrays = make_train_fixture(args.seed, args.size)
        args.dst = args.dst or str(TRAIN_DST)
    elif args.q8:
        arrays = make_q8_fixture(args.seed, args.size)
        args.dst = args.dst or str(Q8_DST)
    else:
        arrays = make_fixture(args.seed, args.size)
        args.dst = args.dst or str(DEFAULT_DST)
    Path(args.dst).parent.mkdir(parents=True, exist_ok=True)
    # the new fixtures hold relu outputs, which compress well
    save = (np.savez_compressed
            if (args.adain or args.wct or args.q8_targets or args.sanet
                or args.dynamic_sanet or args.src or slice4 or slice5b
                or args.target_cache)
            else np.savez)
    save(args.dst, **arrays)
    print(f"wrote {args.dst} ({len(arrays)} arrays)")


if __name__ == "__main__":
    main()
