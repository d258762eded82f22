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
    standard and int8 serving and its training loss and gradients.

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

Usage:
  python tools/make_torch_port_fixture.py --adain | --wct | --q8-targets
  python tools/make_torch_port_fixture.py --sanet
  python tools/make_torch_port_fixture.py [--seed 0] [--size 64] [dst.npz]
  python tools/make_torch_port_fixture.py --train [--seed 0] [--size 64] [dst]
  python tools/make_torch_port_fixture.py --q8 [--seed 0] [--size 64] [dst]
"""

from __future__ import annotations

import argparse
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
WIDE = dict(rp_blocks=5, hidden_dim=32)
TRAIN = dict(batch=2, vgg_seed=1, lr=1e-3, lr_decay=0.5, steps=3)
FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=5,
                hidden_dim=32, inception_num=0, attention="none")


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


def make_sanet_fixture(seed: int = 0, size: int = 64) -> dict:
    """The sanet fixture's arrays, computed afresh with JAX on the CPU
    (rpst's int8 kernel in interpret mode)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rpst.config import load_config
    from rpst.models import build_model
    from rpst.models import fast_path_q8 as q8
    from rpst_torch.bridge import (sanet_weights_from_seed,
                                   vgg_weights_from_seed)

    rng = np.random.default_rng(seed)
    content = rng.random((2, size, size, 3), dtype=np.float32)
    style = rng.random((2, size, size, 3), dtype=np.float32)
    params = jax.tree.map(jnp.asarray, sanet_weights_from_seed(seed))
    vgg_vars = jax.tree.map(jnp.asarray,
                            vgg_weights_from_seed(TRAIN["vgg_seed"], 5))
    bundle = build_model(load_config(dict(SANET, img_size=size)))
    c, s = jnp.asarray(content), jnp.asarray(style)
    variables = {"params": params}
    out = jax.jit(bundle.stylize)(variables, vgg_vars, c, s)
    scales = q8.calibrate_sanet_q8(variables, vgg_vars, c, s)
    arrays = dict(weights_seed=np.int64(seed),
                  vgg_seed=np.int64(TRAIN["vgg_seed"]), content=content,
                  style=style, out_f32=np.asarray(out, np.float32),
                  act_scales=np.asarray(scales["act_scales"], np.float32))
    for name, dt in (("out_q8_f32", jnp.float32),
                     ("out_q8_bf16", jnp.bfloat16)):
        arrays[name] = np.asarray(q8.stylize_sanet_q8(
            variables, vgg_vars, scales, c, s, dtype=dt, interpret=True),
            np.float32)

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
    return arrays


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
    ap.add_argument("--size", type=int, default=64)
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
    ap.add_argument("dst", nargs="?", default=None)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    if args.adain or args.wct:
        network = "adain" if args.adain else "wct"
        arrays = make_rpseq_fixture(network, args.seed, args.size)
        args.dst = args.dst or str(RPSEQ_DST[network])
    elif args.q8_targets:
        arrays = make_q8_targets_fixture(args.seed, args.size)
        args.dst = args.dst or str(Q8_TARGETS_DST)
    elif args.sanet:
        arrays = make_sanet_fixture(args.seed, args.size)
        args.dst = args.dst or str(SANET_DST)
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
            if args.adain or args.wct or args.q8_targets or args.sanet
            else np.savez)
    save(args.dst, **arrays)
    print(f"wrote {args.dst} ({len(arrays)} arrays)")


if __name__ == "__main__":
    main()
