#!/usr/bin/env python
"""Write the JAX reference fixtures that hold the PyTorch port against rpst
on a machine that has no JAX (``chip_smoke.py``):

  * tests/fixtures/torch_port_flagship.npz: the flagship's folded stylize
    (serving);
  * tests/fixtures/torch_port_train.npz (``--train``): the flagship's folded
    training loss, its gradients and a 3-step loss trajectory.

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

Usage:
  python tools/make_torch_port_fixture.py [--seed 0] [--size 64] [dst.npz]
  python tools/make_torch_port_fixture.py --train [--seed 0] [--size 64] [dst]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--train", action="store_true",
                    help="write the train fixture instead")
    ap.add_argument("dst", nargs="?", default=None)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    if args.train:
        arrays = make_train_fixture(args.seed, args.size)
        args.dst = args.dst or str(TRAIN_DST)
    else:
        arrays = make_fixture(args.seed, args.size)
        args.dst = args.dst or str(DEFAULT_DST)
    Path(args.dst).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.dst, **arrays)
    print(f"wrote {args.dst} ({len(arrays)} arrays)")


if __name__ == "__main__":
    main()
