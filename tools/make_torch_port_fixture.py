#!/usr/bin/env python
"""Write tests/fixtures/torch_port_flagship.npz: the JAX reference output of
the flagship's folded stylize, for holding the PyTorch port against rpst on
a machine that has no JAX (``chip_smoke.py`` phase 3).

The flagship is multi_adain with the constant stack at full width
(rp_blocks 5, hidden_dim 32, attention none), as bench.py builds it. The
file holds:
  * ``params/<flax path>``: the flax params from ``model.init`` at
    ``jax.random.PRNGKey(seed)``, as float32 numpy (HWIO kernels);
  * ``content``, ``style``: a (1, size, size, 3) pair from numpy's
    ``default_rng(seed)``;
  * ``out``: ``rpst.models.fast_path.stylize_multi_adain_folded`` on them in
    float32 (XLA ring path, jitted, run on the CPU).

Usage:
  python tools/make_torch_port_fixture.py [--seed 0] [--size 64] [dst.npz]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

DEFAULT_DST = REPO / "tests" / "fixtures" / "torch_port_flagship.npz"
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("dst", nargs="?", default=str(DEFAULT_DST))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    arrays = make_fixture(args.seed, args.size)
    Path(args.dst).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.dst, **arrays)
    print(f"wrote {args.dst} ({len(arrays)} arrays)")


if __name__ == "__main__":
    main()
