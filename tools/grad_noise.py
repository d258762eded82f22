#!/usr/bin/env python
"""Each parameter's float32 gradient error at a slice-4 fixture point, on
the CPU, relative to the tensor's max: the port's folded gradient against
rpst's folded one (``port``), rpst's folded one against its standard one
(``spread``) and against its float64 one (``f32 err``), and the port's
against rpst's float64 one (``port err``); worst ratio port / own first,
``own`` being the larger of spread and f32 err. The gradient tests hold
each tensor at ``GRAD_SPREAD`` x ``own``
(tests/test_torch_sel_multi_adain.py).

    python tools/grad_noise.py sel_multi_adain|ccam|mst [--rows N]

Needs JAX (it reads the fixture through the tests' helpers).
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO / "tests"), str(REPO / "src")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("network", choices=("sel_multi_adain", "ccam", "mst"))
    ap.add_argument("--rows", type=int, default=10)
    args = ap.parse_args()
    import test_torch_sel_multi_adain as helpers
    from rpst_torch.bridge import from_flax_params

    fx = helpers.load_fixture(args.network)
    bundle, vgg = helpers.fixture_bundle(args.network, fx)
    c, s = helpers.images(fx)
    bundle.model.train()
    total, _ = bundle.loss(vgg, c, s)
    total.backward()
    ref, std, f64 = (from_flax_params(fx["trees"][k])
                     for k in ("grads", "grads_std", "grads_f64"))
    rows = []
    for name, p in bundle.model.named_parameters():
        size = float(ref[name].abs().max())
        if p.grad is None or size == 0.0:
            continue

        def rel(a, b):
            return float((a - b).abs().max()) / size

        port, spread = rel(p.grad, ref[name]), rel(ref[name], std[name])
        err, port_err = rel(ref[name], f64[name]), rel(p.grad, f64[name])
        own = max(spread, err)
        rows.append((port / max(own, 1e-30), name, port, spread, err,
                     port_err))
    rows.sort(reverse=True)
    print(f"{args.network}: {len(rows)} tensors; own "
          f"{min(max(r[3], r[4]) for r in rows):.3g} .. "
          f"{max(max(r[3], r[4]) for r in rows):.3g} of max")
    print(f"{'port/own':>8s}  {'tensor':50s} {'port':>9s} {'spread':>9s} "
          f"{'f32 err':>9s} {'port err':>9s}")
    for ratio, name, port, spread, err, port_err in rows[:args.rows]:
        print(f"{ratio:8.3f}  {name:50s} {port:9.3e} {spread:9.3e} "
              f"{err:9.3e} {port_err:9.3e}")


if __name__ == "__main__":
    main()
