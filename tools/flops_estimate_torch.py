#!/usr/bin/env python
"""Per-family stylize FLOPs of the PyTorch port (``rpst_torch``).

For each family of ``tools/flops_estimate.py`` (the same configurations),
it builds the port's model with seeded weights and counts the FLOPs of one
standard-path stylize (``ModelBundle.stylize``) of a batch-1 pair with
``torch.utils.flop_counter.FlopCounterMode``. That counter counts the
matrix products and convolutions (2 FLOPs a multiply-add), not the
elementwise work (activations, AdaIN, norms, softmax) that XLA's cost
analysis adds to rpst's count, so the port's number sits a few percent
below rpst's for the conv-bound families. It prints FLOPs only, no device
rate; the counter runs the stylize, so use a card at 512px:

    python tools/flops_estimate_torch.py [family ...] [--img 512]
                                         [--device cuda|cpu]

Imports neither JAX nor rpst.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

FAMILIES = {
    "multi_adain": dict(network="multi_adain", enc_stack_way="constant",
                        rp_blocks=5, hidden_dim=32),
    "adain": dict(network="adain", rp_blocks=5, hidden_dim=32),
    "wct": dict(network="wct", rp_blocks=5, hidden_dim=16,
                enc_stack_way="deeper"),
    "sanet": dict(network="sanet"),
    "dynamic_sanet": dict(network="dynamic_sanet"),
    "sel_multi_adain": dict(network="sel_multi_adain",
                            enc_stack_way="constant", rp_blocks=5,
                            hidden_dim=32),
    "ccam": dict(network="ccam", enc_stack_way="constant", rp_blocks=5,
                 hidden_dim=32),
    "mst": dict(network="mst", enc_stack_way="constant", rp_blocks=5,
                hidden_dim=32, stylized_layers=1),
    "ld_adain": dict(network="ld_adain", hidden_dim=16, ld_layer_num=5,
                     stylized_layers=5),
    "ld_adain2": dict(network="ld_adain2", hidden_dim=8, ld_layer_num=5),
    "ld_adain3": dict(network="ld_adain3", hidden_dim=32, ld_layer_num=5,
                      stylized_layers=5),
    "ld_adain4": dict(network="ld_adain4", hidden_dim=32, ld_layer_num=5),
    "ld_adain5": dict(network="ld_adain5", hidden_dim=32, ld_layer_num=5),
    "src": dict(network="src", hidden_dim=32),
    "mrf": dict(network="mrf"),
    "spade": dict(network="spade"),
    "seg_adain": dict(network="seg_adain"),
}


def stylize_flops(name: str, img: int = 512, device="cpu") -> int:
    """FLOPs of the port's standard stylize of one img x img pair."""
    from torch.utils.flop_counter import FlopCounterMode

    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default

    cfg = load_config(dict(img_size=img, vgg="", **FAMILIES[name]))
    bundle = build_model(cfg, device)
    init_torch_default(bundle.model, 0)
    if bundle.from_features:
        bundle.vgg = build_vgg(cfg, device)[0]
    c = torch.zeros((1, img, img, 3), device=device)
    s = torch.full((1, img, img, 3), 0.5, device=device)
    counter = FlopCounterMode(display=False)
    with counter:
        bundle.stylize(c, s, folded=False)
    return int(counter.get_total_flops())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--device", default=("cuda" if torch.cuda.is_available()
                                         else "cpu"))
    args = ap.parse_args(argv)
    print(f"{'family':<16} {f'GFLOP/img ({args.img}px)':>18}")
    for name in args.families:
        print(f"{name:<16} "
              f"{stylize_flops(name, args.img, args.device) / 1e9:>18.3f}")


if __name__ == "__main__":
    main()
