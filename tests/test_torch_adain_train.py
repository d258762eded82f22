"""adain training of the port on the CPU against
``tests/fixtures/torch_port_adain_train.npz``
(``tools/make_torch_port_fixture.py --adain-train``: the widths of
``configs/train_deeper_rp_adain.yaml``, rp_blocks 5 and hidden 16, at 64px,
batch 2, loss weights content 1 and style 2; rpst's loss parts, float32 and
float64 gradients and 3-step trajectory). No JAX compile: the fixture holds
rpst's numbers, and ``chip_smoke.py`` phase 49 holds the card to the same
file.

Tolerances are test_torch_mrf.py's: loss parts rtol 1e-4; the float64
gradients 1e-4 x max of rpst's float64 ones; the float32 ones 1e-4 x max or
``GRAD_SPREAD`` (2) x the larger of the two frameworks' own float32 errors;
the trajectory's later losses rtol 1e-2.
"""

from pathlib import Path

import torch
import yaml

from test_torch_mrf import (check_loss_grads_trajectory, fixture_bundle,
                            load_fixture)
from test_torch_sel_multi_adain import TOOL
from test_torch_sel_multi_adain import one_torch_thread  # noqa: F401

YAML = (Path(__file__).resolve().parent.parent / "configs"
        / "train_deeper_rp_adain.yaml")


def test_fixture_is_at_the_yamls_widths():
    """The fixture's network is the yaml's adain at its rp_blocks and
    hidden_dim, a 64px batch of 2, and stays small."""
    cfg = yaml.safe_load(YAML.read_text())
    want = {k: cfg[k] for k in ("network", "rp_blocks", "hidden_dim")}
    assert TOOL.SLICE5B["adain_train"] == want
    fx = load_fixture("adain_train")
    assert fx["content"].shape == fx["style"].shape == (2, 64, 64, 3)
    assert len(fx["trajectory"]) == 3
    assert TOOL.SLICE5B_DST["adain_train"].stat().st_size < 2 * 2 ** 20


def test_loss_gradients_and_trajectory_match_rpst():
    """rpst's loss parts and gradients at the fixture's point, and its 3
    Adam steps; every parameter is trained (adain freezes nothing)."""
    state = check_loss_grads_trajectory("adain_train")
    fresh, _ = fixture_bundle("adain_train", load_fixture("adain_train"))
    for (name, p), q in zip(state.model.named_parameters(),
                            fresh.model.parameters()):
        assert not torch.equal(p, q), name
    assert state.frozen == ()
