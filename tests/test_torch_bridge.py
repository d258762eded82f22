"""rpst_torch.bridge: flax params and reference checkpoints into the port,
against the flax tree itself and tools/export_reference_checkpoint.py's
output."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.config import load_config
from rpst.models import build_model as j_build_model
from rpst_torch.bridge import (from_flax_params, from_reference_checkpoint,
                               load_weights)
from rpst_torch.models import build_model

REPO = Path(__file__).resolve().parent.parent
CFG = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=3,
           hidden_dim=8, attention="none", img_size=16)


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_reference_checkpoint",
        REPO / "tools" / "export_reference_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def flax_params():
    x = jnp.zeros((1, 16, 16, 3))
    model = j_build_model(load_config(CFG)).model
    return jax.device_get(model.init(jax.random.PRNGKey(3), x, x)["params"])


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_from_flax_params_names_and_layout(flax_params):
    sd = from_flax_params(flax_params)
    bundle = build_model(load_config(CFG))
    assert set(sd) == set(bundle.model.state_dict())
    bundle.load_state_dict(sd)  # strict: every port parameter is covered
    k = np.asarray(flax_params["rp_decoder"]["block_2"]["PadConv_0"]
                   ["Conv_0"]["kernel"])  # HWIO (3, 3, 8, 3)
    w = sd["rp_decoder.block_2.PadConv_0.Conv_0.weight"].numpy()  # OIHW
    assert w.shape == (3, 8, 3, 3)
    np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))


def test_reference_pth_loads_like_flax_tree(flax_params, tmp_path):
    """export_tree -> torch.save -> load_weights == from_flax_params."""
    exported = _export_tool().export_tree(flax_params)
    assert set(exported) == {"encoder", "decoder"}
    path = tmp_path / "ref.pth"
    torch.save({part: {k: torch.from_numpy(np.array(v))
                       for k, v in sd.items()}
                for part, sd in exported.items()}, path)
    got = load_weights(path)
    want = from_flax_params(flax_params)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("prefix", ["", "params/"])
def test_npz_of_flax_paths(flax_params, tmp_path, prefix):
    path = tmp_path / "w.npz"
    np.savez(path, content=np.zeros(3, np.float32),
             **{prefix + k: v for k, v in _flat(flax_params)})
    got = load_weights(path)
    want = from_flax_params(flax_params)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_rejects_unported_checkpoint_state(flax_params):
    """A key rpst's export never writes is refused. The inception 1x1
    convs' ``{i}.inception.{j}.0.*``, which this case refused until the
    port built them (the name kept), load onto ``inception_{j}``."""
    exported = _export_tool().export_tree(flax_params)
    exported["encoder"]["0.inception.0.0.weight"] = np.ones((8, 8, 1, 1))
    got = from_reference_checkpoint(exported)
    assert float(got["rp_shared_encoder.block_0.inception_0.weight"]
                 .sum()) == 64.0
    exported["encoder"]["0.norm.running_mean"] = np.zeros(8)
    with pytest.raises(ValueError, match="only plain Conv2dBlocks"):
        from_reference_checkpoint(exported)
    with pytest.raises(KeyError):
        from_reference_checkpoint({"decoder": exported["decoder"]})
    with pytest.raises(ValueError, match=".pth or .npz"):
        load_weights("weights.ckpt")
