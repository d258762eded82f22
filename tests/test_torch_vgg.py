"""The frozen VGG of the perceptual loss (rpst_torch.nn.vgg, nn.vgg_folded)
and its weight bridge, against rpst's flax VGG19Encoder, vgg_perceptual_stats
and load_vgg_params, in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.nn.vgg import VGG19Encoder as JVGG
from rpst.nn.vgg import load_vgg_params
from rpst.nn.vgg_folded import perceptual_rp_losses_folded as j_losses
from rpst.nn.vgg_folded import vgg_perceptual_stats as j_stats
from rpst_torch.bridge import (load_vgg_weights, vgg_from_flax,
                               vgg_from_npz, vgg_from_torch,
                               vgg_weights_from_seed)
from rpst_torch.nn.vgg import _TORCH_CONV_INDICES, VGG19Encoder
from rpst_torch.nn.vgg_folded import (perceptual_rp_losses_folded,
                                      vgg_perceptual_stats)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def weights():
    tree = vgg_weights_from_seed(3)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(tree))
    return tree, jax.tree.map(jnp.asarray, tree), vgg


def _images(seed, n, size):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


def test_encoder_matches_flax(weights):
    """Odd sizes included: the ceil-mode pools pad the odd edge."""
    _, jtree, vgg = weights
    for size in (32, 22):
        x = _images(size, 2, size)
        ref = JVGG(num_stages=4).apply(jtree, jnp.asarray(x))
        got = vgg(torch.from_numpy(x))
        assert len(got) == len(ref) == 4
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_encoder_is_frozen(weights):
    assert not any(p.requires_grad for p in weights[2].parameters())


def test_perceptual_stats_match_rpst(weights):
    _, jtree, vgg = weights
    x = _images(0, 2, 32)
    ref_stats, ref_relu4 = jax.jit(lambda v, x: j_stats(v, x, jnp.float32))(
        jtree, jnp.asarray(x))
    stats, relu4 = vgg_perceptual_stats(vgg, torch.from_numpy(x),
                                        torch.float32)
    np.testing.assert_allclose(relu4.numpy(), np.asarray(ref_relu4), **TOL)
    for (m, s), (rm, rs) in zip(stats, ref_stats):
        np.testing.assert_allclose(m.numpy(), np.asarray(rm), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)


def test_folded_losses_match_rpst(weights):
    _, jtree, vgg = weights
    stylized, style, content = (_images(i, 2, 16) for i in (1, 2, 3))
    ref, _ = jax.jit(lambda v, *imgs: j_losses(v, *imgs, 1.0, 3.0,
                                               dtype=jnp.float32))(
        jtree, *map(jnp.asarray, (stylized, style, content)))
    got, total = perceptual_rp_losses_folded(
        vgg, *map(torch.from_numpy, (stylized, style, content)), 1.0, 3.0,
        dtype=torch.float32)
    for k in ("style_loss", "content_loss"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4)
    np.testing.assert_allclose(
        float(total), float(ref["content_loss"] + 3 * ref["style_loss"]),
        rtol=1e-4)


def test_bridge_three_sources_agree_with_rpst_loader(weights, tmp_path):
    """The same weights written as a vgg_normalised-style .pth and as
    tools/convert_vgg.py's .npz load to the flax tree's state_dict here,
    and rpst's load_vgg_params reads the same files to the same tree."""
    vgg = weights[2]
    params = vgg_weights_from_seed(3, num_stages=5)["params"]  # all 14 convs
    pth, npz = tmp_path / "vgg.pth", tmp_path / "vgg.npz"
    sd, arrays = {}, {}
    for i, idx in enumerate(_TORCH_CONV_INDICES):
        k = params[f"conv_{i}"]["Conv_0"]["kernel"]
        b = params[f"conv_{i}"]["Conv_0"]["bias"]
        sd[f"{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"{idx}.bias"] = torch.from_numpy(b)
        arrays[f"w{i}"], arrays[f"b{i}"] = k, b
    torch.save(sd, pth)
    np.savez(npz, **arrays)
    want = vgg.state_dict()
    for got in (load_vgg_weights(pth), load_vgg_weights(npz),
                vgg_from_torch({k: v.numpy() for k, v in sd.items()}),
                vgg_from_npz(arrays)):
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    for path in (pth, npz):
        _, ref = load_vgg_params(str(path), num_stages=4)
        for name, conv in ref["params"].items():
            np.testing.assert_array_equal(
                np.asarray(conv["Conv_0"]["kernel"]),
                params[name]["Conv_0"]["kernel"])


def test_vgg_weights_from_seed_is_deterministic():
    a, b, c = (vgg_weights_from_seed(s) for s in (5, 5, 6))
    flat = lambda t: [v for conv in t["params"].values()  # noqa: E731
                      for v in conv["Conv_0"].values()]
    assert all(np.array_equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not np.array_equal(flat(a)[2], flat(c)[2])
    assert len(a["params"]) == 10
    k = a["params"]["conv_9"]["Conv_0"]["kernel"]
    assert k.shape == (3, 3, 256, 512) and k.dtype == np.float32
    np.testing.assert_allclose(k.std(), np.sqrt(2 / (9 * 256)), rtol=0.02)
