"""seg_adain (SegAdaINRP: adain's stylize under ``adain_rp`` and a
segmentation head trained on labelled content) of the port on the CPU.

Live rpst at op size: ``cross_entropy_loss`` (the same size, an upsampling
and a downsampling resize of the logits, the ignore label, the empty
denominator) with its gradient, ``jax.image.resize(..., "linear")``
against the port's antialiased bilinear resize, ``convert_label`` and
``CityscapesDataset`` on a written side-by-side image, the module's loss
against flax; optax's Adam count for parameters that a step leaves without
gradient. At model size against ``tests/fixtures/torch_port_seg_adain.npz``
(``tools/make_torch_port_fixture.py --seg-adain``: 64px, batch 2, hidden
32, labels in -1 .. 18, the loss and trajectory with labels). Tolerances
are test_torch_mrf.py's (ops 1e-5, modules 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from rpst.data import CityscapesDataset as JaxCityscapesDataset
from rpst.data.cityscapes import convert_label as jax_convert_label
from rpst.models.seg_adain import SegAdaINRP as JaxSegAdaINRP
from rpst.models.seg_adain import cross_entropy_loss as jax_ce
from rpst.nn.vgg import VGG19Encoder as JaxVGG
from rpst_torch.bridge import (from_flax_params,
                               seg_adain_weights_from_seed, vgg_from_flax,
                               vgg_weights_from_seed)
from rpst_torch.config import load_config
from rpst_torch.data import (CityscapesDataset, InfiniteLoader,
                             convert_label)
from rpst_torch.models import build_model
from rpst_torch.models.fast_path_q8_std import std_q8_plan
from rpst_torch.models.seg_adain import (CITYSCAPES_CLASS_WEIGHTS,
                                         SegAdaINRP, cross_entropy_loss,
                                         resize_logits)
from rpst_torch.nn.blocks import init_torch_default
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.train.step import create_train_state, train_step
from test_torch_mrf import (OP_TOL, TOL, check_loss_grads_trajectory,
                            check_q8, check_stylize, check_steps, corpus,
                            load_fixture, port_log, run_serve, run_train)
from test_torch_sel_multi_adain import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("size,target", [
    ((8, 8), (8, 8)), ((4, 5), (9, 13)), ((9, 7), (4, 3))],
    ids=["same", "upsample", "downsample"])
def test_cross_entropy_matches_rpst(size, target):
    """Value and gradient in the logits; labels -1 (ignored) .. 6."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, *size, 7)).astype(np.float32)
    label = rng.integers(-1, 7, (2, *target)).astype(np.int32)
    weight = np.linspace(0.5, 1.5, 7).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(lambda x: jax_ce(
        x, jnp.asarray(label), jnp.asarray(weight)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy_loss(x, torch.from_numpy(label),
                             torch.from_numpy(weight))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), **OP_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), **OP_TOL)


@pytest.mark.parametrize("size,target", [((4, 5), (9, 13)), ((9, 7), (4, 3)),
                                         ((16, 12), (8, 6))])
def test_resize_matches_jax_linear(size, target):
    """jax.image.resize 'linear' antialiases where it shrinks; the port's
    bilinear interpolation with antialias there computes the same."""
    x = np.random.default_rng(1).normal(size=(2, *size, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *target, 3), method="linear")
    got = resize_logits(torch.from_numpy(x), target)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OP_TOL)


def test_cross_entropy_ignore_and_empty():
    """Every pixel ignored: 0 (the denominator is max(sum of weights, 1));
    no weights: the plain mean over the valid pixels."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(1, 3, 3, 4)).astype(np.float32)
    none = np.full((1, 3, 3), -1, np.int32)
    assert float(cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(none))) == 0.0
    label = rng.integers(-1, 4, (1, 3, 3)).astype(np.int32)
    np.testing.assert_allclose(
        float(cross_entropy_loss(torch.from_numpy(logits),
                                 torch.from_numpy(label))),
        float(jax_ce(jnp.asarray(logits), jnp.asarray(label))), **OP_TOL)


def test_convert_label_matches_rpst():
    ids = np.arange(-3, 260, dtype=np.int32).reshape(1, -1)
    np.testing.assert_array_equal(convert_label(ids), jax_convert_label(ids))
    train = convert_label(np.arange(0, 34, dtype=np.int32))
    np.testing.assert_array_equal(convert_label(train, inverse=True),
                                  jax_convert_label(train, inverse=True))


def _side_by_side(root, n=2, size=16, height=16, seed=3):
    """Cityscapes-layout PNGs: content | gray label ids (raw 0 .. 33)."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = np.zeros((height, 2 * size, 3), np.uint8)
        img[:, :size] = rng.integers(0, 256, (height, size, 3), np.uint8)
        img[:, size:] = rng.integers(0, 34, (height, size, 1), np.uint8)
        Image.fromarray(img, "RGB").save(root / f"{i}.png")
    return root


@pytest.mark.parametrize("height", [16, 24])
def test_cityscapes_dataset_matches_rpst(tmp_path, height):
    """The content squashed to (s, s), the label half at the file's height
    (24 rows: the loss then resizes the logits)."""
    root = _side_by_side(tmp_path / "seg", height=height)
    got, ref = CityscapesDataset(root, 16), JaxCityscapesDataset(root, 16)
    assert len(got) == len(ref) == 2
    for i in range(2):
        (c, lab), (rc, rlab) = got[i], ref[i]
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_array_equal(lab, rlab)
        assert c.shape == (16, 16, 3) and lab.shape == (height, 16)
        assert lab.dtype == np.int32 and lab.min() >= -1 and lab.max() < 19
    loader = InfiniteLoader(got, 2, num_workers=1, seed=0)
    try:
        content, label = next(loader)
    finally:
        loader.close()
    assert content.shape == (2, 16, 16, 3) and label.shape == (2, height, 16)


def _small(seed=4, seg_loss_weight=1.0):
    rng = np.random.default_rng(seed)
    c, s = (rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(2))
    label = rng.integers(-1, 5, (2, 32, 32)).astype(np.int32)
    jm = JaxSegAdaINRP(rp_blocks=3, hidden_dim=8, class_num=5,
                       seg_hidden_dim=6, seg_loss_weight=seg_loss_weight)
    vgg_vars = vgg_weights_from_seed(1)
    jvgg = JaxVGG(num_stages=4)
    feats = lambda x: jvgg.apply(vgg_vars, x)  # noqa: E731
    v = {"params": seg_adain_weights_from_seed(
        seed, rp_blocks=3, hidden_dim=8, seg_hidden_dim=6, class_num=5)}
    port = SegAdaINRP(rp_blocks=3, hidden_dim=8, class_num=5,
                      seg_hidden_dim=6, seg_loss_weight=seg_loss_weight)
    port.load_state_dict(from_flax_params(v["params"]))
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_vars))
    return jm, v, feats, port, vgg, c, s, label


def test_module_loss_matches_flax():
    """The perceptual parts, and the segmentation loss with labels (the
    head over the content encoding, the Cityscapes weights); none without
    labels; no head at seg_loss_weight 0."""
    jm, v, feats, port, vgg, c, s, label = _small()
    ref = jm.apply(v, feats, jnp.asarray(c), jnp.asarray(s),
                   content_label=jnp.asarray(label), method=jm.loss)
    got = port.loss(vgg, torch.from_numpy(c), torch.from_numpy(s),
                    torch.from_numpy(label))
    assert set(got) == set(ref) == {"style_loss", "content_loss", "seg_loss"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    assert "seg_loss" not in port.loss(vgg, torch.from_numpy(c),
                                       torch.from_numpy(s))
    np.testing.assert_allclose(
        port(torch.from_numpy(c), torch.from_numpy(s)).detach().numpy(),
        np.asarray(jm.apply(v, jnp.asarray(c), jnp.asarray(s))), **TOL)
    assert not hasattr(SegAdaINRP(rp_blocks=3, hidden_dim=8,
                                  seg_loss_weight=0.0), "seg_head")
    assert len(CITYSCAPES_CLASS_WEIGHTS) == 19


def test_stylize_with_labels_names_slice_7():
    """Labels at stylize, which raised until slice 7 (the name kept), are
    taken and read by nothing, as rpst's ``SegAdaINRP`` reads none
    (``seg_adain.py:91-93``): the output equals rpst's with the same labels
    and the port's own without them."""
    jm, v, _, port, _, c, s, label = _small()
    labels = torch.from_numpy(np.clip(label, 0, None))
    got = port(torch.from_numpy(c), torch.from_numpy(s), c_labels=labels,
               s_labels=labels)
    ref = jm.apply(v, jnp.asarray(c), jnp.asarray(s),
                   c_labels=jnp.asarray(labels.numpy()),
                   s_labels=jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    torch.testing.assert_close(
        got, port(torch.from_numpy(c), torch.from_numpy(s)), rtol=0, atol=0)


def test_unlabelled_steps_keep_optax_count_for_the_head():
    """Without labels the head gets jax.grad's zeros: Adam keeps its
    moments and count over them (unchanged weights), so a later labelled
    step updates the head with optax's bias correction at that count."""
    rng = np.random.default_rng(5)
    g = rng.normal(size=(4, 3)).astype(np.float32)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    tx = optax.adam(1e-2)
    st = tx.init(jnp.asarray(w0))
    w = jnp.asarray(w0)
    for grad in (np.zeros_like(g), np.zeros_like(g), g):
        upd, st = tx.update(jnp.asarray(grad), st, w)
        w = optax.apply_updates(w, upd)
    bundle = build_model(load_config(dict(
        network="seg_adain", rp_blocks=3, hidden_dim=4, img_size=32,
        class_num=5, seg_hidden_dim=4, lr=1e-2)))
    init_torch_default(bundle.model, 0)
    state = create_train_state(bundle)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1)))
    c, s = (torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32))
            for _ in range(2))
    head = bundle.model.seg_head.seg_head.block_0.PadConv_0.Conv_0.weight
    before = head.detach().clone()
    for _ in range(2):
        train_step(state, vgg, c, s)
    assert torch.equal(head, before)
    st_head = state.optimizer.state[head]
    assert int(st_head["step"]) == 2 and not st_head["exp_avg"].any()
    # the same update rule on one tensor: two zero steps, then g
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch.optim.Adam([p], lr=1e-2)
    for grad in (np.zeros_like(g), np.zeros_like(g), g):
        p.grad = torch.from_numpy(grad)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6)


# -------------------------------------------------------------- fixture

def test_stylize_matches_rpst():
    check_stylize("seg_adain")


def test_q8_matches_rpst():
    """adain's int8 path on the nested stacks: 5 act scales and 4 B5 launches
    a stylize at hidden 32 (the 2N encode's 128->256, 256->512; the
    decoder's 512->256, 256->128)."""
    check_q8("seg_adain", lambda b: std_q8_plan(*b), {"scales": 5, "B5": 4})


def test_labelled_loss_gradients_and_trajectory_match_rpst():
    fx = load_fixture("seg_adain")
    check_loss_grads_trajectory("seg_adain",
                                label=torch.from_numpy(fx["label"]))


# -------------------------------------------------------------- drivers

def test_drivers_serve_and_train_on_cpu(tmp_path):
    """serve_torch.py standard and q8 (rp_blocks 4 at hidden 32: the 2N
    encode's 128->256 and the decoder's 256->128 are int8, 3 scales);
    train_torch.py without labels and on a side-by-side ``seg_dir``
    (labelled content, seg_loss logged)."""
    root = corpus(tmp_path)
    assert len(run_serve(root, "seg_adain", "standard", rp_blocks=4)) == 2
    with port_log() as lines:
        assert len(run_serve(root, "seg_adain", "q8", rp_blocks=4)) == 2
    assert "Calibrated 3 layer scales" in lines
    plain = run_train(root, "seg_adain")
    check_steps(plain)
    assert all("seg_loss" not in ln for ln in plain)
    seg = _side_by_side(root / "seg", n=3, size=32, height=32)
    with port_log() as lines:
        labelled = run_train(root, "seg_adain", "_seg", seg_dir=str(seg))
    check_steps(labelled)
    assert all(np.isfinite(ln["seg_loss"]) and ln["seg_loss"] > 0
               for ln in labelled)
    assert any("labelled content from seg_dir" in ln for ln in lines)
