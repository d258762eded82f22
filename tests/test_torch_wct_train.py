"""wct training of the port on the CPU: the frozen-encoder resume
(rpst's ``freeze_prefixes``: ``optax.multi_transform`` with ``set_to_zero``
for the encoder when a wct run resumes, ``train.py:158``) and the loss,
gradients and trajectory against ``tests/fixtures/torch_port_wct_train.npz``
(``tools/make_torch_port_fixture.py --wct-train``: 64px, batch 2, hidden
32, rpst's 3 steps with the encoder frozen).

rpst refuses to restore a checkpoint saved without the freeze into a frozen
run (its optimizer state is another tree); the port refuses it too
(``train.checkpoint.restore_checkpoint``), and both accept a frozen run's
own checkpoint. Tolerances are test_torch_mrf.py's, but the gradients'
floor is ``WCT_F64_ATOL``; the frozen encoder is held bit for bit.
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rpst.config import load_config as jax_load_config
from rpst.models import build_model as jax_build_model
from rpst.train import checkpoint as jax_checkpoint
from rpst.train.step import create_train_state as jax_create_train_state
from rpst.train.step import make_optimizer as jax_make_optimizer
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.nn.blocks import init_torch_default
from rpst_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from rpst_torch.train.step import (create_train_state, make_optimizer,
                                   reference_lr_schedule, trainable_parameters)
from test_torch_mrf import (check_loss_grads_trajectory, corpus,
                            fixture_bundle, load_fixture, run_train)
from test_torch_sel_multi_adain import one_torch_thread  # noqa: F401

# wct's gradients against rpst's, float64 and float32: 1e-3 x max, the wct
# stylize's tolerance: both frameworks whiten in float32 (wct_dtype) even in
# float64, two 512 x 512 eigh whose different algorithms move the fused
# features (the decoder's float64 gradients read 1.3e-4 of max apart on the
# CPU; on the card, cuSOLVER's eigh, the float32 ones 6.7e-4)
WCT_F64_ATOL = 1e-3
SMALL = dict(network="wct", rp_blocks=3, hidden_dim=4, img_size=32,
             lr=1e-2, lr_decay=0.5)


def test_frozen_optimizer_matches_optax():
    """Three Adam updates of a two-module tree with one module frozen: the
    trained leaves move as optax's multi_transform moves them, the frozen
    ones not at all, and the optimizer holds no state for them."""
    rng = np.random.default_rng(0)
    shapes = {"encoder": (3, 4), "decoder": (4, 2)}
    init = {k: rng.normal(size=v).astype(np.float32)
            for k, v in shapes.items()}
    grads = [{k: rng.normal(size=v).astype(np.float32)
              for k, v in shapes.items()} for _ in range(3)]
    cfg = load_config(dict(SMALL))
    tx = jax_make_optimizer(jax_load_config(dict(SMALL)), ("encoder",))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, params)
        params = optax.apply_updates(params, upd)

    model = torch.nn.Module()
    for k, v in init.items():
        model.register_parameter(k, torch.nn.Parameter(torch.from_numpy(
            v.copy())))
    trained = trainable_parameters(model, ("encoder",))
    assert trained == [model.decoder] and not model.encoder.requires_grad
    opt = make_optimizer(cfg, trained)
    schedule = reference_lr_schedule(cfg.lr, cfg.lr_decay)
    for i, g in enumerate(grads):
        model.decoder.grad = torch.from_numpy(g["decoder"])
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        opt.step()
    np.testing.assert_allclose(model.decoder.detach().numpy(),
                               np.asarray(params["decoder"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(model.encoder.detach().numpy(),
                                  init["encoder"])
    np.testing.assert_array_equal(np.asarray(params["encoder"]),
                                  init["encoder"])
    assert model.encoder not in opt.state and len(opt.state) == 1


def test_loss_gradients_and_trajectory_with_the_encoder_frozen():
    """rpst's loss parts and gradients (the encoder's are zero: the WCT
    fuse detaches its inputs), and 3 steps with the encoder frozen as on a
    resume: rpst's trajectory, the encoder bit-unchanged and without Adam
    state."""
    state = check_loss_grads_trajectory("wct_train", freeze=("encoder",),
                                        f64_atol=WCT_F64_ATOL)
    fx = load_fixture("wct_train")
    fresh, _ = fixture_bundle("wct_train", fx)
    for (name, p), q in zip(state.model.named_parameters(),
                            fresh.model.parameters()):
        if name.startswith("encoder."):
            assert torch.equal(p, q) and p not in state.optimizer.state, name
        else:
            assert not torch.equal(p, q), name
    assert state.frozen == ("encoder",)


def _small_state(frozen):
    bundle = build_model(load_config(dict(SMALL)))
    init_torch_default(bundle.model, 0)
    return create_train_state(bundle, freeze_prefixes=frozen)


def test_unfrozen_checkpoint_is_refused_by_a_frozen_run(tmp_path):
    """A checkpoint of a run without the freeze cannot resume a frozen run
    (the optimizer covers other parameters); a frozen run's own checkpoint
    can."""
    path = save_checkpoint(tmp_path / "plain", _small_state(()))
    with pytest.raises(ValueError, match="frozen: encoder"):
        restore_checkpoint(path, _small_state(("encoder",)))
    frozen = save_checkpoint(tmp_path / "frozen", _small_state(("encoder",)))
    restore_checkpoint(frozen, _small_state(("encoder",)))


def test_rpst_refuses_an_unfrozen_checkpoint_too():
    """The behaviour the port's refusal follows, at rpst's smallest size:
    orbax restores a frozen run's own checkpoint and refuses one saved
    without the freeze."""
    bundle = jax_build_model(jax_load_config(dict(SMALL, img_size=8,
                                                  rp_blocks=2)))
    x = jnp.zeros((1, 8, 8, 3))
    from rpst.nn.vgg import init_vgg_params
    _, vgg_vars = init_vgg_params(jax.random.PRNGKey(1), num_stages=4)
    plain, _ = jax_create_train_state(bundle, jax.random.PRNGKey(0), x, x,
                                      vgg_vars)
    frozen, _ = jax_create_train_state(bundle, jax.random.PRNGKey(0), x, x,
                                       vgg_vars, freeze_prefixes=("encoder",))
    with tempfile.TemporaryDirectory() as tmp:
        p = jax_checkpoint.save_checkpoint(os.path.join(tmp, "a"), plain)
        with pytest.raises(ValueError):
            jax_checkpoint.restore_checkpoint(p, frozen)
        q = jax_checkpoint.save_checkpoint(os.path.join(tmp, "b"), frozen)
        jax_checkpoint.restore_checkpoint(q, frozen)


def test_driver_resume_freezes_the_encoder(tmp_path):
    """train_torch.py: a wct run with ``resume: true`` and no checkpoint
    trains frozen from the start; resuming it loads and keeps the encoder
    bit for bit; a run saved without the freeze is refused on resume."""
    root = corpus(tmp_path)
    over = dict(snapshot_save_iter=2, max_iter=3)
    run_train(root, "wct", "_frozen", resume=True, **over)
    ckpt = root / "train_wct_frozen" / "checkpoints"
    first = torch.load(ckpt / "2" / "state.pt", weights_only=True)
    lines = run_train(root, "wct", "_frozen", resume=True, **over)
    assert [ln["step"] for ln in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(ln["total_loss"]) and ln["skipped"] == 0.0
               for ln in lines)
    last = torch.load(ckpt / "4" / "state.pt", weights_only=True)
    bundle = build_model(load_config(dict(SMALL, hidden_dim=8)))
    init_torch_default(bundle.model, 0)
    enc = [k for k in last["params"] if k.startswith("encoder.")]
    assert enc and all(torch.equal(last["params"][k], first["params"][k])
                       and torch.equal(last["params"][k],
                                       bundle.model.state_dict()[k])
                       for k in enc)
    assert any(not torch.equal(last["params"][k], first["params"][k])
               for k in last["params"] if k.startswith("decoder."))
    run_train(root, "wct", "_plain", **over)
    with pytest.raises(ValueError, match="without the freeze"):
        run_train(root, "wct", "_plain", resume=True, **over)
    assert json.loads((root / "train_wct_plain" / "logs" / "metrics.jsonl")
                      .read_text().splitlines()[-1])["step"] == 2
