"""``grad_accum`` and ``remat`` of the port's train step
(``rpst_torch.train.step``) on the CPU, against rpst's
``make_train_step`` / ``_accumulate_grads`` and against the port's own
plain step.

Small models (rp_blocks 3, hidden 8, 32px, batch 4), where float32
rounding is far below the bounds: loss parts rtol 1e-4; gradients rtol
5e-3 with atol 1e-4 x the tensor's max; moved running statistics 1e-5;
the later losses of a 3-step Adam trajectory rtol 1e-3 (Adam's first steps
move each weight by about lr whatever its gradient's size); a remat step
against the plain step bit for bit where the recompute runs the same ops
(the CPU's plain versions), else 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from rpst.config import load_config as j_config
from rpst.models import build_model as j_build_model
from rpst.train.step import (TrainState as JState, _accumulate_grads,
                             make_optimizer, make_train_step)
from rpst_torch import bridge
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.train.step import create_train_state, train_step

SMALL = dict(rp_blocks=3, hidden_dim=8, img_size=32, batch_size=4,
             content_weight=1.0, style_weight=2.0, lr=1e-3, lr_decay=0.5)
CASES = {
    # BatchNorm in every encoder block: each microbatch takes its own
    # batch statistics and moves the running ones
    "se": dict(network="multi_adain", attention="se"),
    # the folded flagship (plain versions of B1-B3 on the CPU): no BN
    "folded": dict(network="multi_adain", exec_strategy="folded"),
}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), dict(tree))


def _setup(case, **over):
    """(rpst bundle, its variables, the port's bundle and VGG, c, s, rpst's
    vgg_vars): the same weights on both sides."""
    cfg = dict(SMALL, **CASES[case], **over)
    rng = np.random.default_rng(0)
    c, s = (rng.random((4, 32, 32, 3), dtype=np.float32) for _ in range(2))
    jb = j_build_model(j_config(cfg))
    v = jax.tree.map(np.array, dict(jb.model.init(
        jax.random.PRNGKey(1), jnp.asarray(c), jnp.asarray(s))))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            v["batch_stats"])
    pb = build_model(load_config(cfg))
    pb.load_state_dict({
        **bridge.from_flax_params(_np_tree(v["params"])),
        **bridge.from_flax_batch_stats(_np_tree(v.get("batch_stats", {})))})
    vgg = VGG19Encoder()
    vgg.load_state_dict(bridge.vgg_from_flax(bridge.vgg_weights_from_seed(1)))
    vgg_vars = jax.tree.map(jnp.asarray, bridge.vgg_weights_from_seed(1))
    return jb, v, pb, vgg, c, s, vgg_vars


def _port_steps(pb, vgg, c, s, n=3):
    """n steps; (per-step parts, the first step's gradients before Adam)."""
    state = create_train_state(pb)
    first = {}

    def keep(optimizer, args, kwargs):
        if not first:
            first.update({name: p.grad.clone()
                          for name, p in pb.model.named_parameters()})

    hook = state.optimizer.register_step_pre_hook(keep)
    parts = [train_step(state, vgg, torch.from_numpy(c), torch.from_numpy(s))
             for _ in range(n)]
    hook.remove()
    return parts, first, state


def _port_names64(tree):
    """A flax gradient tree -> {port name: float64 tensor} (the bridge's
    conversion, without its float32 cast)."""
    out = {}
    for key, g in bridge._flatten(tree):
        g = np.asarray(g, np.float64)
        stem, _, leaf = key.rpartition(".")
        if leaf == "kernel":
            leaf = "weight"
            g = g.transpose(3, 2, 0, 1) if g.ndim == 4 else g.T
        elif leaf == "scale" and stem.rpartition(".")[2].startswith("bn"):
            leaf = "weight"
        out[f"{stem}.{leaf}"] = torch.from_numpy(np.array(g))
    return out


def _f64_accumulated(jb, v, vgg_vars, c, s, accum):
    """rpst's accumulated gradient in float64 (JAX's float64 mode, the
    feature statistics in float64: the fixture tool's ``ld_f64_stats``):
    the mean of the microbatches' gradients, each in train mode on its own
    batch statistics, as ``_accumulate_grads``'s scan (whose float32 carry
    does not run in float64) computes it."""
    from test_torch_sel_multi_adain import TOOL
    jax.config.update("jax_enable_x64", True)
    undo = TOOL.ld_f64_stats()
    try:
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), dict(t))
        params = f64(v["params"])
        extra = {k: f64(x) for k, x in v.items() if k != "params"}
        vv = f64(vgg_vars)

        def loss_fn(p, x, y):
            total, (_, muts) = jb.loss({"params": p, **extra}, vv, x, y,
                                       train=True)
            return total

        mb = c.shape[0] // accum
        grads = [jax.grad(loss_fn)(
            params, jnp.asarray(c[i * mb:(i + 1) * mb], jnp.float64),
            jnp.asarray(s[i * mb:(i + 1) * mb], jnp.float64))
            for i in range(accum)]
        mean = jax.tree.map(lambda *g: sum(g) / accum, *grads)
        return _port_names64(jax.tree.map(np.asarray, mean))
    finally:
        undo()
        jax.config.update("jax_enable_x64", False)


def _close_grads(got, want_tree, got64=None, want64=None):
    """The port's first-step gradients against rpst's at 1e-4 of max, or,
    where float32 rounding is more (the SE BatchNorms' backward amplifies
    it: both frameworks' plain SE gradients sit up to 1.4e-3 of max apart
    here), by the slice-5b rule: the two float64 gradients (``got64``,
    ``want64``) agree to 1e-6 of max and the float32 ones within 2 x the
    larger of the two frameworks' own float32 errors."""
    want = bridge.from_flax_params(_np_tree(want_tree))
    assert set(got) == set(want)
    for name, g in want.items():
        size = max(float(g.abs().max()), 1e-30)
        atol = 1e-4 * size
        if want64 is not None:
            torch.testing.assert_close(got64[name], want64[name], rtol=0,
                                       atol=1e-6 * size, msg=f"{name} f64")
            own = max(float((got[name].double() - got64[name]).abs().max()),
                      float((g.double() - want64[name]).abs().max()))
            atol = max(atol, 2 * own)
        torch.testing.assert_close(got[name], g, rtol=5e-3, atol=atol,
                                   msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_grad_accum_matches_rpsts_step(case):
    """grad_accum 2 against rpst's: the first step's averaged gradients
    (rpst's ``_accumulate_grads``), the loss parts of 3 Adam steps (one
    update and one schedule count a step), and the running statistics
    after them (two momentum moves a step with BatchNorm)."""
    jb, v, pb, vgg, c, s, vgg_vars = _setup(case, grad_accum=2)
    tx = make_optimizer(jb.cfg)
    params = v["params"]
    extra = {k: x for k, x in v.items() if k != "params"}
    state = JState(step=jnp.zeros((), jnp.int32), params=params, extra=extra,
                   opt_state=tx.init(params), rng=jax.random.PRNGKey(0))

    def loss_fn(p, e, x, y, lab):
        total, (parts, muts) = jb.loss({"params": p, **e}, vgg_vars, x, y,
                                       train=True)
        return total, (parts, muts)

    _, ref_parts0, _, ref_grads = _accumulate_grads(
        jax.value_and_grad(loss_fn, has_aux=True), state, 2, jnp.asarray(c),
        jnp.asarray(s))
    step = make_train_step(jb, tx)
    ref_losses = []
    for _ in range(3):
        state, p = step(state, vgg_vars, jnp.asarray(c), jnp.asarray(s))
        ref_losses.append(p)
    parts, first, pstate = _port_steps(pb, vgg, c, s)
    # the same first step in float64 on both sides
    _, _, p64, _, _, _, _ = _setup(case, grad_accum=2)
    p64.model.double()
    p64.folded_dtype = lambda: torch.float64
    _, first64, _ = _port_steps(p64, vgg.double(), c.astype(np.float64),
                                s.astype(np.float64), n=1)
    vgg.float()
    _close_grads(first, ref_grads, first64,
                 _f64_accumulated(jb, v, vgg_vars, c, s, 2))
    for k in ("content_loss", "style_loss", "total_loss"):
        np.testing.assert_allclose(float(parts[0][k]), float(ref_parts0[k]),
                                   rtol=1e-4, err_msg=k)
        np.testing.assert_allclose([float(p[k]) for p in parts],
                                   [float(p[k]) for p in ref_losses],
                                   rtol=1e-3, err_msg=k)
    assert pstate.step == 3
    moved = bridge.from_flax_batch_stats(_np_tree(state.extra.get(
        "batch_stats", {})))
    bufs = dict(pb.model.named_buffers())
    assert set(moved) == set(bufs)
    for name, buf in moved.items():
        np.testing.assert_allclose(bufs[name].numpy(), buf.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_without_batchnorm_is_the_full_batch(accum):
    """Without BatchNorm (the folded flagship) the averaged microbatch
    gradient is the full batch's (every loss is a batch mean over equal
    chunks), and so are the loss parts."""
    _, _, pb, vgg, c, s, _ = _setup("folded")
    full, g_full, _ = _port_steps(pb, vgg, c, s, n=1)
    _, _, pb2, _, _, _, _ = _setup("folded", grad_accum=accum)
    acc, g_acc, _ = _port_steps(pb2, vgg, c, s, n=1)
    for k in ("content_loss", "style_loss", "total_loss"):
        np.testing.assert_allclose(float(acc[0][k]), float(full[0][k]),
                                   rtol=1e-5, err_msg=k)
    for name, g in g_full.items():
        size = float(g.abs().max())
        torch.testing.assert_close(g_acc[name], g, rtol=1e-4,
                                   atol=1e-5 * size, msg=name)


def test_grad_accum_with_batchnorm_is_not_the_full_batch():
    """With BatchNorm (SE attention) each microbatch normalizes by its own
    statistics, as rpst's: the averaged gradient is not the full batch's."""
    _, _, pb, vgg, c, s, _ = _setup("se")
    _, g_full, _ = _port_steps(pb, vgg, c, s, n=1)
    _, _, pb2, _, _, _, _ = _setup("se", grad_accum=2)
    _, g_acc, _ = _port_steps(pb2, vgg, c, s, n=1)
    name = "rp_shared_encoder.block_0.PadConv_0.Conv_0.weight"
    rel = float((g_acc[name] - g_full[name]).abs().max()
                / g_full[name].abs().max())
    assert rel > 1e-3


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_is_the_plain_step(case):
    """remat (the whole loss under one non-reentrant checkpoint) gives the
    plain step's loss parts, gradients and running statistics: the
    recompute leaves the BatchNorm statistics where the forward moved them
    (once), as rpst's pure ``jax.checkpoint``; so does remat with
    grad_accum 2."""
    _, _, pb, vgg, c, s, _ = _setup(case)
    plain, g_plain, _ = _port_steps(pb, vgg, c, s, n=1)
    for over in (dict(remat=True), dict(remat=True, grad_accum=2)):
        _, _, ref, _, _, _, _ = _setup(case, **{
            k: x for k, x in over.items() if k != "remat"})
        want, g_want, _ = _port_steps(ref, vgg, c, s, n=1)
        _, _, pr, _, _, _, _ = _setup(case, **over)
        got, g_got, _ = _port_steps(pr, vgg, c, s, n=1)
        for k, x in want[0].items():
            torch.testing.assert_close(got[0][k], x, rtol=1e-6, atol=0,
                                       msg=k)
        for name, g in g_want.items():
            torch.testing.assert_close(g_got[name], g, rtol=1e-6,
                                       atol=1e-7 * float(g.abs().max()),
                                       msg=name)
        for (name, b), r in zip(pr.model.named_buffers(),
                                ref.model.buffers()):
            torch.testing.assert_close(b, r, rtol=0, atol=0, msg=name)
    if case == "se":  # the plain step moved them, once
        assert float((dict(pb.model.named_buffers())[
            "rp_shared_encoder.block_0.SEBottleneck_0.bn1.running_var"]
            - dict(_setup(case)[2].model.named_buffers())[
            "rp_shared_encoder.block_0.SEBottleneck_0.bn1.running_var"])
            .abs().max()) > 0


def test_remat_matches_rpsts_remat_step():
    """rpst's remat step (``jax.checkpoint`` of the loss) against the
    port's, SE flagship: the loss parts of 3 Adam steps and the running
    statistics after them."""
    jb, v, pb, vgg, c, s, vgg_vars = _setup("se", remat=True)
    tx = make_optimizer(jb.cfg)
    params = v["params"]
    extra = {k: x for k, x in v.items() if k != "params"}
    state = JState(step=jnp.zeros((), jnp.int32), params=params, extra=extra,
                   opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    step = make_train_step(jb, tx)
    ref = []
    for _ in range(3):
        state, p = step(state, vgg_vars, jnp.asarray(c), jnp.asarray(s))
        ref.append(float(p["total_loss"]))
    parts, _, _ = _port_steps(pb, vgg, c, s)
    np.testing.assert_allclose([float(p["total_loss"]) for p in parts], ref,
                               rtol=1e-3)
    moved = bridge.from_flax_batch_stats(_np_tree(state.extra["batch_stats"]))
    bufs = dict(pb.model.named_buffers())
    for name, buf in moved.items():
        np.testing.assert_allclose(bufs[name].numpy(), buf.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_refusals_follow_rpst():
    """A batch grad_accum does not divide raises (rpst asserts); the target
    cache stays refused with grad_accum (rpst's ``make_train_step``)."""
    _, _, pb, vgg, c, s, _ = _setup("folded", grad_accum=3)
    state = create_train_state(pb)
    with pytest.raises(ValueError, match="not divisible by grad_accum 3"):
        train_step(state, vgg, torch.from_numpy(c), torch.from_numpy(s))
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_step(state, vgg, torch.from_numpy(c), torch.from_numpy(s),
                   targets=(None, None))
