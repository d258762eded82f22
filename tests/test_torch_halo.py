"""The halo modes of B2 / B3 and the row-shard VJP (rpst_torch.ops.folded_conv)
against rpst's own forms of them, on the CPU at small widths.

  * ``fused_folded_conv_grad_input(row_rings=False)``'s plain version vs
    rpst's Pallas kernel in interpret mode (``row_rings=False``);
  * ``fused_folded_conv_grad_weight(rings=...)``'s plain version vs rpst's
    in interpret mode with the same rings, dense and (the port's own mode)
    listed, which is the dense result on the fold's 36 blocks;
  * ``fused_folded_conv_ring_grads`` vs rpst's (XLA);
  * ``FoldedConvActHalo``'s gradients vs ``jax.vjp`` of rpst's
    ``folded_conv_act_halo`` (interpret mode), and vs torch autograd of B1's
    plain version with the rings as inputs (an oracle that shares no code
    with the backward).

float32 within 1e-4 (sums of at most 9 x 4C products of N(0, 1) values
scaled by 0.1). The kernels themselves run on the card only:
tests/test_torch_cuda_kernels.py ``test_halo_modes_match_plain_on_card``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.ops.folded import fold_conv_kernel as j_fold_conv_kernel
from rpst.ops.pallas import folded_conv as jfc
from rpst_torch.ops import folded_conv as fc
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
# (n, h, w, c, co): C4 = 128 (rpst's lane-filling gate), a ragged 16 -> 32,
# a 2-row shard
SHAPES = [(2, 8, 16, 32, 32), (1, 5, 7, 4, 8), (2, 2, 6, 8, 8)]


def _case(seed, n, h, w, c, co):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, 4 * c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    kf = np.array(j_fold_conv_kernel(jnp.asarray(k)))
    b = (rng.standard_normal(4 * co) * 0.1).astype(np.float32)
    rings = rng.standard_normal((n, 2, w, 4 * c)).astype(np.float32)
    gz = rng.standard_normal((n, h, w, 4 * co)).astype(np.float32)
    khat = np.ascontiguousarray(np.transpose(kf[::-1, ::-1], (0, 1, 3, 2)))
    return x, kf, b, rings, gz, khat


@pytest.mark.parametrize("shape", SHAPES)
def test_grad_input_halo_matches_rpst_interpret(shape):
    _, _, _, _, gz, khat = _case(0, *shape)
    ref = jfc.fused_folded_conv_grad_input(jnp.asarray(gz),
                                           jnp.asarray(khat),
                                           interpret=True, row_rings=False)
    got = fc.fused_folded_conv_grad_input(torch.from_numpy(gz),
                                          torch.from_numpy(khat),
                                          row_rings=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # and it differs from the one-device mode exactly by the ring rows
    full = fc.fused_folded_conv_grad_input(torch.from_numpy(gz),
                                           torch.from_numpy(khat))
    h = shape[1]
    rows = [0, 1, h - 2, h - 1]
    inner = [r for r in range(h) if r not in rows]
    np.testing.assert_array_equal(full[:, inner].numpy(),
                                  got[:, inner].numpy())
    assert not torch.equal(full, got)


@pytest.mark.parametrize("listed", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_weight_rings_matches_rpst_interpret(shape, listed):
    x, _, _, rings, gz, _ = _case(1, *shape)
    rdk, rdb = jfc.fused_folded_conv_grad_weight(
        jnp.asarray(x), jnp.asarray(gz), interpret=True,
        rings=jnp.asarray(rings))
    rdk = np.asarray(rdk)
    if listed:  # the fold's 36 blocks of the dense result, zeros elsewhere
        c4, c4o = rdk.shape[2:]
        mask = fc.listed_blocks().numpy()[:, :, :, None, :, None]
        rdk = (rdk.reshape(3, 3, 4, c4 // 4, 4, c4o // 4) * mask).reshape(
            rdk.shape)
    dk, db = fc.fused_folded_conv_grad_weight(
        torch.from_numpy(x), torch.from_numpy(gz), listed,
        torch.from_numpy(rings))
    assert dk.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(dk.numpy(), rdk, **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(rdb), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_ring_grads_match_rpst(shape):
    _, _, _, _, gz, khat = _case(2, *shape)
    ra, rb = jfc.fused_folded_conv_ring_grads(jnp.asarray(gz),
                                              jnp.asarray(khat))
    a, b = fc.fused_folded_conv_ring_grads(torch.from_numpy(gz),
                                           torch.from_numpy(khat))
    assert a.shape == b.shape == (shape[0], 1, shape[2], 4 * shape[3])
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), **TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), **TOL)


@pytest.mark.parametrize("alpha", [0.2, 0.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_halo_vjp_matches_rpst(shape, alpha):
    """Every gradient of FoldedConvActHalo (x, k, b, above, below) against
    rpst's ``folded_conv_act_halo`` VJP (interpret-mode kernels) and against
    autograd of B1's plain version."""
    x, kf, b, rings, _, _ = _case(3, *shape)
    above, below = rings[:, :1], rings[:, 1:]
    g = np.random.default_rng(4).standard_normal(
        shape[:3] + (4 * shape[4],)).astype(np.float32)
    y_ref, vjp = jax.vjp(
        lambda *t: jfc.folded_conv_act_halo(alpha, True, *t),
        *map(jnp.asarray, (x, kf, b, above, below)))
    refs = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
          for a in (x, kf, b, above, below)]
    y = fc.folded_conv_act_halo(*ts, alpha=alpha)
    got = torch.autograd.grad(y, ts, torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    oracle_in = [t.detach().clone().requires_grad_(True) for t in ts]
    y_o = fc.fused_folded_conv_plain(
        *oracle_in[:3], alpha,
        rings=torch.cat(oracle_in[3:], dim=1))
    oracle = torch.autograd.grad(y_o, oracle_in, torch.from_numpy(g))
    for name, a, r, o in zip(("dx", "dk", "db", "d_above", "d_below"), got,
                             refs, oracle):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), o.numpy(), **TOL,
                                   err_msg=name)


def test_halo_with_reflect_rows_is_the_one_device_conv():
    """With the reflect ring as its rows, the halo VJP (its row gradients
    routed back through ``_row_ring``'s autograd) gives FoldedConvAct's
    gradients: rpst's degenerate one-shard case."""
    from rpst_torch.ops.folded import _row_ring
    x, kf, b, _, _, _ = _case(5, *SHAPES[0])
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        x.shape[:3] + (kf.shape[3],)).astype(np.float32))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, kf, b)]
    y = fc.folded_conv_act_halo(*xs, _row_ring(xs[0], True),
                                _row_ring(xs[0], False))
    got = torch.autograd.grad(y, xs, g)
    ys = [t.detach().clone().requires_grad_(True) for t in xs]
    ref = torch.autograd.grad(fc.folded_conv_act(*ys, 0.2), ys, g)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), **TOL)


def test_rings_override_refuses_a_gradient():
    x = torch.zeros(1, 4, 4, 16, requires_grad=True)
    k, b = torch.zeros(3, 3, 16, 16), torch.zeros(16)
    with pytest.raises(NotImplementedError, match="folded_conv_act_halo"):
        fc.fused_folded_conv(x, k, b, rings=torch.zeros(1, 2, 4, 16))
