"""B6 of the port, ``rpst_torch.ops.flash_attention``, on the CPU: the plain
PyTorch versions (which a CPU tensor takes through every wrapper and through
the autograd Function) against rpst's Pallas kernels in interpret mode (as
tests/test_flash_attention.py runs them), against rpst's dense reference and
against a float64 numpy oracle that shares no code with either.

Tolerances: forward float32 rtol 1e-4, atol 1e-5 (rpst's own,
tests/test_flash_attention.py:17); gradients rtol 1e-3, atol 1e-4 (:66-68);
the LSE 1e-5; bfloat16 2e-2 (about two bf16 steps at O(1) values: P and dS
are rounded to bf16 before their second product, at other places than a
dense softmax rounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.ops.pallas.flash_attention import _dense_attention
from rpst.ops.pallas.flash_attention import flash_attention as jax_flash
from rpst_torch.ops import flash_attention as fa

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
# (N, Nq, Nk, C, scale): square, rectangular (Nq != Nk), batch 2, inputs x 30
CASES = [(2, 64, 64, 32, 1.0), (1, 128, 64, 16, 1.0), (1, 64, 128, 16, 1.0),
         (2, 32, 32, 16, 30.0)]


def _inputs(seed, n, nq, nk, c, scale=1.0):
    """q, k (both x scale, as tests/test_flash_attention.py:93-113 scale
    them), v and an upstream gradient g."""
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=s) * f).astype(np.float32) for s, f in
                 (((n, nq, c), scale), ((n, nk, c), scale), ((n, nk, c), 1.0),
                  ((n, nq, c), 1.0)))


def _oracle(q, k, v, g=None):
    """float64 numpy: (o, lse) and, with an upstream gradient g, (dq, dk,
    dv) of sum(o * g) by the dense softmax backward."""
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = np.einsum("nqc,nkc->nqk", q, k)
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    l = e.sum(-1, keepdims=True)
    p = e / l
    o = np.einsum("nqk,nkc->nqc", p, v)
    lse = (m + np.log(l))[..., 0]
    if g is None:
        return o, lse
    g = g.astype(np.float64)
    dv = np.einsum("nqk,nqc->nkc", p, g)
    dp = np.einsum("nqc,nkc->nqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    return o, lse, (np.einsum("nqk,nkc->nqc", ds, k),
                    np.einsum("nqk,nqc->nkc", ds, q), dv)


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_matches_rpst_interpret_dense_and_oracle(case):
    q, k, v, _ = _inputs(0, *case)
    got = fa.flash_attention(*_t(q, k, v)).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jax_flash(jq, jk, jv, True)),
                               **FWD)
    np.testing.assert_allclose(got, np.asarray(_dense_attention(jq, jk, jv)),
                               **FWD)
    np.testing.assert_allclose(got, _oracle(q, k, v)[0], **FWD)
    np.testing.assert_allclose(fa.dense_attention(*_t(q, k, v)).numpy(), got,
                               **FWD)


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_forward_bf16_matches_rpst_interpret(case):
    q, k, v, _ = _inputs(1, *case)
    got = fa.flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ref = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)
    rounded = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in (q, k, v)]
    np.testing.assert_allclose(got.float().numpy(), _oracle(*rounded)[0],
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", CASES + [(2, 20, 12, 8, 1.0)], ids=str)
def test_lse_matches_oracle(case):
    q, k, v, _ = _inputs(2, *case)
    o, lse = fa.flash_fwd_lse(*_t(q, k, v))
    ref_o, ref_lse = _oracle(q, k, v)
    assert lse.shape == q.shape[:2] and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o.numpy(), ref_o, **FWD)
    np.testing.assert_array_equal(o.numpy(),
                                  fa.flash_fwd(*_t(q, k, v)).numpy())


def _torch_grads(q, k, v, g, dtype=torch.float32):
    leaves = [t.requires_grad_(True) for t in _t(q, k, v, dtype=dtype)]
    out = fa.flash_attention(*leaves)
    # the Function, behind the reshape to the caller's batch dimensions
    assert "FlashAttention" in type(
        out.grad_fn.next_functions[0][0]).__name__
    out.backward(torch.from_numpy(g).to(dtype))
    return [t.grad.float().numpy() for t in leaves]


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_function_gradients_match_rpst_interpret_and_oracle(case):
    q, k, v, g = _inputs(3, *case)
    got = _torch_grads(q, k, v, g)
    ref = jax.grad(lambda a, b, c: (jax_flash(a, b, c, True)
                                    * jnp.asarray(g)).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    oracle = _oracle(q, k, v, g)[2]
    for name, a, r, o in zip(("dq", "dk", "dv"), got, ref, oracle):
        np.testing.assert_allclose(a, np.asarray(r), err_msg=name, **GRAD)
        np.testing.assert_allclose(a, o, err_msg=name, **GRAD)


def test_function_gradients_large_logits():
    """Inputs x 30: a near-one-hot softmax, whose dq and dk are ~0 where
    nothing is selected, so they compare absolutely (rpst's own bound,
    tests/test_flash_attention.py:93-102); dv keeps the gradient tolerance."""
    q, k, v, g = _inputs(3, *CASES[3])
    got = _torch_grads(q, k, v, g)
    ref = jax.grad(lambda a, b, c: (jax_flash(a, b, c, True)
                                    * jnp.asarray(g)).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    oracle = _oracle(q, k, v, g)[2]
    for name, a, r, o in zip(("dq", "dk", "dv"), got, ref, oracle):
        assert np.isfinite(a).all(), name
        tol = GRAD if name == "dv" else dict(rtol=0, atol=1e-3)
        np.testing.assert_allclose(a, np.asarray(r), err_msg=name, **tol)
        np.testing.assert_allclose(a, o, err_msg=name, **tol)


@pytest.mark.parametrize("shape", [(1, 20, 12, 8), (2, 5, 33, 16),
                                   (1, 1, 1, 4)], ids=str)
def test_ragged_shapes_match_oracle(shape):
    """Shapes rpst sends to its dense route (short, or no multiple of 8):
    the port has one route, held to the oracle only."""
    q, k, v, g = _inputs(4, *shape)
    ref_o, _, ref_grads = _oracle(q, k, v, g)
    np.testing.assert_allclose(fa.flash_attention(*_t(q, k, v)).numpy(),
                               ref_o, **FWD)
    for name, a, r in zip(("dq", "dk", "dv"), _torch_grads(q, k, v, g),
                          ref_grads):
        np.testing.assert_allclose(a, r, err_msg=name, **GRAD)


def test_function_gradients_bf16():
    q, k, v, g = _inputs(5, 2, 32, 48, 16)
    rounded = [torch.from_numpy(a).bfloat16().float().numpy()
               for a in (q, k, v, g)]
    got = _torch_grads(q, k, v, g, dtype=torch.bfloat16)
    # dS and P are rounded to bf16 before their second product: an error of
    # bf16 steps of the largest terms, so relative to the tensor's max
    for name, a, r in zip(("dq", "dk", "dv"), got, _oracle(*rounded)[2]):
        np.testing.assert_allclose(a, r, rtol=2e-2,
                                   atol=2e-2 * np.abs(r).max(), err_msg=name)


def test_backward_wrappers_match_the_dense_backward():
    """flash_bwd_dq / flash_bwd_dkv from (q, k, v, dO, LSE, Delta) as the
    Function calls them."""
    q, k, v, g = _inputs(6, 2, 24, 40, 16)
    tq, tk, tv, tg = _t(q, k, v, g)
    o, lse = fa.flash_fwd_lse(tq, tk, tv)
    delta = (tg * o).sum(-1)
    dq = fa.flash_bwd_dq(tq, tk, tv, tg, lse, delta)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tg, lse, delta)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv),
                          _oracle(q, k, v, g)[2]):
        np.testing.assert_allclose(a.numpy(), r, err_msg=name, **GRAD)


def test_gradcheck_float64():
    rng = np.random.default_rng(7)
    leaves = [torch.from_numpy(rng.normal(size=s)).requires_grad_(True)
              for s in ((2, 6, 4), (2, 5, 4), (2, 5, 4))]
    assert torch.autograd.gradcheck(fa.flash_attention, leaves)


def test_backward_skips_what_no_input_needs():
    """Only v needs a gradient: dq is not computed (None), dv is right."""
    q, k, v, g = _inputs(8, 1, 16, 16, 8)
    tq, tk, tv = _t(q, k, v)
    tv.requires_grad_(True)
    fa.flash_attention(tq, tk, tv).backward(torch.from_numpy(g))
    assert tq.grad is None and tk.grad is None
    np.testing.assert_allclose(tv.grad.numpy(), _oracle(q, k, v, g)[2][2],
                               **GRAD)


def test_no_grad_call_takes_the_forward_without_lse():
    q, k, v, _ = _inputs(9, 1, 16, 16, 8)
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    with torch.no_grad():
        out = fa.flash_attention(*leaves)
    assert out.grad_fn is None
    with torch.inference_mode():
        np.testing.assert_array_equal(
            fa.sanet_attention(*_t(q, k, v)).numpy(), out.numpy())


def test_leading_batch_dims_and_2d():
    q, k, v, _ = _inputs(10, 6, 16, 24, 8)
    flat = fa.flash_attention(*_t(q, k, v))
    nested = fa.flash_attention(*(t.reshape(2, 3, *t.shape[1:])
                                  for t in _t(q, k, v)))
    np.testing.assert_array_equal(nested.reshape(flat.shape).numpy(),
                                  flat.numpy())
    one = fa.flash_attention(*(t[0] for t in _t(q, k, v)))
    np.testing.assert_array_equal(one.numpy(), flat[0].numpy())


@pytest.mark.parametrize("bad", ["dtype", "shape", "kv"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    q, k, v, _ = _inputs(11, 1, 8, 8, 4)
    tq, tk, tv = _t(q, k, v)
    if bad == "dtype":
        with pytest.raises(TypeError):
            fa.flash_fwd(tq, tk.double(), tv)
    elif bad == "shape":
        with pytest.raises(ValueError):
            fa.flash_fwd(tq[..., :3], tk, tv)
    else:
        with pytest.raises(ValueError):
            fa.flash_attention(tq, tk, tv[:, :4])


def test_cpu_calls_count_no_launch():
    before = fa.launch_counts()
    assert sorted(before) == ["B6_dkv", "B6_dq", "B6_fwd"]
    q, k, v, g = _inputs(12, 1, 8, 8, 4)
    _torch_grads(q, k, v, g)
    assert fa.launch_counts() == before
