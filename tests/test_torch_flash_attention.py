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


def _oracle(q, k, v, g=None, rows=None):
    """float64 numpy: (o, lse) and, with an upstream gradient g, (dq, dk,
    dv) of sum(o * g) by the dense softmax backward; with ``rows`` = (lse,
    delta) given, (dq, dk, dv) of the backward kernels' function of those
    rows instead: P = exp(S - lse), dS = P * (g v^T - delta)."""
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
    dp = np.einsum("nqc,nkc->nqk", g, v)
    if rows is None:
        ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    else:
        lse_in, delta_in = (np.asarray(r, np.float64)[..., None] for r in rows)
        p = np.exp(s - lse_in)
        ds = p * (dp - delta_in)
    dv = np.einsum("nqk,nqc->nkc", p, g)
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


def _tf32(x, nearest=True):
    """float32 to TF32 (10 mantissa bits) in numpy: ``cvt.rna.tf32.f32``
    (to nearest, ties away from zero), or truncated as ``mma`` reads an
    operand's register."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a, b, products, chunk, parts=1):
    """a @ b as the float32 kernels form it: exact products of TF32
    operands, a = a_hi + a_lo and b = b_hi + b_lo with hi rounded to nearest
    and lo = x - hi truncated (a_lo b_hi + a_hi b_lo + a_hi b_hi with three
    products, a_hi b_hi with one), summed over ``chunk`` of the inner
    dimension at a time, the chunk sums added in float32; with ``parts``, the
    inner dimension is cut into that many equal parts, each summed so, and
    the parts' sums added in order (the backward kernels' quarters of C)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi, False), _tf32(b - b_hi, False)
    terms = [(a_hi, b_hi)] if products == 1 else [(a_lo, b_hi), (a_hi, b_lo),
                                                  (a_hi, b_hi)]
    step = a.shape[1] // parts
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for p0 in range(0, a.shape[1], step):
        out = np.zeros_like(total)
        for c0 in range(p0, p0 + step, chunk):
            c1 = min(c0 + chunk, p0 + step)
            part = sum(x[:, c0:c1].astype(np.float64)
                       @ y[c0:c1].astype(np.float64) for x, y in terms)
            out = out + part.astype(np.float32)
        total = out if p0 == 0 else total + out
    return total


def _tf32_attention(q, k, v, products):
    """O of the float32 forward kernel's arithmetic: scores summed 16
    channels at a time, P V 32 keys (a tile) at a time."""
    s = _tf32_product(q, k.T, products, 16)
    p = np.exp(s - s.max(-1, keepdims=True))
    l = p.sum(-1, keepdims=True, dtype=np.float32)
    return _tf32_product(p, v, products, 32) / l


@pytest.mark.parametrize("scale", [1.0, 30.0])
@pytest.mark.parametrize("shape", [(2, 100, 70, 512), (1, 1024, 1024, 512),
                                   (1, 64, 64, 512)],
                         ids=["ragged", "relu5_1", "64x64"])
def test_three_tf32_products_are_float32_accurate(shape, scale):
    """The arithmetic of the float32 CUDA forward (three TF32 products per
    operand pair), emulated in numpy on whole draws made as chip_smoke.py's
    phase 23 makes them (its ``_attention_inputs``: all four tensors x scale
    / C^(1/4)): O is no further from a float64 oracle than
    ``f32_oracle_limit``, the limit phase 23 holds the kernel to at x 30;
    one TF32 product misses that limit by more than 50x (it moves O by
    ~5e-4 of its size at x 1). The two large draws hold rows whose two top
    logits nearly tie at x 30, which set the plain version's error; the
    64 x 64 one holds none, so there the limit is its float32 floor."""
    n, nq, nk, c = shape
    rng = np.random.default_rng(n + nq + nk)
    q, k, v = (rng.standard_normal((n, m, c)).astype(np.float32)
               * np.float32(scale / c ** 0.25) for m in (nq, nk, nk))
    ref = _oracle(q, k, v)[0]
    ref64 = fa.attention_f64(*_t(q, k, v))
    np.testing.assert_allclose(ref64.numpy(), ref, rtol=1e-9, atol=1e-9)
    limit = fa.f32_oracle_limit(fa.flash_fwd_plain(*_t(q, k, v)), ref64)
    for products, bound in ((3, lambda e: e <= limit),
                            (1, lambda e: e > 50 * limit)):
        err = max(np.abs(_tf32_attention(q[i], k[i], v[i], products)
                         - ref[i]).max() for i in range(n))
        assert bound(err), (products, err, limit)


def _tf32_grads(q, k, v, g, lse, delta, products):
    """(dq, dk, dv) of one image by the float32 backward kernels'
    arithmetic: S and dO V^T over each quarter of C, each 8 channels (one
    m16n8k8) a sum of its own, the quarters added in order; P = exp(S -
    lse), dS = P (dO V^T - delta) in float32; dS K, dS^T Q and P^T dO in
    tiles of 32 keys (or queries)."""
    s = _tf32_product(q, k.T, products, 8, parts=4)
    dp = _tf32_product(g, v.T, products, 8, parts=4)
    p = np.exp(s - lse[:, None])
    ds = p * (dp - delta[:, None])
    return (_tf32_product(ds, k, products, 32),
            _tf32_product(np.ascontiguousarray(ds.T), q, products, 32),
            _tf32_product(np.ascontiguousarray(p.T), g, products, 32))


@pytest.mark.parametrize("scale", [1.0, 30.0])
@pytest.mark.parametrize("shape", [(2, 100, 70, 512), (1, 1024, 1024, 512),
                                   (1, 64, 64, 512)],
                         ids=["ragged", "relu5_1", "64x64"])
def test_three_tf32_products_hold_the_backward_to_float32(shape, scale):
    """The arithmetic of the float32 CUDA backward (B6c, B6d: three TF32
    products per operand pair), emulated in numpy on draws made as
    chip_smoke.py's phase 23 makes them (all four tensors x scale /
    C^(1/4)), with LSE and Delta from the plain float32 forward as phase 23
    passes them. At x 1, dQ, dK and dV lie within ``F32_GRAD_REL`` (max) and
    ``F32_GRAD_MEAN_REL`` (mean) of the tensor's size from the exact float64
    gradients; one TF32 product misses both by more than 30x. At x 30 they
    lie within ``f32_oracle_limit`` of the float64 evaluation of the
    kernels' own function of those LSE and Delta rows (the limit phase 23
    holds the kernels to there), one product misses it by more than 50x."""
    n, nq, nk, c = shape
    rng = np.random.default_rng(n + nq + nk)
    q, k, v, g = (rng.standard_normal((n, m, c)).astype(np.float32)
                  * np.float32(scale / c ** 0.25) for m in (nq, nk, nk, nq))
    tq, tk, tv, tg = _t(q, k, v, g)
    o, lse = fa.flash_fwd_lse_plain(tq, tk, tv)
    delta = (tg * o).sum(-1)
    plain = (fa.flash_bwd_dq_plain(tq, tk, tv, tg, lse, delta),
             *fa.flash_bwd_dkv_plain(tq, tk, tv, tg, lse, delta))
    rows = (lse.numpy(), delta.numpy())
    ref = _oracle(q, k, v, g, rows=None if scale == 1.0 else rows)[2]
    for products in (3, 1):
        got = [_tf32_grads(q[i], k[i], v[i], g[i], lse[i].numpy(),
                           delta[i].numpy(), products) for i in range(n)]
        for j, name in enumerate(("dq", "dk", "dv")):
            err = np.abs(np.stack([x[j] for x in got]) - ref[j])
            size = np.abs(ref[j]).max()
            if scale == 1.0:
                rel = (err.max() / size / fa.F32_GRAD_REL,
                       err.mean() / size / fa.F32_GRAD_MEAN_REL)
                ok = max(rel) <= 1 if products == 3 else min(rel) > 30
            else:
                rel = err.max() / fa.f32_oracle_limit(
                    plain[j], torch.from_numpy(ref[j]))
                ok = rel <= 1 if products == 3 else rel > 50
            assert ok, (products, name, rel)


@pytest.mark.parametrize("with_rows", [False, True], ids=["softmax", "rows"])
def test_attention_grads_f64_matches_oracle(with_rows):
    """The float64 gradient oracle the card holds B6c / B6d to, against the
    numpy oracle: the softmax gradients, and the kernels' function of given
    LSE and Delta rows (here rows a little off the exact ones, so that the
    two forms differ)."""
    q, k, v, g = _inputs(13, 2, 24, 40, 16)
    o, lse = _oracle(q, k, v)
    delta = (g.astype(np.float64) * o).sum(-1)
    rows = (lse + 1e-3, delta - 1e-2) if with_rows else None
    got = fa.attention_grads_f64(*_t(q, k, v, g, dtype=torch.float64),
                                 *(() if rows is None else
                                   (torch.from_numpy(r) for r in rows)))
    for name, a, r in zip(("dq", "dk", "dv"), got,
                          _oracle(q, k, v, g, rows=rows)[2]):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-10, atol=1e-12,
                                   err_msg=name)
    if with_rows:
        exact = _oracle(q, k, v, g)[2]
        assert not np.allclose(got[2].numpy(), exact[2], rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fault", [None, "key tile", "query tile", "x 0.9"])
def test_check_backward_refuses_a_faulty_backward(dtype, tol, fault):
    """The card's backward check (``fa.check_backward``) on the CPU, where
    the wrappers take the plain versions: those pass, and gradients with
    one swept tile of 32 dropped (keys 32-63 from dQ, queries 32-63 from dK
    and dV) or 10% off fail it. The upstream gradient is small, as at the
    path's shapes, so that in bfloat16 rtol = atol = 2e-2 alone passes the
    10% error and only the own-size limits refuse it."""
    n, nq, nk, c = 1, 64, 96, 128
    q, k, v, g = (a / c ** 0.25 for a in _inputs(17, n, nq, nk, c))
    q, k, v, d_o = _t(q, k, v, g * 0.1, dtype=dtype)
    o, lse = fa.flash_fwd_lse_plain(q, k, v)
    delta = (d_o.float() * o.float()).sum(-1)
    readings = fa.check_backward(q, k, v, d_o, lse, delta, tol)
    assert all(r["ok"] and "own" in r for r in readings.values())
    if fault is None:
        return
    dq = fa.flash_bwd_dq_plain(q, k, v, d_o, lse, delta)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, d_o, lse, delta)
    keep = torch.cat([torch.arange(32), torch.arange(64, 96)])
    if fault == "key tile":
        bad = {"dq": fa.flash_bwd_dq_plain(q, k[:, keep], v[:, keep], d_o,
                                           lse, delta)}
    elif fault == "query tile":
        bad = dict(zip(("dk", "dv"), fa.flash_bwd_dkv_plain(
            q[:, :32], k, v, d_o[:, :32], lse[:, :32], delta[:, :32])))
    else:
        bad = {name: t * 0.9 for name, t in
               (("dq", dq), ("dk", dk), ("dv", dv))}
    grads = {"dq": dq, "dk": dk, "dv": dv, **bad}
    got = fa.backward_readings(q, k, v, d_o, lse, delta,
                               tuple(grads.values()), tol)
    assert {name for name, r in got.items() if not r["ok"]} == set(bad)
    if dtype == torch.bfloat16 and fault == "x 0.9":
        assert all(torch.allclose(grads[name].float(), t.float(), rtol=tol,
                                  atol=tol) for name, t in
                   (("dq", dq), ("dk", dk), ("dv", dv)))
