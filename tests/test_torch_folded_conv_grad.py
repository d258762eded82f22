"""B2 and B3 (rpst_torch.ops.folded_conv) and B1's autograd Function.

The plain versions of B2/B3 are held against three references that share
no code with them: rpst's Pallas kernels in interpret mode, autograd of B1's
plain version (and ``jax.grad`` of rpst's XLA ring path for the 12-wide
image sides), and a numpy brute-force transpose of ``np.pad(reflect)``. The
kernels themselves run only on the card: tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpst_torch.ops.folded_conv as fc
from rpst.ops.folded import fold_bias as j_fold_bias
from rpst.ops.folded import fold_conv_kernel as j_fold_conv_kernel
from rpst.ops.folded import folded_conv as j_folded_conv
from rpst.ops.pallas.folded_conv import \
    fused_folded_conv_grad_input as j_grad_input
from rpst.ops.pallas.folded_conv import \
    fused_folded_conv_grad_weight as j_grad_weight
from rpst_torch.ops.folded import fold_bias, fold_conv_kernel
from rpst_torch.ops.folded_conv import (FoldedConvAct,
                                        fused_folded_conv_grad_input,
                                        fused_folded_conv_grad_input_plain,
                                        fused_folded_conv_grad_weight,
                                        fused_folded_conv_grad_weight_plain,
                                        fused_folded_conv_plain)
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_folded.py:406-411: dx 1e-4; dk/db rtol 1e-4, atol 2e-3 (sums
# of 512 products of N(0,1) values at 16x16, batch 2)
DX_TOL = dict(rtol=1e-4, atol=1e-4)
DK_TOL = dict(rtol=1e-4, atol=2e-3)


def _khat(kf):
    return kf.flip(0, 1).transpose(2, 3).contiguous()


def _case(rng, n, h, w, c, co, scale=0.1):
    """x (n,h,w,4c), folded kernel/bias of a c -> co conv, and gz, as
    float32 numpy arrays."""
    x = rng.standard_normal((n, h, w, 4 * c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * scale).astype(np.float32)
    b = (rng.standard_normal(co) * scale).astype(np.float32)
    kf = np.array(j_fold_conv_kernel(jnp.asarray(k)))
    bf = np.array(j_fold_bias(jnp.asarray(b)))
    gz = rng.standard_normal((n, h, w, 4 * co)).astype(np.float32)
    return x, kf, bf, gz


@pytest.mark.parametrize("n,h,w,c,co", [(2, 16, 16, 32, 32),
                                        (1, 16, 16, 32, 64)])
def test_plain_matches_pallas_interpret(rng, n, h, w, c, co):
    """C4 = 128 and the rectangular 128 -> 256, the shapes of
    tests/test_folded.py:388 and :422."""
    x, kf, _, gz = _case(rng, n, h, w, c, co)
    khat = np.ascontiguousarray(np.transpose(kf[::-1, ::-1], (0, 1, 3, 2)))
    rdx = j_grad_input(jnp.asarray(gz), jnp.asarray(khat), interpret=True)
    rdk, rdb = j_grad_weight(jnp.asarray(x), jnp.asarray(gz),
                             interpret=True)
    dx = fused_folded_conv_grad_input(torch.from_numpy(gz),
                                      torch.from_numpy(khat))
    dk, db = fused_folded_conv_grad_weight(torch.from_numpy(x),
                                           torch.from_numpy(gz))
    assert dk.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), **DX_TOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(rdk), **DK_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(rdb), **DK_TOL)


@pytest.mark.parametrize("alpha", [0.2, 0.0])
@pytest.mark.parametrize("n,h,w,c,co", [(2, 6, 8, 32, 16), (1, 5, 3, 3, 32),
                                        (1, 4, 6, 32, 3), (2, 2, 2, 8, 8)])
def test_function_matches_autograd_of_b1_plain(rng, n, h, w, c, co, alpha):
    """FoldedConvAct's backward (B2 + B3 plain on the CPU) against
    torch.autograd.grad of B1's plain version, ragged and 2x2 cases
    included (there the row and column ring scatters overlap)."""
    x, kf, bf, g = (torch.from_numpy(a) for a in _case(rng, n, h, w, c, co))
    leaves = [t.clone().requires_grad_() for t in (x, kf, bf)]
    ref = torch.autograd.grad(
        (fused_folded_conv_plain(*leaves, alpha) * g).sum(), leaves)
    got = torch.autograd.grad(
        (FoldedConvAct.apply(*leaves, alpha) * g).sum(), leaves)
    for name, a, b in zip(("dx", "dk", "db"), got, ref):
        tol = DX_TOL if name == "dx" else DK_TOL
        torch.testing.assert_close(a, b, **tol, msg=name)


@pytest.mark.parametrize("alpha", [0.2, 0.0])
@pytest.mark.parametrize("c,co", [(3, 32), (32, 3)])
def test_twelve_wide_sides_match_jax_grad(rng, c, co, alpha):
    """The 3-channel image layers (4C or 4Co = 12), which rpst runs on its
    XLA ring path: jax.grad of folded_conv + act."""
    x, kf, bf, g = _case(rng, 2, 6, 4, c, co)

    def f(x, kf, bf):
        y = j_folded_conv(x, kf, bf)
        return jnp.sum(jnp.where(y >= 0, y, alpha * y) * g)

    rdx, rdk, rdb = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(kf), jnp.asarray(bf))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, kf, bf)]
    got = torch.autograd.grad(
        (FoldedConvAct.apply(*leaves, alpha) * torch.from_numpy(g)).sum(),
        leaves)
    for name, a, b in zip(("dx", "dk", "db"), got, (rdx, rdk, rdb)):
        tol = DX_TOL if name == "dx" else DK_TOL
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol,
                                   err_msg=name)


# ------------------------------------------------------- numpy oracle

def _np_fold(x):
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def _np_unfold(x_f):
    n, h, w, c4 = x_f.shape
    return x_f.reshape(n, h, w, 2, 2, c4 // 4).transpose(
        0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, c4 // 4)


def _np_forward(x_f, kf):
    """The folded conv without bias, from the definition: reflect-pad the
    IMAGE by 2 pixels (one folded pixel) with np.pad, fold, VALID 3x3."""
    h, w = x_f.shape[1], x_f.shape[2]
    xp = _np_fold(np.pad(_np_unfold(x_f), ((0, 0), (2, 2), (2, 2), (0, 0)),
                         mode="reflect"))
    return sum(np.einsum("nhwi,io->nhwo", xp[:, dr:dr + h, dc:dc + w],
                         kf[dr, dc]) for dr in range(3) for dc in range(3))


@pytest.mark.parametrize("h,w", [(4, 4), (2, 3)])
def test_ring_adjoint_matches_numpy_brute_force(rng, h, w):
    """dx and dk of the linear map x_f -> conv(reflect_pad(x_f), kf) by
    brute force (the map applied to every basis vector, then <., gz>),
    against B2/B3's plain versions. No port or rpst code in the oracle."""
    c, co = 1, 2
    x = rng.standard_normal((1, h, w, 4 * c))
    kf = rng.standard_normal((3, 3, 4 * c, 4 * co))
    gz = rng.standard_normal((1, h, w, 4 * co))
    dx_ref = np.zeros_like(x)
    for j in range(x.size):
        e = np.zeros(x.size)
        e[j] = 1.0
        dx_ref.flat[j] = np.sum(_np_forward(e.reshape(x.shape), kf) * gz)
    dk_ref = np.zeros_like(kf)
    for j in range(kf.size):
        e = np.zeros(kf.size)
        e[j] = 1.0
        dk_ref.flat[j] = np.sum(_np_forward(x, e.reshape(kf.shape)) * gz)
    t = torch.from_numpy
    dx = fused_folded_conv_grad_input_plain(t(gz), _khat(t(kf)))
    dk, db = fused_folded_conv_grad_weight_plain(t(x), t(gz))
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(dk.numpy(), dk_ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(db.numpy(), gz.sum(axis=(0, 1, 2)),
                               rtol=1e-12)


@pytest.mark.parametrize("alpha", [0.2, 0.0])
def test_folded_conv_act_gradcheck(alpha):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 3, 4, 4, dtype=torch.float64, generator=g)
    kf = fold_conv_kernel(torch.randn(3, 3, 1, 2, dtype=torch.float64,
                                      generator=g))
    bf = fold_bias(torch.randn(2, dtype=torch.float64, generator=g))
    inputs = tuple(t.requires_grad_() for t in (x, kf, bf))
    assert torch.autograd.gradcheck(
        lambda *a: FoldedConvAct.apply(*a, alpha), inputs)


def test_backward_skips_what_needs_no_gradient(rng, monkeypatch):
    """B2 runs only when x needs a gradient, B3 only when the kernel or
    bias does (the frozen VGG layers never run it)."""
    calls = []
    for name in ("fused_folded_conv_grad_input",
                 "fused_folded_conv_grad_weight"):
        real = getattr(fc, name)
        monkeypatch.setattr(fc, name, lambda *a, _r=real, _n=name:
                            (calls.append(_n), _r(*a))[1])
    x, kf, bf, _ = (torch.from_numpy(a) for a in _case(rng, 1, 4, 4, 2, 2))
    FoldedConvAct.apply(x.requires_grad_(), kf, bf, 0.0).sum().backward()
    assert calls == ["fused_folded_conv_grad_input"]
    calls.clear()
    x = x.detach()
    FoldedConvAct.apply(x, kf.requires_grad_(), bf, 0.2).sum().backward()
    assert calls == ["fused_folded_conv_grad_weight"]


def test_cpu_wrappers_take_plain_and_count_no_launch(rng):
    x, kf, _, gz = (torch.from_numpy(a) for a in _case(rng, 1, 4, 4, 2, 2))
    before = (fused_folded_conv_grad_input.launches,
              fused_folded_conv_grad_weight.launches)
    dx = fused_folded_conv_grad_input(gz, _khat(kf))
    dk, db = fused_folded_conv_grad_weight(x, gz)
    assert (fused_folded_conv_grad_input.launches,
            fused_folded_conv_grad_weight.launches) == before
    torch.testing.assert_close(
        dx, fused_folded_conv_grad_input_plain(gz, _khat(kf)), rtol=0, atol=0)
    torch.testing.assert_close(
        dk, fused_folded_conv_grad_weight_plain(x, gz)[0], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["dtype", "mixed dtype", "khat shape",
                                  "gz shape", "non-contiguous", "too small",
                                  "device"])
def test_grad_wrappers_reject_what_the_kernels_do_not_take(kind):
    x, gz = torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 12)
    khat = torch.zeros(3, 3, 12, 8)
    if kind == "dtype":
        x, gz, khat = x.half(), gz.half(), khat.half()
    elif kind == "mixed dtype":
        khat = khat.to(torch.bfloat16)
        x = x.to(torch.bfloat16)
    elif kind == "khat shape":
        khat = torch.zeros(3, 3, 8, 8)
    elif kind == "gz shape":
        gz = torch.zeros(1, 4, 5, 12)
    elif kind == "non-contiguous":
        gz = torch.zeros(1, 4, 12, 4).transpose(2, 3)
        x = torch.zeros(1, 4, 8, 4).transpose(2, 3)
    elif kind == "too small":
        x, gz = torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 12)
    elif kind == "device":
        x, gz = x.to("meta"), gz.to("meta")
        khat = khat.to("meta")
    if kind != "gz shape":  # B2 reads no x
        with pytest.raises((TypeError, ValueError)):
            fused_folded_conv_grad_input(gz, khat)
    if kind != "khat shape":  # B3 reads no khat
        with pytest.raises((TypeError, ValueError)):
            fused_folded_conv_grad_weight(x, gz)
