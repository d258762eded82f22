"""rpst_torch.ops.folded against rpst.ops.folded (f32, CPU), with the reflect
rings also held against an np.pad oracle that shares no code with either."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.ops import folded as jf
from rpst_torch.ops import folded as tf

TOL = 1e-5


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape", [(2, 16, 12, 5), (1, 4, 8, 32)])
def test_fold_unfold_match_rpst(rng, shape):
    xj, xt = _pair(rng, shape)
    np.testing.assert_array_equal(tf.fold(xt).numpy(), np.asarray(jf.fold(xj)))
    np.testing.assert_array_equal(tf.unfold(tf.fold(xt)).numpy(),
                                  xt.numpy())
    fj, ft = _pair(rng, (shape[0], shape[1] // 2, shape[2] // 2,
                         4 * shape[3]))
    np.testing.assert_array_equal(tf.unfold(ft).numpy(),
                                  np.asarray(jf.unfold(fj)))


def test_fold_rejects_odd_sizes():
    with pytest.raises(ValueError):
        tf.fold(torch.zeros(1, 5, 4, 3))


@pytest.mark.parametrize("cin,cout", [(3, 32), (8, 8), (32, 3)])
def test_fold_conv_kernel_and_bias_match_rpst(rng, cin, cout):
    kj, kt = _pair(rng, (3, 3, cin, cout))
    bj, bt = _pair(rng, (cout,))
    np.testing.assert_array_equal(tf.fold_conv_kernel(kt).numpy(),
                                  np.asarray(jf.fold_conv_kernel(kj)))
    np.testing.assert_array_equal(tf.fold_bias(bt).numpy(),
                                  np.asarray(jf.fold_bias(bj)))


@pytest.mark.parametrize("shape", [(1, 8, 8, 4), (2, 12, 6, 3)])
def test_folded_reflect_pad_matches_np_pad_oracle(rng, shape):
    """The folded ring carries exactly the reflect-padded original pixels:
    unfold(pad(fold(x))) == np.pad(x, 2, 'reflect'), and equals rpst."""
    x = rng.random(shape).astype(np.float32)
    oracle = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="reflect")
    got = tf.unfold(tf.folded_reflect_pad(tf.fold(torch.from_numpy(x))))
    np.testing.assert_array_equal(got.numpy(), oracle)
    ref = jf.folded_reflect_pad(jf.fold(jnp.asarray(x)))
    np.testing.assert_array_equal(tf.folded_reflect_pad(
        tf.fold(torch.from_numpy(x))).numpy(), np.asarray(ref))


@pytest.mark.parametrize("top", [True, False])
def test_rings_match_rpst_and_oracle(rng, top):
    """Row and column rings one by one, against rpst and against the
    matching row/column band of the np.pad oracle."""
    x = rng.random((2, 8, 10, 4)).astype(np.float32)
    xf_t, xf_j = tf.fold(torch.from_numpy(x)), jf.fold(jnp.asarray(x))
    oracle = tf.fold(torch.from_numpy(np.pad(
        x, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="reflect")))
    row = tf._row_ring(xf_t, top)
    np.testing.assert_array_equal(row.numpy(),
                                  np.asarray(jf._row_ring(xf_j, top)))
    r = 0 if top else -1
    np.testing.assert_array_equal(row.numpy(), oracle[:, r:r + 1 or None,
                                                      1:-1].numpy())
    col = tf._col_ring(xf_t, top)  # top=True -> left column
    np.testing.assert_array_equal(col.numpy(),
                                  np.asarray(jf._col_ring(xf_j, top)))
    np.testing.assert_array_equal(col.numpy(), oracle[:, 1:-1,
                                                      r:r + 1 or None].numpy())


def test_folded_reflect_pad_rings_override(rng):
    """Explicit ring rows replace the reflect rows; ring columns are still
    built on the row-padded tensor (corners from the given rows)."""
    x = torch.from_numpy(rng.random((1, 4, 6, 8)).astype(np.float32))
    rings = torch.from_numpy(rng.random((1, 2, 6, 8)).astype(np.float32))
    got = tf.folded_reflect_pad(x, rings)
    rows = torch.cat([rings[:, :1], x, rings[:, 1:]], dim=1)
    np.testing.assert_array_equal(got[:, :, 1:-1].numpy(), rows.numpy())
    np.testing.assert_array_equal(got[:, :, :1].numpy(),
                                  tf._col_ring(rows, True).numpy())


@pytest.mark.parametrize("h,w,cin,cout", [(16, 16, 8, 6), (8, 12, 3, 32),
                                          (12, 8, 32, 3)])
def test_folded_conv_matches_rpst_and_image_conv(rng, h, w, cin, cout):
    xj, xt = _pair(rng, (2, h, w, cin))
    kj, kt = _pair(rng, (3, 3, cin, cout), 0.3)
    bj, bt = _pair(rng, (cout,))
    got = tf.folded_conv(tf.fold(xt), tf.fold_conv_kernel(kt),
                         tf.fold_bias(bt))
    ref = jf.folded_conv(jf.fold(xj), jf.fold_conv_kernel(kj),
                         jf.fold_bias(bj))
    _close(got, ref)
    # the unfolded equivalent: reflect pad + VALID conv on the image
    xp = np.pad(xt.numpy(), ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    img = tf.conv_nhwc(torch.from_numpy(xp), kt) + bt
    _close(tf.unfold(got), img.numpy())


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (1, 4, 6, 12)])
def test_folded_stats_and_adain_match_rpst(rng, shape):
    cj, ct = _pair(rng, shape, 3.0)
    sj, st = _pair(rng, shape)
    for got, ref in zip(tf.folded_calc_mean_std(ct),
                        jf.folded_calc_mean_std(cj)):
        _close(got, ref)
    _close(tf.folded_adain(ct, st), jf.folded_adain(cj, sj))
