"""rpst_torch.ops.stats against rpst.ops.stats (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.ops import stats as js
from rpst_torch.ops import stats as ts


def _pair(rng, shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 5, 7, 32), (3, 1, 2, 3)])
def test_calc_mean_std_matches_rpst(rng, shape):
    xj, xt = _pair(rng, shape, 2.0, 1.0)
    for got, ref in zip(ts.calc_mean_std(xt), js.calc_mean_std(xj)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_calc_mean_std_reduces_bf16_in_f32(rng):
    """bf16 features: stats reduced in f32, returned in bf16, equal to rpst's."""
    a = rng.standard_normal((2, 16, 16, 8)).astype(np.float32) * 3
    xj = jnp.asarray(a).astype(jnp.bfloat16)
    xt = torch.from_numpy(a).to(torch.bfloat16)
    for got, ref in zip(ts.calc_mean_std(xt), js.calc_mean_std(xj)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


def test_adain_and_mean_variance_norm_match_rpst(rng):
    cj, ct = _pair(rng, (2, 8, 8, 16), 3.0)
    sj, st = _pair(rng, (2, 6, 10, 16), 0.5, 2.0)
    np.testing.assert_allclose(
        ts.adaptive_instance_normalization(ct, st).numpy(),
        np.asarray(js.adaptive_instance_normalization(cj, sj)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.mean_variance_norm(ct).numpy(),
                               np.asarray(js.mean_variance_norm(cj)),
                               rtol=1e-5, atol=1e-5)


def test_stats_reject_bad_shapes():
    with pytest.raises(ValueError):
        ts.calc_mean_std(torch.zeros(4, 4, 3))
    with pytest.raises(ValueError):
        ts.adaptive_instance_normalization(torch.zeros(1, 4, 4, 3),
                                           torch.zeros(1, 4, 4, 5))
