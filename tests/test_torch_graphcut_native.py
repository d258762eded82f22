"""The port's native chain-MRF solvers (``rpst_torch.ops.graphcut_native``,
built from ``src/rpst_torch/csrc/host/graphcut.cpp``) against rpst's
(``rpst.ops.graphcut_cpp``) on seeded problems: Viterbi and alpha-expansion
labels equal rpst's exactly (the same algorithm on the same float64 input),
energies to 1e-12, alpha-expansion at lambda 0 is the per-node argmin, the
port's DP (``ops.graphcut.chain_map_labeling``) reaches the native
Viterbi's energy (rpst's rtol 1e-5), and ``chain_labeling_native`` keeps
its input's device."""

import numpy as np
import pytest
import torch

from rpst.ops import graphcut_cpp as ref
from rpst_torch.ops import graphcut_native as port
from rpst_torch.ops.graphcut import chain_map_labeling

pytestmark = pytest.mark.skipif(not ref.available(),
                                reason="libgraphcut.so not buildable")

# (C, k, lambda): rpst's test sizes, a wide chain and a tie-heavy Potts
PROBLEMS = [(32, 4, 0.3), (16, 3, 0.3), (512, 3, 0.5), (64, 5, 2.0)]


def _problem(seed, c, k, lam):
    d = np.random.default_rng(seed).random((c, k))
    return d, lam * (np.ones((k, k)) - np.eye(k))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("c,k,lam", PROBLEMS)
def test_labels_and_energies_equal_rpsts(seed, c, k, lam):
    d, v = _problem(seed, c, k, lam)
    for ours, theirs in ((port.chain_viterbi_cpp(d, v),
                          ref.chain_viterbi_cpp(d, v)),
                         (port.aexpansion_chain_cpp(d, v),
                          ref.aexpansion_chain_cpp(d, v)),
                         (port.aexpansion_chain_cpp(d, v, max_cycles=1),
                          ref.aexpansion_chain_cpp(d, v, max_cycles=1))):
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_allclose(port.chain_energy_cpp(d, v, ours),
                                   ref.chain_energy_cpp(d, v, theirs),
                                   rtol=1e-12, atol=0)


def test_aexpansion_at_lambda_zero_is_the_argmin():
    d, v = _problem(3, 32, 4, 0.0)
    np.testing.assert_array_equal(port.aexpansion_chain_cpp(d, v),
                                  np.argmin(d, axis=1))


@pytest.mark.parametrize("c,k,lam", PROBLEMS)
def test_port_dp_reaches_native_viterbi_energy(c, k, lam):
    d, v = _problem(5, c, k, lam)
    dp = chain_map_labeling(torch.from_numpy(d).float(),
                            torch.from_numpy(v).float()).numpy()
    np.testing.assert_allclose(port.chain_energy_cpp(d, v, dp),
                               port.chain_energy_cpp(
                                   d, v, port.chain_viterbi_cpp(d, v)),
                               rtol=1e-5)


def test_chain_labeling_native_keeps_the_device():
    d, v = _problem(7, 24, 3, 0.3)
    dt, vt = torch.from_numpy(d), torch.from_numpy(v)
    got = port.chain_labeling_native(dt, vt)
    assert got.device == dt.device and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.chain_viterbi_cpp(d, v))
    assert port.available()
