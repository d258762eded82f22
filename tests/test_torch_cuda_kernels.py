"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports no JAX, so it also runs on a machine without it, where
tests/conftest.py (which imports JAX) cannot load:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py -q -m cuda
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from rpst_torch.ops.folded import fold_bias, fold_conv_kernel  # noqa: E402
from rpst_torch.ops.folded_conv import (fused_folded_conv,  # noqa: E402
                                        fused_folded_conv_plain)

F32_TOL = 1e-4   # K = 9 * 4C products summed in another order
BF16_TOL = 2e-2  # about two bf16 ulps at O(1) values


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the B1 CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _layer(seed, n, h, w, c, co, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, 4 * c),
                                             dtype=np.float32))
    k = fold_conv_kernel(torch.from_numpy(
        rng.standard_normal((3, 3, c, co), dtype=np.float32) * 0.2))
    b = fold_bias(torch.from_numpy(rng.standard_normal(co, dtype=np.float32)))
    return x.to(device), k.contiguous().to(device), b.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("shape,alpha", [((2, 38, 22, 3, 32), 0.2),
                                         ((1, 64, 48, 32, 32), 0.2),
                                         ((1, 64, 48, 32, 32), 0.0),
                                         ((2, 17, 9, 32, 3), 0.2)])
@pytest.mark.parametrize("with_rings", [False, True])
def test_b1_matches_plain_on_card(cuda_device, dtype, tol, shape, alpha,
                                  with_rings):
    x, k, b = _layer(0, *shape, cuda_device)
    rings = None
    if with_rings:
        rings = torch.rand(x.shape[0], 2, x.shape[2], x.shape[3],
                           device=cuda_device)
    x, k, b = x.to(dtype), k.to(dtype), b.to(dtype)
    rings = None if rings is None else rings.to(dtype)
    before = fused_folded_conv.launches
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):  # the plain conv in full f32
        y = fused_folded_conv(x, k, b, alpha, rings)
        torch.cuda.synchronize()
        ref = fused_folded_conv_plain(
            x.float(), k.float(), b.float(), alpha,
            None if rings is None else rings.float()).to(dtype)
    assert fused_folded_conv.launches == before + 1
    assert y.dtype == dtype and y.is_cuda
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_b1_refuses_mixed_devices(cuda_device):
    x, k, b = _layer(1, 1, 4, 4, 2, 2, cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        fused_folded_conv(x, k.cpu(), b)
