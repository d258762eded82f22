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


# ---------------------------------------------------------------- B2 / B3

from rpst_torch.ops.folded_conv import (  # noqa: E402
    FoldedConvAct, fused_folded_conv_grad_input,
    fused_folded_conv_grad_input_plain, fused_folded_conv_grad_weight,
    fused_folded_conv_grad_weight_plain)


def _grad_case(seed, n, h, w, c4, c4o, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c4, generator=g)
    gz = torch.randn(n, h, w, c4o, generator=g)
    kf = torch.randn(3, 3, c4, c4o, generator=g) * 0.1
    return (x.to(device), gz.to(device),
            kf.flip(0, 1).transpose(2, 3).contiguous().to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32, 48, 12, 128), (1, 32, 48, 128, 12),
                                   (2, 38, 22, 128, 128), (1, 16, 16, 256, 512),
                                   (2, 2, 2, 12, 12), (1, 3, 5, 128, 12)])
def test_b2_b3_match_plain_on_card(cuda_device, dtype, shape):
    """dx to B1's tolerances; dk/db (float32 sums of bf16 or f32 products)
    rtol 1e-4, atol 2e-3 * sqrt(N*H*W / 512), scaled from
    tests/test_folded.py's 2e-3 at 512 summed positions."""
    n, h, w, _, _ = shape
    x, gz, khat = _grad_case(0, *shape, cuda_device)
    x, gz, khat = x.to(dtype), gz.to(dtype), khat.to(dtype)
    before = (fused_folded_conv_grad_input.launches,
              fused_folded_conv_grad_weight.launches)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        dx = fused_folded_conv_grad_input(gz, khat)
        dk, db = fused_folded_conv_grad_weight(x, gz)
        torch.cuda.synchronize()
        rdx = fused_folded_conv_grad_input_plain(gz, khat)
        rdk, rdb = fused_folded_conv_grad_weight_plain(x, gz)
    assert (fused_folded_conv_grad_input.launches,
            fused_folded_conv_grad_weight.launches) == (before[0] + 1,
                                                        before[1] + 1)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert dx.dtype == dtype and dk.dtype == db.dtype == torch.float32
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol, atol=tol)
    atol = 2e-3 * (n * h * w / 512) ** 0.5
    torch.testing.assert_close(dk, rdk, rtol=1e-4, atol=atol)
    torch.testing.assert_close(db, rdb, rtol=1e-4, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.2, 0.0])
def test_function_on_card_matches_plain_autograd(cuda_device, alpha):
    x, k, b = _layer(2, 2, 16, 12, 32, 16, cuda_device)
    g = torch.randn(2, 16, 12, 64, device=cuda_device)
    leaves = [t.clone().requires_grad_() for t in (x, k, b)]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = torch.autograd.grad(
            (fused_folded_conv_plain(*leaves, alpha) * g).sum(), leaves)
        got = torch.autograd.grad(
            (FoldedConvAct.apply(*leaves, alpha) * g).sum(), leaves)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=2e-3)


@pytest.mark.cuda
def test_b2_refuses_float64_on_card(cuda_device):
    x, gz, khat = _grad_case(1, 1, 4, 4, 8, 8, cuda_device)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        fused_folded_conv_grad_input(gz.double(), khat.double())
