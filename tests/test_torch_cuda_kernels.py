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
# the bfloat16 attention forward's O averages over Nk keys and is far below
# O(1), so it is also held to its own size: max abs err <= 2e-2 x max |ref|
# and mean abs err <= 2e-3 x max |ref| (half of O, a dropped V tile or
# permuted channels fail both)
BF16_O_REL, BF16_O_MEAN_REL = 2e-2, 2e-3


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
    tests/test_folded.py's 2e-3 at 512 summed positions; B3 in its dense
    and its listed mode (the 36 blocks of a fold, zeros elsewhere), each
    bit-equal across two runs."""
    n, h, w, _, _ = shape
    x, gz, khat = _grad_case(0, *shape, cuda_device)
    x, gz, khat = x.to(dtype), gz.to(dtype), khat.to(dtype)
    before = (fused_folded_conv_grad_input.launches,
              fused_folded_conv_grad_weight.launches)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        dx = fused_folded_conv_grad_input(gz, khat)
        got = {listed: [fused_folded_conv_grad_weight(x, gz, listed)
                        for _ in range(2)] for listed in (False, True)}
        torch.cuda.synchronize()
        rdx = fused_folded_conv_grad_input_plain(gz, khat)
    assert (fused_folded_conv_grad_input.launches,
            fused_folded_conv_grad_weight.launches) == (before[0] + 1,
                                                        before[1] + 4)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert dx.dtype == dtype
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol, atol=tol)
    atol = 2e-3 * (n * h * w / 512) ** 0.5
    for listed, ((dk, db), (dk2, db2)) in got.items():
        assert dk.dtype == db.dtype == torch.float32
        assert torch.equal(dk, dk2) and torch.equal(db, db2)
        rdk, rdb = fused_folded_conv_grad_weight_plain(x, gz, listed)
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


def _offset_copy(t, elems):
    """``t`` in a buffer ``elems`` elements in: contiguous, its data pointer
    off 16-byte alignment (cp.async's) for elems * size % 16 != 0."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape", [(1, 9, 17, 32, 32), (2, 9, 17, 32, 3),
                                   (2, 17, 33, 3, 32), (1, 3, 5, 4, 5),
                                   (1, 10, 18, 16, 8), (1, 2, 3, 2, 64),
                                   (2, 2, 2, 3, 3)])
def test_b1_b2_tile_edges_on_card(cuda_device, dtype, tol, dense, shape):
    """B1 and B2 (folded_mma.cuh) at the edges of their 8 x 16 tiles and
    tilings, with a folded kernel (36 blocks listed) and a dense one (144):
    rows / columns H-2, H-1 in two tiles, the 12-wide sides, Co = 5 and 8,
    two channel tiles, the smallest image; B1 also with a rings override
    and with x off 16-byte alignment. (N, H, W, C, Co) of a 4C -> 4Co
    layer."""
    n, h, w, c, co = shape
    g = torch.Generator().manual_seed(3)
    x = torch.randn(n, h, w, 4 * c, generator=g)
    gz = torch.randn(n, h, w, 4 * co, generator=g)
    k = fold_conv_kernel(torch.randn(3, 3, c, co, generator=g) * 0.2)
    if dense:
        k = torch.randn(3, 3, 4 * c, 4 * co, generator=g) * 0.1
    b = fold_bias(torch.randn(co, generator=g))
    rings = torch.rand(n, 2, w, 4 * c, generator=g)
    x, gz, k, b, rings = (t.to(cuda_device, dtype).contiguous()
                          for t in (x, gz, k, b, rings))
    khat = k.flip(0, 1).transpose(2, 3).contiguous()
    before = (fused_folded_conv.launches,
              fused_folded_conv_grad_input.launches)
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        got = [fused_folded_conv(x, k, b, 0.2),
               fused_folded_conv(x, k, b, 0.0, rings),
               fused_folded_conv(_offset_copy(x, 2), k, b, 0.2),
               fused_folded_conv_grad_input(gz, khat)]
        torch.cuda.synchronize()
        f = [t.float() for t in (x, k, b, rings, gz, khat)]
        ref = [fused_folded_conv_plain(f[0], f[1], f[2], 0.2),
               fused_folded_conv_plain(f[0], f[1], f[2], 0.0, f[3]),
               fused_folded_conv_plain(f[0], f[1], f[2], 0.2),
               fused_folded_conv_grad_input_plain(f[4], f[5])]
    assert (fused_folded_conv.launches,
            fused_folded_conv_grad_input.launches) == (before[0] + 3,
                                                       before[1] + 1)
    for a, r in zip(got, ref):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), r.to(dtype).float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_b2_refuses_float64_on_card(cuda_device):
    x, gz, khat = _grad_case(1, 1, 4, 4, 8, 8, cuda_device)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        fused_folded_conv_grad_input(gz.double(), khat.double())


# ---------------------------------------------------------------- B4 / B7

from rpst_torch.ops.folded_conv2_q8 import fused_folded_conv2_q8  # noqa: E402
from rpst_torch.ops.folded_conv_q8 import (  # noqa: E402
    fused_folded_conv_q8, fused_folded_conv_q8_plain)


def _q8_layer(seed, n, h, w, c4, c4o, device, out_scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, w, c4), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c4, c4o), dtype=np.int8)
    sc = np.stack([rng.uniform(2e-6, 6e-6, c4o),
                   rng.normal(0, 0.2, c4o),
                   np.full(c4o, 1.0 / out_scale)]).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(k).to(device),
            torch.from_numpy(sc).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("out_int8", [True, False])
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("shape", [(1, 32, 48, 128, 128), (2, 19, 21, 128, 128),
                                   (1, 2, 2, 16, 4), (2, 9, 17, 32, 260)])
def test_b4_matches_plain_on_card(cuda_device, out_int8, with_stats, shape):
    """int8 and bf16 outputs bit-equal to the plain version (exact int32
    sums, the same float32 epilogue); s1/s2 at rpst's gate rtol 1e-4,
    atol 1e-3 (float32 sums in another order)."""
    x, k, sc = _q8_layer(0, *shape, cuda_device)
    before = fused_folded_conv_q8.launches
    got = fused_folded_conv_q8(x, k, sc, out_int8, with_stats)
    torch.cuda.synchronize()
    assert fused_folded_conv_q8.launches == before + 1
    ref = fused_folded_conv_q8_plain(x, k, sc, out_int8, with_stats)
    if not with_stats:
        got, ref = (got,), (ref,)
    assert got[0].dtype == ref[0].dtype and got[0].is_cuda
    assert torch.equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("out_int8", [True, False])
@pytest.mark.parametrize("shape", [(1, 32, 48, 128, 128, 128),
                                   (2, 19, 21, 128, 128, 128),
                                   (1, 2, 2, 16, 32, 4), (1, 9, 33, 32, 16, 8)])
def test_b7_matches_two_b4_on_card(cuda_device, out_int8, shape):
    """B7 bit-equal to two B4 launches (its documented contract), the
    float32 sums included: B7's layer 1 sums in B4's written order."""
    n, h, w, c4, c4m, c4o = shape
    x, k1, sc1 = _q8_layer(1, n, h, w, c4, c4m, cuda_device)
    _, k2, sc2 = _q8_layer(2, n, h, w, c4m, c4o, cuda_device, out_scale=0.02)
    before = fused_folded_conv2_q8.launches
    got = fused_folded_conv2_q8(x, k1, sc1, k2, sc2, out_int8, True)
    torch.cuda.synchronize()
    assert fused_folded_conv2_q8.launches == before + 1
    y1, s11, s12 = fused_folded_conv_q8(x, k1, sc1, True, True)
    y2, s21, s22 = fused_folded_conv_q8(y1, k2, sc2, out_int8, True)
    for g, r in zip(got, (y1, y2, s11, s12, s21, s22)):
        assert torch.equal(g, r)
    no_stats = fused_folded_conv2_q8(x, k1, sc1, k2, sc2, out_int8)
    assert torch.equal(no_stats[0], y1) and torch.equal(no_stats[1], y2)


def _q8_folded_kernel(seed, c4, c4o, device):
    """A quantized fold of a random image kernel: 36 of its 144 blocks
    non-zero, the blocks B4 and B7 take."""
    from rpst_torch.ops.folded_conv_q8 import quantize_weights
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((3, 3, c4 // 4, c4o // 4),
                                             dtype=np.float32))
    return quantize_weights(fold_conv_kernel(k))[0].contiguous().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape", [(1, 256, 256, 128, 128),
                                   (3, 10, 33, 128, 128), (1, 2, 37, 16, 132),
                                   (2, 9, 17, 128, 4), (1, 3, 5, 48, 64)])
def test_b4_listed_blocks_match_plain_on_card(cuda_device, dense, shape):
    """The tensor-core B4 takes only the listed blocks: with a quantized
    fold (36 blocks) and a dense kernel (144), at the path's shape and the
    tilings' edges (N = 3, W = 33 / 37, H = 2, 4C = 16 and 48, whose K steps
    span several input blocks, 4Co = 4 and 132), int8 and bf16 outputs
    bit-equal to the plain version; s1/s2 at rpst's gate rtol 1e-4, atol
    1e-3 (float32 sums in another order)."""
    x, k, sc = _q8_layer(4, *shape, cuda_device)
    if not dense:
        k = _q8_folded_kernel(5, shape[3], shape[4], cuda_device)
    for out_int8 in (True, False):
        got = fused_folded_conv_q8(x, k, sc, out_int8, True)
        torch.cuda.synchronize()
        ref = fused_folded_conv_q8_plain(x, k, sc, out_int8, True)
        assert torch.equal(got[0].view(torch.int8) if out_int8
                           else got[0].view(torch.int16),
                           ref[0].view(torch.int8) if out_int8
                           else ref[0].view(torch.int16))
        for g, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 64, 48, 128, 128, 128),
                                   (3, 10, 37, 16, 48, 128),
                                   (1, 2, 37, 128, 16, 12)])
def test_b7_listed_blocks_equal_two_b4_on_card(cuda_device, shape):
    """B7 with quantized folds in both layers: all six outputs, float32 sums
    included, equal to two B4 launches (phase 13's fuse_pairs equality)."""
    n, h, w, c4, c4m, c4o = shape
    x, _, sc1 = _q8_layer(6, n, h, w, c4, c4m, cuda_device)
    _, _, sc2 = _q8_layer(7, n, h, w, c4m, c4o, cuda_device, out_scale=0.02)
    k1 = _q8_folded_kernel(8, c4, c4m, cuda_device)
    k2 = _q8_folded_kernel(9, c4m, c4o, cuda_device)
    for out_int8 in (True, False):
        got = fused_folded_conv2_q8(x, k1, sc1, k2, sc2, out_int8, True)
        y1, s11, s12 = fused_folded_conv_q8(x, k1, sc1, True, True)
        y2, s21, s22 = fused_folded_conv_q8(y1, k2, sc2, out_int8, True)
        torch.cuda.synchronize()
        for g, r in zip(got, (y1, y2, s11, s12, s21, s22)):
            assert torch.equal(g, r)


@pytest.mark.cuda
def test_b4_refuses_misaligned_and_mixed(cuda_device):
    x, k, sc = _q8_layer(3, 1, 4, 4, 32, 16, cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        fused_folded_conv_q8(x, k.cpu(), sc, True)
    flat = torch.zeros(x.numel() + 4, dtype=torch.int8, device=cuda_device)
    shifted = flat[4:].view(x.shape)  # contiguous, 4 bytes past alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_folded_conv_q8(shifted, k, sc, True)


# ---------------------------------------------------------------- B5

from rpst_torch.ops.conv2d_q8 import (  # noqa: E402
    fused_conv2d_bf16, fused_conv2d_bf16_plain, fused_conv2d_q8,
    fused_conv2d_q8_plain, pack_conv2d_weights)


def _b5_layer(seed, n, h, w, c, co, device):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c, co), dtype=np.int8)
    sc = np.stack([rng.uniform(2e-6, 6e-6, co) * (128 / c),
                   rng.normal(0, 0.2, co),
                   rng.uniform(10.0, 40.0, co)]).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(k).to(device),
            torch.from_numpy(sc).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("out_int8", [True, False])
@pytest.mark.parametrize("alpha", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("pad_mode", ["reflect", "zero"])
@pytest.mark.parametrize("shape", [(2, 13, 37, 128, 128), (1, 2, 2, 4, 4),
                                   (2, 9, 19, 36, 260), (1, 32, 48, 256, 512)])
def test_b5_matches_plain_on_card(cuda_device, out_int8, alpha, pad_mode,
                                  shape):
    """int8 and bf16 outputs bit-equal to the plain version (exact int32
    sums, the same float32 epilogue): the bf16 bits include the -0.0 that
    alpha = 0 leaves for a negative value."""
    x, k, sc = _b5_layer(0, *shape, cuda_device)
    before = fused_conv2d_q8.launches
    got = fused_conv2d_q8(x, k, sc, out_int8, alpha, pad_mode)
    torch.cuda.synchronize()
    assert fused_conv2d_q8.launches == before + 1
    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, alpha, pad_mode)
    assert got.dtype == ref.dtype and got.is_cuda
    if out_int8:
        assert torch.equal(got, ref)
    else:
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("out_int8", [True, False])
@pytest.mark.parametrize("pad_mode", ["reflect", "zero"])
@pytest.mark.parametrize("shape", [
    (1, 2, 37, 4, 4), (2, 9, 2, 36, 132), (1, 8, 16, 48, 4),
    (1, 5, 17, 36, 68), (2, 13, 37, 48, 132), (3, 16, 33, 128, 192),
    (2, 512, 256, 32, 256), (2, 32, 32, 512, 512)])
def test_b5_tiling_edges_on_card(cuda_device, out_int8, pad_mode, shape):
    """The edges of the tensor-core tilings (16 pixel columns x 8 rows, 64
    or 128 output channels, 32 input channels a step): the k tail at C = 4,
    36, 48 (36 takes the unaligned staging), Co = 4 and 132, H or W = 2, W =
    33 and 37, and a shape for each of the two tilings a launch picks from
    (the last but one has 4096 blocks of 128 channels); with the weights
    packed by the caller, as the paths keep them. Bits equal."""
    x, k, sc = _b5_layer(1, *shape, cuda_device)
    packed = pack_conv2d_weights(k)
    got = fused_conv2d_q8(x, k, sc, out_int8, 0.2, pad_mode, w_packed=packed)
    again = fused_conv2d_q8(x, k, sc, out_int8, 0.2, pad_mode)
    torch.cuda.synchronize()
    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, 0.2, pad_mode)
    view = (lambda t: t) if out_int8 else (lambda t: t.view(torch.int16))
    assert torch.equal(view(got), view(ref))
    assert torch.equal(view(again), view(ref))
    with pytest.raises(ValueError, match="w_packed"):
        fused_conv2d_q8(x, k, sc, out_int8, 0.2, pad_mode,
                        w_packed=packed[..., :4])


@pytest.mark.cuda
@pytest.mark.parametrize("out_int8,alpha", [(True, 0.2), (False, 0.0)])
@pytest.mark.parametrize("shape", [(1, 4, 4, 4, 4), (2, 5, 17, 36, 68),
                                   (1, 33, 17, 128, 132),
                                   (2, 64, 64, 256, 256)])
def test_b5_7x7_matches_plain_on_card(cuda_device, out_int8, alpha, shape):
    """B5's 7x7 form (LD v1's big branch; reflect pad 3): the smallest map
    it takes, ragged tiles, Co off the channel blocks, a reduced path
    shape; bits equal to plain in both outputs and across two runs, one
    7x7 launch a call."""
    rng = np.random.default_rng(7)
    n, h, w, c, co = shape
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c),
                                      dtype=np.int8)).to(cuda_device)
    k = torch.from_numpy(rng.integers(-127, 128, (7, 7, c, co),
                                      dtype=np.int8)).to(cuda_device)
    sc = torch.from_numpy(np.stack([
        rng.uniform(2e-6, 6e-6, co) * (128 / c) * (9 / 49),
        rng.normal(0, 0.2, co), rng.uniform(10.0, 40.0, co)]).astype(
            np.float32)).to(cuda_device)
    before = fused_conv2d_q8.launches_7x7
    got = fused_conv2d_q8(x, k, sc, out_int8, alpha, "reflect")
    again = fused_conv2d_q8(x, k, sc, out_int8, alpha, "reflect",
                            w_packed=pack_conv2d_weights(k))
    torch.cuda.synchronize()
    assert fused_conv2d_q8.launches_7x7 == before + 2
    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, alpha, "reflect")
    view = (lambda t: t) if out_int8 else (lambda t: t.view(torch.int16))
    assert torch.equal(view(got), view(ref))
    assert torch.equal(view(again), view(ref))


def _b5_7x7_layer(shape, device, seed=7):
    """int8 x, (7, 7, C, Co) weights and scale rows near a real layer's."""
    rng = np.random.default_rng(seed)
    n, h, w, c, co = shape
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c),
                                      dtype=np.int8)).to(device)
    k = torch.from_numpy(rng.integers(-127, 128, (7, 7, c, co),
                                      dtype=np.int8)).to(device)
    sc = torch.from_numpy(np.stack([
        rng.uniform(2e-6, 6e-6, co) * (128 / c) * (9 / 49),
        rng.normal(0, 0.2, co), rng.uniform(10.0, 40.0, co)]).astype(
            np.float32)).to(device)
    return x, k, sc


@pytest.mark.cuda
@pytest.mark.parametrize("out_int8,alpha", [(True, 0.2), (False, 0.0),
                                            (True, 0.0), (False, 0.2)])
@pytest.mark.parametrize("shape", [
    (1, 4, 4, 32, 128), (2, 17, 33, 64, 128), (1, 33, 17, 64, 128),
    (1, 20, 20, 32, 4), (1, 20, 20, 32, 68), (1, 20, 20, 32, 132),
    (1, 20, 20, 32, 200), (1, 20, 20, 32, 260), (2, 19, 21, 4, 64),
    (2, 19, 21, 36, 64), (1, 5, 5, 64, 64), (8, 24, 24, 64, 128)])
def test_b5_7x7_wgmma_tile_edges_on_card(cuda_device, out_int8, alpha,
                                         shape):
    """The edges of the 7x7 form's tiling (16 x 16 pixels a block, 128
    output channels, 32-byte K chunks, clusters of two blocks sharing each
    weight stage): a map smaller than one tile (4 x 4, 5 x 5: the grid is
    padded to the cluster, one block computes outside the image), ragged
    tiles both ways (17 x 33, 33 x 17), Co off the 8-channel groups and the
    128-channel block (4, 68, 132, 200, 260), C = 4 and 36 (a partial
    chunk, rows not 16-byte aligned), N = 8; with the weights packed by the
    caller, as the path keeps them. Bits equal to plain in both outputs and
    across two runs, one 7x7 launch a call."""
    x, k, sc = _b5_7x7_layer(shape, cuda_device)
    packed = pack_conv2d_weights(k)
    before = fused_conv2d_q8.launches_7x7
    got = fused_conv2d_q8(x, k, sc, out_int8, alpha, "reflect",
                          w_packed=packed)
    again = fused_conv2d_q8(x, k, sc, out_int8, alpha, "reflect",
                            w_packed=packed)
    torch.cuda.synchronize()
    assert fused_conv2d_q8.launches_7x7 == before + 2
    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, alpha, "reflect")
    view = (lambda t: t) if out_int8 else (lambda t: t.view(torch.int16))
    assert torch.equal(view(got), view(ref))
    assert torch.equal(view(again), view(got))


@pytest.mark.cuda
def test_b5_7x7_refuses_what_its_kernel_does_not_take(cuda_device):
    """A 7x7 weight on the card reaches its kernel or raises: packed weights
    of the 3x3 order are refused, and so is a C past the exact int32 sum."""
    x, k, sc = _b5_7x7_layer((1, 8, 8, 32, 8), cuda_device)
    with pytest.raises(ValueError, match="w_packed"):
        fused_conv2d_q8(x, k, sc, True, 0.2, "reflect",
                        w_packed=pack_conv2d_weights(k).view(7, 7, 1, 8, 32))
    big = torch.zeros((1, 4, 4, 2052), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="C <= 2048"):
        fused_conv2d_q8(big, torch.zeros((7, 7, 2052, 4), dtype=torch.int8,
                                         device=cuda_device),
                        torch.zeros((3, 4), device=cuda_device), True)


@pytest.mark.cuda
@pytest.mark.parametrize("out_int8", [True, False])
def test_b5_mrf_decoder_head_on_card(cuda_device, out_int8):
    """The mrf decoder head's layer: 1024 -> 512, zero pad, relu, on the
    concat of the two encoders (a shape no earlier path gave B5), at a
    reduced size (64 x 64) and as the path packs it; bits equal to plain."""
    x, k, sc = _b5_layer(7, 1, 64, 64, 1024, 512, cuda_device)
    packed = pack_conv2d_weights(k)
    before = fused_conv2d_q8.launches
    got = fused_conv2d_q8(x, k, sc, out_int8, 0.0, "zero", w_packed=packed)
    torch.cuda.synchronize()
    assert fused_conv2d_q8.launches == before + 1
    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, 0.0, "zero")
    view = (lambda t: t) if out_int8 else (lambda t: t.view(torch.int16))
    assert got.shape == (1, 64, 64, 512) and torch.equal(view(got), view(ref))


@pytest.mark.cuda
def test_quantized_layer_carries_its_packed_weights_on_card(cuda_device):
    from rpst_torch.models.fast_path_q8_std import quantize_convs
    g = torch.Generator().manual_seed(0)
    w = torch.randn(128, 128, 3, 3, generator=g).to(cuda_device)
    layer, = quantize_convs([(w, torch.zeros(128, device=cuda_device))])
    assert torch.equal(layer.w_packed, pack_conv2d_weights(layer.w_q))


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("pad_mode", ["reflect", "zero"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 256, 256), (2, 9, 19, 40, 72),
                                   (1, 2, 2, 8, 8)])
def test_b5_bf16_mode_matches_plain_on_card(cuda_device, alpha, pad_mode,
                                            shape):
    n, h, w, c, co = shape
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, h, w, c, generator=g).to(cuda_device)
    k = (torch.randn(3, 3, c, co, generator=g) * (9 * c) ** -0.5).to(
        cuda_device)
    b = torch.randn(co, generator=g).to(cuda_device)
    before = fused_conv2d_bf16.launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = fused_conv2d_bf16(x, k, b, alpha, pad_mode)
        torch.cuda.synchronize()
        ref = fused_conv2d_bf16_plain(x, k, b, alpha, pad_mode)
    assert fused_conv2d_bf16.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.is_cuda
    torch.testing.assert_close(got.float(), ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.cuda
def test_b5_refuses_misaligned_and_mixed(cuda_device):
    x, k, sc = _b5_layer(3, 1, 4, 4, 32, 16, cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        fused_conv2d_q8(x, k.cpu(), sc, True)
    flat = torch.zeros(x.numel() + 4, dtype=torch.int8, device=cuda_device)
    shifted = flat[4:].view(x.shape)  # contiguous, 4 bytes past alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_conv2d_q8(shifted, k, sc, True)
    with pytest.raises(TypeError, match="scales is torch.float64"):
        fused_conv2d_q8(x, k, sc.double(), True)


# ---------------------------------------------------------------- B6

from rpst_torch.ops import flash_attention as fa  # noqa: E402


def _assert_o_close(got, ref, rel=BF16_O_REL, mean_rel=BF16_O_MEAN_REL):
    """O within rel x max |ref|, its mean abs err within mean_rel x it."""
    got, ref = got.float(), ref.float()
    err, size = (got - ref).abs(), ref.abs().max().item()
    assert err.max().item() <= rel * size
    assert err.mean().item() <= mean_rel * size


def _attention_inputs(seed, device, dtype, n, nq, nk, c, scale=1.0):
    rng = np.random.default_rng(seed)

    def t(*shape, f=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * f / c ** 0.25).to(device).to(dtype)
    return (t(n, nq, c, f=scale), t(n, nk, c, f=scale), t(n, nk, c),
            t(n, nq, c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("shape,scale", [((2, 20, 12, 128), 1.0),
                                         ((1, 1, 1, 128), 1.0),
                                         ((3, 33, 130, 256), 1.0),
                                         ((1, 160, 97, 512), 1.0),
                                         ((2, 64, 64, 384), 1.0),
                                         ((2, 64, 64, 128), 30.0),
                                         ((5, 1024, 1024, 512), 1.0)])
def test_b6_matches_plain_on_card(cuda_device, dtype, tol, shape, scale):
    """B6a-d against their plain versions: ragged tiles, every C the kernel
    takes, more blocks than SMs (the last case), large logits (q and k x 30
    at rpst's own 64 x 64 size, where the softmax is nearly one-hot; with
    many more keys two of them nearly tie in some row, and float32 rounding
    of scores near 1e3 then moves that row's P by ~1e-3 in either version;
    the float32 forward's O and the float32 gradients are there held
    against float64 oracles, by ``fa.f32_oracle_limit``: the gradients'
    P = exp(S - LSE) moves by the difference between the kernels' scores
    and those LSE was taken from, which no other summation order than
    plain's keeps below 1e-4); the float32 forward's O at x 1 also within
    1e-5 (mean 1e-6) of its own largest value (``fa.F32_O_REL``), the
    float32 gradients within 1e-5 (mean 1e-6) of their size from the
    float64 oracle (``fa.F32_GRAD_REL``), the bfloat16 gradients within 2e-2
    (mean 2e-3) of theirs from the plain versions (``fa.BF16_GRAD_REL``);
    dQ, dK and dV bit-equal across two runs (``fa.check_backward``)."""
    q, k, v, d_o = _attention_inputs(0, cuda_device, dtype, *shape,
                                     scale=scale)
    before = fa.launch_counts()
    o = fa.flash_fwd(q, k, v)
    o2, lse = fa.flash_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
    delta = (d_o.float() * ref_o.float()).sum(-1)
    f32_x30 = dtype == torch.float32 and scale != 1.0
    fa.check_backward(q, k, v, d_o, ref_lse, delta, tol, scale)
    assert fa.launch_counts() == {"B6_fwd": before["B6_fwd"] + 2,
                                  "B6_dq": before["B6_dq"] + 2,
                                  "B6_dkv": before["B6_dkv"] + 2}
    held = [] if f32_x30 else [(o, ref_o), (o2, ref_o)]
    for got, ref in held:
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    if f32_x30:
        ref64 = fa.attention_f64(q, k, v)
        limit = fa.f32_oracle_limit(ref_o, ref64)
        for got in (o, o2):
            assert torch.isfinite(got).all()
            assert (got.double() - ref64).abs().max().item() <= limit
    elif dtype == torch.float32:
        _assert_o_close(o, ref_o, fa.F32_O_REL, fa.F32_O_MEAN_REL)
        _assert_o_close(o2, ref_o, fa.F32_O_REL, fa.F32_O_MEAN_REL)
    else:
        _assert_o_close(o, ref_o)
        _assert_o_close(o2, ref_o)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("c", [128, 256, 384, 512])
@pytest.mark.parametrize("nq,nk", fa.BWD_EDGES)
def test_b6_backward_tile_edges_on_card(cuda_device, dtype, tol, c, nq, nk):
    """B6c and B6d one below, at and one above their tiles (16 rows a block
    x 32 swept rows), in both roles, N = 3, against the plain versions and
    within their own-size limits (``fa.check_backward``); bit-equal across
    two runs."""
    q, k, v, d_o = _attention_inputs(4, cuda_device, dtype, 3, nq, nk, c)
    ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
    delta = (d_o.float() * ref_o.float()).sum(-1)
    fa.check_backward(q, k, v, d_o, ref_lse, delta, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 256, 384, 512])
@pytest.mark.parametrize("nq", [31, 32, 33])
@pytest.mark.parametrize("nk", [63, 64, 65, 129])
def test_b6_bf16_forward_tile_edges_on_card(cuda_device, c, nq, nk):
    """The bfloat16 forward (tensor cores; 32 query rows x 64 keys a tile)
    one below, at and one above each tile size, at every width, N = 3: O
    within the bf16 tolerance and within 2% (mean 0.2%) of its own largest
    value, LSE 1e-4, B6a and B6b bit-equal to each
    other, and bit-stable from run to run; the launches count as bfloat16
    ones."""
    q, k, v, _ = _attention_inputs(c + nq + nk, cuda_device, torch.bfloat16,
                                   3, nq, nk, c)
    before = (fa.flash_fwd.launches_bf16, fa.flash_fwd_lse.launches_bf16)
    o = fa.flash_fwd(q, k, v)
    o2, lse = fa.flash_fwd_lse(q, k, v)
    o3 = fa.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches_bf16, fa.flash_fwd_lse.launches_bf16) == (
        before[0] + 2, before[1] + 1)
    ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
    assert torch.equal(o, o2) and torch.equal(o, o3)
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), ref_o.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    _assert_o_close(o, ref_o)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 256, 384, 512])
@pytest.mark.parametrize("nq,nk", fa.F32_FWD_EDGES)
def test_b6_f32_forward_tile_edges_on_card(cuda_device, c, nq, nk):
    """The float32 forward (tensor cores, three TF32 products; 32 query rows
    x 32 keys a tile) one below, at and one above each tile size and into a
    third key tile, at every width, N = 3: O within 1e-4 of its plain
    version and within 1e-5 (mean 1e-6) of its own largest value, LSE 1e-4,
    B6a and B6b bit-equal to each other and from run to run; no launch
    counts as a bfloat16 one."""
    q, k, v, _ = _attention_inputs(c + nq + nk, cuda_device, torch.float32,
                                   3, nq, nk, c)
    before = (fa.flash_fwd.launches_bf16, fa.flash_fwd_lse.launches_bf16)
    o = fa.flash_fwd(q, k, v)
    o2, lse = fa.flash_fwd_lse(q, k, v)
    o3 = fa.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches_bf16,
            fa.flash_fwd_lse.launches_bf16) == before
    ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
    assert torch.equal(o, o2) and torch.equal(o, o3)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, ref_o, rtol=F32_TOL, atol=F32_TOL)
    _assert_o_close(o, ref_o, fa.F32_O_REL, fa.F32_O_MEAN_REL)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_b6_float32_forward_is_not_counted_as_bf16(cuda_device):
    q, k, v, _ = _attention_inputs(0, cuda_device, torch.float32, 1, 40, 70,
                                   128)
    before = (fa.flash_fwd.launches, fa.flash_fwd.launches_bf16)
    fa.flash_fwd(q, k, v)
    assert (fa.flash_fwd.launches, fa.flash_fwd.launches_bf16) == (
        before[0] + 1, before[1])


@pytest.mark.cuda
def test_b6_function_on_card(cuda_device):
    """The autograd Function launches B6b, B6c and B6d once each; without a
    gradient to record the public function launches B6a."""
    q, k, v, d_o = _attention_inputs(1, cuda_device, torch.float32, 2, 70,
                                     50, 128)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    wrappers = (fa.flash_fwd, fa.flash_fwd_lse, fa.flash_bwd_dq,
                fa.flash_bwd_dkv)
    before = [w.launches for w in wrappers]
    out = fa.flash_attention(*leaves)
    out.backward(d_o)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(wrappers, before)] == [0, 1, 1, 1]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_fwd_plain(*ref_leaves).backward(d_o)
    for got, ref in zip(leaves, ref_leaves):
        torch.testing.assert_close(got.grad, ref.grad, rtol=1e-3, atol=1e-4)
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    assert fa.flash_fwd.launches == before[0] + 1


@pytest.mark.cuda
def test_b6_refuses_what_the_kernel_does_not_take(cuda_device):
    q, k, v, _ = _attention_inputs(2, cuda_device, torch.float32, 1, 8, 8,
                                   128)
    with pytest.raises(ValueError, match="is on cpu"):
        fa.flash_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_fwd(q[..., :64].contiguous(), k[..., :64].contiguous(),
                     v[..., :64].contiguous())
    with pytest.raises(TypeError):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    flat = torch.zeros(q.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(flat[1:].view(q.shape), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("shape", [(1, 16, 32, 32, 32), (2, 9, 17, 32, 3),
                                   (1, 5, 7, 3, 32)])
def test_halo_modes_match_plain_on_card(cuda_device, dtype, tol, shape):
    """B2 with row_rings=False and B3 with given rings (listed and dense)
    against their plain versions on the same card tensors (cuDNN without
    TF32), dx to B1's tolerances, dk / db as test_b2_b3_match_plain_on_card
    holds them, B3 bit-equal across two launches; and, in float32,
    FoldedConvActHalo's backward on the card against its plain form on the
    CPU, at slope 1 (an activation mask read from two devices' outputs
    flips where y is near 0)."""
    from rpst_torch.ops import folded_conv as fc
    x, k, b = _layer(1, *shape, cuda_device)
    rng = np.random.default_rng(2)
    n, h, w = shape[:3]
    rings = torch.from_numpy(rng.standard_normal(
        (n, 2, w, x.shape[3]), dtype=np.float32)).to(cuda_device)
    gz = torch.from_numpy(rng.standard_normal(
        (n, h, w, k.shape[3]), dtype=np.float32)).to(cuda_device)
    x, k, rings, gz = (t.to(dtype).contiguous() for t in (x, k, rings, gz))
    khat = k.flip(0, 1).transpose(2, 3).contiguous()
    before = (fc.fused_folded_conv_grad_input.launches_halo,
              fc.fused_folded_conv_grad_weight.launches_rings)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        dx = fc.fused_folded_conv_grad_input(gz, khat, row_rings=False)
        got = {listed: [fc.fused_folded_conv_grad_weight(x, gz, listed,
                                                         rings)
                        for _ in range(2)] for listed in (False, True)}
        torch.cuda.synchronize()
        rdx = fc.fused_folded_conv_grad_input_plain(gz, khat, row_rings=False)
        ref = {listed: fc.fused_folded_conv_grad_weight_plain(x, gz, listed,
                                                              rings)
               for listed in (False, True)}
    assert (fc.fused_folded_conv_grad_input.launches_halo,
            fc.fused_folded_conv_grad_weight.launches_rings) == (
                before[0] + 1, before[1] + 4)
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol, atol=tol)
    atol = 2e-3 * (n * h * w / 512) ** 0.5
    for listed, ((dk, db), (dk2, db2)) in got.items():
        assert torch.equal(dk, dk2) and torch.equal(db, db2)
        torch.testing.assert_close(dk, ref[listed][0], rtol=1e-4, atol=atol)
        torch.testing.assert_close(db, ref[listed][1], rtol=1e-4, atol=atol)
    if dtype != torch.float32:
        return
    ins = [t.detach().cpu() for t in (x, k, b, rings[:, :1], rings[:, 1:])]
    g = torch.from_numpy(rng.standard_normal((n, h, w, k.shape[3]),
                                             dtype=np.float32))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        ts = [t.to(dev).contiguous().requires_grad_(True) for t in ins]
        y = fc.folded_conv_act_halo(*ts, alpha=1.0)
        outs.append([a.cpu() for a in torch.autograd.grad(y, ts, g.to(dev))])
    for a, r in zip(*outs):
        torch.testing.assert_close(a, r, rtol=F32_TOL, atol=F32_TOL * max(
            1.0, float(r.abs().max())))
