"""B5 of the port, ``rpst_torch.ops.conv2d_q8``, on the CPU: the plain
PyTorch versions against rpst's Pallas kernel in interpret mode (as
tests/test_conv2d_q8.py runs it) and against a numpy int64 oracle built on
``np.pad``, which shares no code with either.

Tolerances: int8 outputs bit-equal at the shapes of tests/test_conv2d_q8.py
(at a larger one, only exact ties differ: see
``test_interpret_mode_differs_only_where_a_fused_multiply_add_would``);
bfloat16 outputs within one bf16 step,
compared numerically, so the -0.0 that ``alpha * y`` leaves at alpha = 0
equals +0.0 here (the sign itself is pinned in its own test); the bf16 mode
2e-2 (float32 sums of bf16 products in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rpst.ops.pallas.conv2d_q8 import fused_conv2d_bf16 as jax_conv2d_bf16
from rpst.ops.pallas.conv2d_q8 import fused_conv2d_q8 as jax_conv2d_q8
from rpst_torch.ops.conv2d_q8 import (fused_conv2d_bf16,
                                      fused_conv2d_bf16_plain, fused_conv2d_q8,
                                      fused_conv2d_q8_plain,
                                      pack_conv2d_weights)


def _layer(seed, n, h, w, c, co):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c, co), dtype=np.int8)
    sc = np.stack([rng.uniform(1e-4, 1e-3, co), rng.normal(0, 0.5, co),
                   rng.uniform(20.0, 80.0, co)]).astype(np.float32)
    return x, k, sc


def _bf16_steps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in bf16 steps (bit patterns in a monotonic integer
    order, -0 == +0)."""
    def order(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return int((order(a) - order(b)).abs().max())


def _numpy_oracle(x, k, sc, out_int8, alpha, pad_mode):
    """int64 sums over np.pad, then the float32 epilogue in numpy."""
    mode = "reflect" if pad_mode == "reflect" else "constant"
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)), mode)
    n, h, w, _ = x.shape
    acc = np.zeros((n, h, w, k.shape[3]), np.int64)
    for dr in range(3):
        for dc in range(3):
            acc += xp[:, dr:dr + h, dc:dc + w] @ k[dr, dc].astype(np.int64)
    y = acc.astype(np.float32) * sc[0] + sc[1]
    y = np.where(y >= 0, y, np.float32(alpha) * y)
    if out_int8:
        return np.clip(np.round(y * sc[2]), -127, 127).astype(np.int8)
    return y


@pytest.mark.parametrize("out_int8", [True, False])
@pytest.mark.parametrize("alpha", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("pad_mode", ["reflect", "zero"])
def test_plain_matches_rpst_interpret_and_oracle(out_int8, alpha, pad_mode):
    x, k, sc = _layer(0, 2, 12, 16, 256, 128)
    ref = jax_conv2d_q8(jnp.asarray(x), jnp.asarray(k), jnp.asarray(sc),
                        out_int8, alpha=alpha, pad_mode=pad_mode,
                        block_rows=4, interpret=True)
    got = fused_conv2d_q8(torch.from_numpy(x), torch.from_numpy(k),
                          torch.from_numpy(sc), out_int8, alpha, pad_mode)
    oracle = _numpy_oracle(x, k, sc, out_int8, alpha, pad_mode)
    if out_int8:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), oracle)
    else:
        assert got.dtype == torch.bfloat16
        ref_t = torch.from_numpy(np.asarray(ref, np.float32)).bfloat16()
        assert _bf16_steps(got, ref_t) <= 1
        assert _bf16_steps(got, torch.from_numpy(oracle).bfloat16()) <= 1


def test_interpret_mode_differs_only_where_a_fused_multiply_add_would():
    """rpst's source computes ``acc * deq + bias`` as two float32 roundings,
    and so do the port's plain version and its kernel. At some shapes the
    CPU compiler behind rpst's interpret mode fuses them into one (an FMA),
    which moves an exact .5 requantization tie by one int8 step. Every
    element where the port differs from interpret mode must be such a tie:
    one where the one-rounding value requantizes to interpret mode's int8."""
    rng = np.random.default_rng(0)
    n, h, w, c, co = 4, 32, 32, 256, 512
    x = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c, co), dtype=np.int8)
    sc = np.stack([rng.uniform(2e-7, 6e-7, co), rng.normal(0, 0.05, co),
                   np.full(co, 1 / 0.0041)]).astype(np.float32)
    ref = np.asarray(jax_conv2d_q8(jnp.asarray(x), jnp.asarray(k),
                                   jnp.asarray(sc), True, alpha=1.0,
                                   pad_mode="zero", interpret=True))
    got = fused_conv2d_q8(torch.from_numpy(x), torch.from_numpy(k),
                          torch.from_numpy(sc), True, 1.0, "zero").numpy()
    differ = got != ref
    assert differ.mean() < 1e-5
    acc = F.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                   torch.from_numpy(k).double().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1).numpy()
    fused = (acc * sc[0].astype(np.float64)
             + sc[1].astype(np.float64)).astype(np.float32)
    q_fused = np.clip(np.round(fused * sc[2]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q_fused[differ], ref[differ])
    assert np.abs(got.astype(np.int16) - ref)[differ].max(initial=0) <= 1


def test_alpha_zero_keeps_the_negative_zero():
    """where(y >= 0, y, 0 * y) leaves -0.0 for a negative y, in rpst's
    kernel and in the port's plain version alike."""
    x, k, sc = _layer(1, 1, 6, 8, 128, 128)
    got = fused_conv2d_q8_plain(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(sc), False, 0.0, "zero")
    ref = np.asarray(jax_conv2d_q8(jnp.asarray(x), jnp.asarray(k),
                                   jnp.asarray(sc), False, alpha=0.0,
                                   pad_mode="zero", interpret=True),
                     np.float32)
    neg_zero = np.signbit(got.float().numpy()) & (got.float().numpy() == 0)
    assert neg_zero.any()
    np.testing.assert_array_equal(neg_zero, np.signbit(ref) & (ref == 0))


@pytest.mark.parametrize("shape", [(1, 2, 2, 4, 4), (2, 5, 7, 36, 20),
                                   (1, 9, 3, 128, 132)])
def test_plain_matches_oracle_on_odd_shapes(shape):
    """H != W, W no multiple of a tile, widths that are only multiples of
    4: the numpy oracle alone (rpst's kernel wants 128 lanes)."""
    x, k, sc = _layer(2, *shape)
    for pad_mode in ("reflect", "zero"):
        got = fused_conv2d_q8(torch.from_numpy(x), torch.from_numpy(k),
                              torch.from_numpy(sc), True, 0.2, pad_mode)
        np.testing.assert_array_equal(
            got.numpy(), _numpy_oracle(x, k, sc, True, 0.2, pad_mode))


@pytest.mark.parametrize("pad_mode", ["reflect", "zero"])
@pytest.mark.parametrize("alpha", [0.0, 0.2])
def test_bf16_plain_matches_rpst_interpret(pad_mode, alpha):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 8, 12, 128)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 128, 128)) * 0.1).astype(np.float32)
    b = rng.normal(size=(128,)).astype(np.float32)
    ref = np.asarray(jax_conv2d_bf16(jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(b), alpha=alpha,
                                     pad_mode=pad_mode, block_rows=4,
                                     interpret=True), np.float32)
    got = fused_conv2d_bf16(torch.from_numpy(x), torch.from_numpy(k),
                            torch.from_numpy(b), alpha, pad_mode)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2, atol=2e-2)
    plain = fused_conv2d_bf16_plain(torch.from_numpy(x), torch.from_numpy(k),
                                    torch.from_numpy(b), alpha, pad_mode)
    assert torch.equal(got, plain)


def test_wrappers_count_no_launch_on_the_cpu():
    x, k, sc = _layer(4, 1, 4, 4, 8, 8)
    before = fused_conv2d_q8.launches, fused_conv2d_bf16.launches
    fused_conv2d_q8(torch.from_numpy(x), torch.from_numpy(k),
                    torch.from_numpy(sc), True)
    fused_conv2d_bf16(torch.randn(1, 4, 4, 8), torch.randn(3, 3, 8, 8),
                      torch.randn(8))
    assert (fused_conv2d_q8.launches, fused_conv2d_bf16.launches) == before


@pytest.mark.parametrize("bad,match", [
    (dict(pad_mode="edge"), "unknown pad_mode"),
    (dict(x_shape=(1, 1, 4, 8)), "H, W >= 2"),
    (dict(x_shape=(1, 4, 4, 6), k_shape=(3, 3, 6, 8)), "multiples of 4"),
    (dict(k_shape=(3, 3, 16, 8)), r"w must be \(3, 3, 8, Co\)"),
    (dict(sc_shape=(2, 8)), r"scales must be \(3, 8\)"),
])
def test_q8_wrapper_refuses_bad_input(bad, match):
    x = torch.zeros(bad.get("x_shape", (1, 4, 4, 8)), dtype=torch.int8)
    k = torch.zeros(bad.get("k_shape", (3, 3, 8, 8)), dtype=torch.int8)
    sc = torch.zeros(bad.get("sc_shape", (3, 8)))
    with pytest.raises(ValueError, match=match):
        fused_conv2d_q8(x, k, sc, True, 0.2, bad.get("pad_mode", "zero"))


def test_q8_wrapper_refuses_types_and_layout():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    k = torch.zeros((3, 3, 8, 8), dtype=torch.int8)
    sc = torch.zeros((3, 8))
    with pytest.raises(TypeError, match="x_q is torch.float32"):
        fused_conv2d_q8(x.float(), k, sc, True)
    with pytest.raises(ValueError, match="must be contiguous"):
        fused_conv2d_q8(x.permute(0, 2, 1, 3), k, sc, True)


@pytest.mark.parametrize("c,co,dtype", [(4, 4, torch.int8),
                                        (36, 132, torch.int8),
                                        (48, 8, torch.int8),
                                        (128, 64, torch.int8),
                                        (8, 8, torch.bfloat16),
                                        (40, 72, torch.bfloat16)])
def test_packed_weights_are_the_hwio_weights_k_major(c, co, dtype):
    """``pack_conv2d_weights``: (3, 3, steps, Co, KE) with 32 bytes of input
    channels per step, zeros past C; summing tap by tap over the packed
    copy gives the plain conv's integer sums."""
    g = torch.Generator().manual_seed(c + co)
    w = torch.randint(-127, 128, (3, 3, c, co), generator=g).to(dtype)
    packed = pack_conv2d_weights(w)
    ke = 32 if dtype == torch.int8 else 16
    steps = -(-c // ke)
    assert packed.shape == (3, 3, steps, co, ke) and packed.is_contiguous()
    assert packed.dtype == dtype
    back = packed.permute(0, 1, 2, 4, 3).reshape(3, 3, steps * ke, co)
    assert torch.equal(back[:, :, :c], w)
    assert not back[:, :, c:].any()
    x = torch.randint(-127, 128, (1, 4, 5, c), generator=g).double()
    xp = F.pad(x, (0, steps * ke - c)).reshape(1, 4, 5, steps, ke)
    for dr in range(3):
        for dc in range(3):
            got = torch.einsum("nhwse,soe->nhwo", xp, packed[dr, dc].double())
            assert torch.equal(got, x @ w[dr, dc].double())


def test_packed_weights_argument_is_checked():
    x, k, sc = (torch.from_numpy(a) for a in _layer(0, 1, 4, 4, 36, 8))
    packed = pack_conv2d_weights(k)
    ref = fused_conv2d_q8(x, k, sc, True)
    assert torch.equal(fused_conv2d_q8(x, k, sc, True, w_packed=packed), ref)
    with pytest.raises(ValueError, match="pack_conv2d_weights"):
        pack_conv2d_weights(k.float())
    with pytest.raises(ValueError, match="pack_conv2d_weights"):
        pack_conv2d_weights(k[0])


def test_quantized_layer_is_built_whole_and_frozen():
    """``quantize_convs`` builds a layer with everything B5 reads (on the
    CPU no packed copy: the plain version reads HWIO), and a built layer
    cannot be given other weights under its packed copy."""
    import dataclasses

    from rpst_torch.models.fast_path_q8_std import quantize_convs
    g = torch.Generator().manual_seed(0)
    w = torch.randn(128, 128, 3, 3, generator=g)
    layer, small = quantize_convs([(w, torch.zeros(128)),
                                   (w[:8, :8], torch.zeros(8))])
    assert small is None
    assert layer.w_q.shape == (3, 3, 128, 128) and layer.w_q.dtype == torch.int8
    assert layer.w_packed is None
    with pytest.raises(dataclasses.FrozenInstanceError):
        layer.w_q = layer.w_q.clone()
