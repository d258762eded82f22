"""B1 and B2 on the tensor cores (csrc/folded_mma.cuh), checked on the CPU.

The kernels run only on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py phase 2). Here:
  * the block table (``block_table``; each launch builds it on the card):
    which (tap, input block, output block) C x Co blocks of a folded
    kernel the K loop takes;
  * a numpy emulation of the kernels' loop over that table, tile by tile as
    the CUDA code walks it (halo staging with the ring rows and the channel-
    block rule for the ring columns, K steps of 32 bytes, n-tiles of 8
    channels, B2's four ring blocks and their scatter in the epilogue),
    held against the plain versions and rpst's Pallas kernels in interpret
    mode, with folded and with dense kernels;
  * the float32 arithmetic: three TF32 products a fragment stay within 1e-5
    of float64 at K = 9 x 512, where one product does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.ops.pallas.folded_conv import fused_folded_conv as j_fused
from rpst.ops.pallas.folded_conv import \
    fused_folded_conv_grad_input as j_grad_input
from rpst_torch.ops.folded import _fold_placement, fold_conv_kernel
from rpst_torch.ops.folded_conv import (block_table,
                                        fused_folded_conv_grad_input_plain,
                                        fused_folded_conv_plain, pack_k_major)
from test_torch_flash_attention import _tf32_product

# the kernels' tiling (folded_mma.cuh): tile rows / columns, channels of
# each output block a wide tile takes, rows of a ring block
TH, TW, TQ, RING_ROWS = 8, 16, 32, 16
TOL = dict(rtol=1e-5, atol=1e-5)  # float64 emulation vs float32 sums


def _kernel(rng, c, co, dense):
    """A (3, 3, 4c, 4co) float32 kernel: folded from a 3x3 c -> co conv, or
    dense (every block non-zero)."""
    if dense:
        return (rng.standard_normal((3, 3, 4 * c, 4 * co)) * 0.1).astype(
            np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.2).astype(np.float32)
    return fold_conv_kernel(torch.from_numpy(k)).numpy()


def _khat(kf):
    return np.ascontiguousarray(np.transpose(kf[::-1, ::-1], (0, 1, 3, 2)))


def _tiling(c4out):
    """(wide, blocked, TCO, channel tiles) of an output width, as
    ``folded::launch`` picks them."""
    cout = c4out // 4
    wide = c4out > 16
    blocked = wide and cout % 8 == 0
    tco = 4 * TQ if wide else 16
    gy = -(-cout // TQ) if blocked else -(-c4out // tco)
    return wide, blocked, tco, gy


def _chans(by, c4out):
    """The block's output channel of each local column (-1 past the
    layer): ``chan`` in folded_mma.cuh."""
    _, blocked, tco, _ = _tiling(c4out)
    cout = c4out // 4
    out = np.full(tco, -1)
    for cl in range(tco):
        if blocked:
            q = by * TQ + cl % TQ
            out[cl] = (cl // TQ) * cout + q if q < cout else -1
        elif by * tco + cl < c4out:
            out[cl] = by * tco + cl
    return out


def _halo(x, rings, n, r0, c0, bwd, dtype=np.float64):
    """The staged halo tile (TH + 2, TW + 2, C4in) of image n: B1 reads the
    ring rows from ``rings``, or without it from x by the reflect rule (row
    -1: the first half of the channels from row 1, the second from row 0;
    row H: from H-1 and H-2), and the ring columns by the channel-block
    rule (sub-column-1 blocks {1, 3} of column -1 from column 0, the others
    from column 1; mirrored at W); B2 zeros outside the image."""
    _, h, w, c4 = x.shape
    sub1 = (np.arange(c4) // (c4 // 4)) % 2 == 1
    first = np.arange(c4) < c4 // 2
    if rings is None:
        rings = np.stack([np.where(first, x[:, 1], x[:, 0]),
                          np.where(first, x[:, h - 1], x[:, h - 2])], 1)
    out = np.zeros((TH + 2, TW + 2, c4), dtype)
    for hr in range(TH + 2):
        for hc in range(TW + 2):
            rg, cg = r0 - 1 + hr, c0 - 1 + hc
            if bwd:
                if 0 <= rg < h and 0 <= cg < w:
                    out[hr, hc] = x[n, rg, cg]
                continue
            if not (-1 <= rg <= h and -1 <= cg <= w):
                continue
            row = rings[n, 0] if rg < 0 else rings[n, 1] if rg == h \
                else x[n, rg]
            col0 = 1 if cg < 0 else w - 1 if cg == w else cg
            col1 = 0 if cg < 0 else w - 2 if cg == w else cg
            out[hr, hc] = np.where(sub1, row[col1], row[col0])
    return out


def _emulate(x, k, ke, rings=None, bias=None, alpha=0.2, bwd=False,
             dtype=np.float64):
    """The kernels' loop over the block table, in float64.

    B1 (bwd False): x (N, H, W, 4C), k the folded kernel, ``rings`` (N, 2,
    W, 4C), the bias and slope. B2 (bwd True): x = gz, k = khat. ``ke`` is
    the channels of a K step (32 bytes: 8 float32, 16 bfloat16, 32 int8);
    ``dtype`` the sums' type (int64 for int8: exact, as the kernel's
    int32)."""
    n_, h, w, c4in = x.shape
    c4out = k.shape[3]
    cin, cout = c4in // 4, c4out // 4
    table = block_table(torch.from_numpy(np.ascontiguousarray(k))).numpy()
    bits = [table[:, :, s, :].reshape(9, 4).astype(bool) for s in range(4)]
    _, _, tco, gy = _tiling(c4out)
    ksteps = -(-c4in // ke)
    y = np.zeros((n_, h, w, c4out), dtype)
    taps_run = 0
    for n in range(n_):
        for r0 in range(0, h, TH):
            for c0 in range(0, w, TW):
                halo = _halo(x, rings, n, r0, c0, bwd, dtype)
                need = [r0 == 0, r0 + TH - 1 >= h - 2, c0 == 0,
                        c0 + TW - 1 >= w - 2]
                hb = h - r0
                for by in range(gy):
                    chans = _chans(by, c4out)
                    ok = chans >= 0
                    ntm = np.zeros((tco // 8, 4), bool)
                    for cl in np.flatnonzero(ok):
                        ntm[cl // 8, chans[cl] // cout] = True
                    # n-tiles run in pairs (2p, 2p + 1) on their union
                    ntm = ntm | ntm[np.arange(tco // 8) ^ 1]
                    acc = np.zeros((TH, TW, tco), dtype)
                    racc = np.zeros((4, RING_ROWS, tco), dtype)
                    for ks in range(ksteps):
                        k0, k1 = ks * ke, min(ks * ke + ke, c4in)
                        m = np.zeros((9, 4), bool)
                        for s in range(k0 // cin, (k1 - 1) // cin + 1):
                            m |= bits[s]
                        for tap in range(9):
                            if not m[tap].any():
                                continue
                            dr, dc = divmod(tap, 3)
                            a = halo[dr:dr + TH, dc:dc + TW, k0:k1]
                            rows = _ring_rows(halo, dr, dc, hb, w - c0,
                                              k0, k1)
                            for nt in range(tco // 8):
                                if not (m[tap] & ntm[nt]).any():
                                    continue
                                taps_run += 1
                                cols = chans[nt * 8:nt * 8 + 8]
                                wt = np.zeros((k1 - k0, 8), dtype)
                                wt[:, cols >= 0] = \
                                    k[dr, dc, k0:k1][:, cols[cols >= 0]]
                                acc[:, :, nt * 8:nt * 8 + 8] += a @ wt
                                for ring in range(4):
                                    if bwd and need[ring] and \
                                            rows[ring] is not None:
                                        racc[ring, :, nt * 8:nt * 8 + 8] += \
                                            rows[ring] @ wt
                    _epilogue(y, acc, racc, need, n, r0, c0, chans, bias,
                              alpha, bwd)
    return y, taps_run


def _ring_rows(halo, dr, dc, hb, hc_right, k0, k1):
    """The A rows of B2's ring blocks at one tap (None where the tap does
    not reach the block): 0 the ring row above (tap row 2 on halo row 1),
    1 below (tap row 0 on halo row H - r0), 2 the ring column left (tap
    column 2 on halo column 1), 3 right (tap column 0 on halo column W -
    c0); a column block's row r is tile row r - 1 (halo row r - 1 + dr),
    zero outside the halo."""
    out = [None] * 4
    if dr == 2:
        out[0] = halo[1, dc:dc + RING_ROWS, k0:k1]
    if dr == 0 and 0 <= hb <= TH + 1:
        out[1] = halo[hb, dc:dc + RING_ROWS, k0:k1]
    for ring, want, col in ((2, 2, 1), (3, 0, hc_right)):
        if dc == want and 0 <= col <= TW + 1:
            a = np.zeros((RING_ROWS, k1 - k0))
            for mr in range(RING_ROWS):
                hr = mr - 1 + dr
                if 0 <= hr <= TH + 1:
                    a[mr] = halo[hr, col, k0:k1]
            out[ring] = a
    return out


def _epilogue(y, acc, racc, need, n, r0, c0, chans, bias, alpha, bwd):
    _, h, w, c4out = y.shape
    cout = c4out // 4
    ok = chans >= 0
    ch = chans[ok]
    blk = ch // cout
    sj0, si0 = blk % 2 == 0, blk < 2
    hb = h - r0
    for ti in range(TH):
        for tj in range(TW):
            r, c = r0 + ti, c0 + tj
            if r >= h or c >= w:
                continue
            v = acc[ti, tj, ok].copy()
            if bwd:
                ring = racc[:, :, ok]
                hit_l = need[2] & (((c == 1) & sj0) | ((c == 0) & ~sj0))
                hit_r = need[3] & (((c == w - 1) & sj0) | ((c == w - 2) & ~sj0))
                v += np.where(hit_l, ring[2, ti + 1], 0.0)
                v += np.where(hit_r, ring[3, ti + 1], 0.0)
                top = need[0] & (((r == 1) & si0) | ((r == 0) & ~si0))
                v += np.where(top, ring[0, tj]
                              + np.where(hit_l, ring[2, 0], 0.0)
                              + np.where(hit_r, ring[3, 0], 0.0), 0.0)
                bot = need[1] & (((r == h - 1) & si0) | ((r == h - 2) & ~si0))
                if bot.any():
                    v += np.where(bot, ring[1, tj]
                                  + np.where(hit_l, ring[2, hb + 1], 0.0)
                                  + np.where(hit_r, ring[3, hb + 1], 0.0),
                                  0.0)
            else:
                v = v + bias[ch]
                v = np.where(v >= 0, v, alpha * v)
            y[n, r, c, ch] = v


# ---------------------------------------------------------------- the table

def test_block_table_of_a_folded_kernel_lists_36_blocks(rng):
    kf = _kernel(rng, 8, 8, dense=False)
    table = block_table(torch.from_numpy(kf)).numpy()
    assert table.dtype == np.uint8 and table.shape == (3, 3, 4, 4)
    assert int(table.sum()) == 36
    # 9 per output sub-position, as the unfolded conv's 9 taps
    assert table.sum(axis=(0, 1, 2)).tolist() == [9, 9, 9, 9]
    placement = _fold_placement(torch.float32, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(table.astype(bool),
                                  placement.any(axis=-1))


def test_block_table_of_dense_and_rotated_kernels(rng):
    dense = _kernel(rng, 3, 5, dense=True)
    assert int(block_table(torch.from_numpy(dense)).sum()) == 144
    kf = _kernel(rng, 4, 8, dense=False)
    kf[1, 1, :4, :8] = np.nan  # a NaN is listed: it must reach the sums
    t_kf = block_table(torch.from_numpy(kf)).numpy()
    t_hat = block_table(torch.from_numpy(_khat(kf))).numpy()
    np.testing.assert_array_equal(
        t_hat, np.transpose(t_kf[::-1, ::-1], (0, 1, 3, 2)))
    assert t_kf[1, 1, 0, 0] == 1


def test_pack_k_major_float32():
    w = torch.arange(3 * 3 * 12 * 5, dtype=torch.float32).reshape(3, 3, 12, 5)
    p = pack_k_major(w)
    assert tuple(p.shape) == (3, 3, 2, 5, 8)  # 8 floats = 32 bytes a step
    assert torch.equal(p[1, 2, 1, 3, :4], w[1, 2, 8:12, 3])
    assert torch.equal(p[1, 2, 1, 3, 4:], torch.zeros(4))
    assert torch.equal(p[0, 0, 0, :, 5], w[0, 0, 5, :])


# ---------------------------------------------------------------- B1

@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("ke", [8, 16])
def test_b1_emulation_matches_plain_and_pallas(rng, ke, dense):
    """C4 = 128, the width rpst's kernel runs (tests/test_folded.py): the
    blocked tiling, a K step inside one input block."""
    x = rng.standard_normal((2, 16, 8, 128)).astype(np.float32)
    kf = _kernel(rng, 32, 32, dense)
    b = rng.standard_normal(128).astype(np.float32)
    got, taps = _emulate(x, kf, ke, None, b, 0.2)
    plain = fused_folded_conv_plain(*(torch.from_numpy(t)
                                      for t in (x, kf, b)), 0.2).numpy()
    ref = np.asarray(j_fused(jnp.asarray(x), jnp.asarray(kf), jnp.asarray(b),
                             interpret=True, alpha=0.2))
    np.testing.assert_allclose(got, plain, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    # the loop takes the listed blocks and no more: per tile and K step,
    # the listed blocks of the step's input block (36 or 9) x 4 n-tiles of
    # an output block; 4 tiles (2 images x 2 row tiles), 128 / ke steps
    assert taps == 4 * (128 // ke) * (144 if dense else 36)


def test_b1_emulation_rings_override(rng):
    x = rng.standard_normal((2, 16, 8, 128)).astype(np.float32)
    kf = _kernel(rng, 32, 32, dense=False)
    b = rng.standard_normal(128).astype(np.float32)
    rings = rng.standard_normal((2, 2, 8, 128)).astype(np.float32)
    got, _ = _emulate(x, kf, 8, rings, b, 0.2)
    ref = np.asarray(j_fused(jnp.asarray(x), jnp.asarray(kf), jnp.asarray(b),
                             interpret=True, rings=jnp.asarray(rings)))
    plain = fused_folded_conv_plain(
        *(torch.from_numpy(t) for t in (x, kf, b)), 0.2,
        torch.from_numpy(rings)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("ke", [8, 16])
@pytest.mark.parametrize("shape,alpha", [
    ((2, 9, 17, 3, 32), 0.2),   # 12 -> 128: K steps span the 4 blocks
    ((1, 10, 18, 32, 3), 0.0),  # 128 -> 12: the narrow tiling
    ((1, 2, 2, 4, 5), 0.2),     # 16 -> 20: Co = 5, the wide dense tiling
    ((1, 3, 5, 16, 8), 0.0),    # 64 -> 32: Co = 8, blocked, 3/4 n-tiles off
    ((1, 2, 3, 2, 64), 0.2),    # 8 -> 256: two channel tiles
])
def test_b1_emulation_matches_plain_at_the_edges(rng, shape, alpha, ke,
                                                 dense):
    """Ragged tiles, the smallest foldable image, the 12-wide image sides
    and widths off the blocked tiling, against the plain version; the ring
    rows read from x, as the kernel does without a rings override."""
    n, h, w, c, co = shape
    x = rng.standard_normal((n, h, w, 4 * c)).astype(np.float32)
    kf = _kernel(rng, c, co, dense)
    b = rng.standard_normal(4 * co).astype(np.float32)
    got, _ = _emulate(x, kf, ke, None, b, alpha)
    plain = fused_folded_conv_plain(*(torch.from_numpy(t)
                                      for t in (x, kf, b)), alpha).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


# ---------------------------------------------------------------- B2

@pytest.mark.parametrize("dense", [False, True])
def test_b2_emulation_matches_plain_and_pallas(rng, dense):
    gz = rng.standard_normal((2, 16, 16, 128)).astype(np.float32)
    khat = _khat(_kernel(rng, 32, 32, dense))
    got, _ = _emulate(gz, khat, 8, bwd=True)
    ref = np.asarray(j_grad_input(jnp.asarray(gz), jnp.asarray(khat),
                                  interpret=True))
    plain = fused_folded_conv_grad_input_plain(
        torch.from_numpy(gz), torch.from_numpy(khat)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("ke", [8, 16])
@pytest.mark.parametrize("shape", [
    (1, 9, 17, 32, 32),   # rows H-2, H-1 and columns W-2, W-1 in two tiles
    (2, 2, 2, 3, 3),      # the smallest image: all four rings in one tile
    (1, 3, 5, 32, 3),     # gz 12 wide: K steps span the 4 blocks
    (1, 17, 33, 3, 32),   # dx 12 wide: the narrow tiling
    (1, 10, 16, 16, 64),  # 64 -> 256 (dx), two channel tiles
])
def test_b2_emulation_matches_plain_at_the_edges(rng, shape, ke, dense):
    """The ring adjoint's tile cases: ring row and column owners apart,
    the 2x2 image where the row and column scatters overlap, and the
    12-wide sides. (N, H, W, C, Co) of the forward layer: gz has 4Co
    channels, dx 4C."""
    n, h, w, c, co = shape
    gz = rng.standard_normal((n, h, w, 4 * co)).astype(np.float32)
    khat = _khat(_kernel(rng, c, co, dense))
    got, _ = _emulate(gz, khat, ke, bwd=True)
    plain = fused_folded_conv_grad_input_plain(
        torch.from_numpy(gz), torch.from_numpy(khat)).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


# ---------------------------------------------------------------- float32

def test_three_tf32_products_hold_1e5_at_k_9x512():
    """The float32 kernels' fragment arithmetic (mma_common.cuh
    ``tf32::mma3``) at B1 / B2's deepest K, 9 taps x 512 channels, 8 channels
    an ``mma``: three TF32 products stay within 1e-5 of max |ref| from
    float64, one product does not (the reason the kernels pay for three)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 9 * 512)).astype(np.float32)
    b = rng.standard_normal((9 * 512, 32)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    size = np.abs(ref).max()
    three = np.abs(_tf32_product(a, b, 3, 8) - ref).max() / size
    one = np.abs(_tf32_product(a, b, 1, 8) - ref).max() / size
    assert three < 1e-5, three
    assert one > 1e-5 * 10, one
