"""B4 and B7 on the tensor cores (csrc/folded_conv_q8.cu,
csrc/folded_conv2_q8.cu), checked on the CPU.

The kernels run only on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py phase 12, tools/b4_compile_check.py). Here:
  * a quantized fold of an image kernel keeps its zero blocks: its block
    table (each launch builds it on the card) lists 36 of 144, with the
    port's and with rpst's quantizer;
  * B4's walk: folded_mma.cuh's loop over the listed blocks emulated in
    numpy int64 (test_torch_folded_conv_blocks._emulate with K steps of 32
    int8 channels; at 4C = 16 a step spans the four input blocks and takes
    their union), then the int8 epilogue in float32 numpy, bit-equal to the
    plain version and to rpst's kernel in interpret mode (its bfloat16
    output within one ulp: interpret mode fuses the epilogue's
    multiply-add);
  * B7's split: layer 1 on the tile's interior and, as four more row blocks,
    its 1-pixel halo ring, requantized into the tile's region, y1's reflect
    ring filled from it, layer 2 from there: y1 and y2 equal to two plain
    B4 launches;
  * the stats' written order (folded_mma.cuh `q8_epilogue`) in float32
    numpy: per thread, a fixed shuffle tree, the warp rows in order, the
    tiles in 32 ordered chunks in double. Layer 1's sums are bit-equal between B7's
    split and a B4 launch, and within rpst's gate (rtol 1e-4, atol 1e-3) of
    the plain version's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.ops.folded import fold_conv_kernel as j_fold_conv_kernel
from rpst.ops.pallas.folded_conv_q8 import fused_folded_conv_q8 as j_conv_q8
from rpst.ops.pallas.folded_conv_q8 import quantize_weights as j_quantize_w
from rpst_torch.ops.folded import fold_conv_kernel
from rpst_torch.ops.folded_conv import block_table, listed_blocks
from rpst_torch.ops.folded_conv2_q8 import fused_folded_conv2_q8_plain
from rpst_torch.ops.folded_conv_q8 import (fused_folded_conv_q8_plain,
                                           quantize_weights)
from test_torch_folded_conv_blocks import _emulate

TH, TW = 8, 16  # the kernels' output tile (folded_mma.cuh)
KE = 32         # int8 channels of a K step
STATS_TOL = dict(rtol=1e-4, atol=1e-3)  # rpst's gate, tests/test_q8.py


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (jax's are not)


def _kernel(rng, c4, c4o, dense):
    """A (3, 3, 4C, 4Co) int8 kernel: a quantized fold of a random image
    kernel (zero outside its 36 blocks), or dense random int8."""
    if dense:
        return rng.integers(-127, 128, (3, 3, c4, c4o), dtype=np.int8)
    k = rng.standard_normal((3, 3, c4 // 4, c4o // 4)).astype(np.float32)
    return quantize_weights(fold_conv_kernel(_t(k)))[0].numpy()


def _layer(rng, n, h, w, c4, c4o, dense, out_scale=0.05):
    """x_q, w_q and float32 scale rows [deq, bias, 1 / out_scale]."""
    x = rng.integers(-127, 128, (n, h, w, c4), dtype=np.int8)
    deq = rng.uniform(2e-6, 6e-6, c4o).astype(np.float32)
    bias = rng.normal(0, 0.2, c4o).astype(np.float32)
    inv = np.full(c4o, np.float32(1.0 / out_scale), np.float32)
    return x, _kernel(rng, c4, c4o, dense), np.stack([deq, bias, inv])


# ---------------------------------------------------------------- numpy
# forms of the kernels' arithmetic

def _walk(x, k):
    """B4's int32 sums by folded_mma.cuh's loop, in int64: (sums, the (tap,
    n-tile) products it ran)."""
    c4o = k.shape[3]
    return _emulate(x.astype(np.int64), k.astype(np.int64), KE,
                    bias=np.zeros(c4o, np.int64), alpha=1, dtype=np.int64)


def _epilogue(acc, sc):
    """q8::epilogue in float32: float(acc) * deq + bias as two roundings,
    then lrelu 0.2."""
    y = acc.astype(np.float32) * sc[0]
    y = y + sc[1]
    return np.where(y >= 0, y, np.float32(0.2) * y)


def _requant(y, inv):
    """q8::requant: clip(round half to even(y * inv), -127, 127)."""
    return np.clip(np.rint(y * inv), -127, 127).astype(np.int8)


def _out(y, sc, out_int8):
    return (_t(_requant(y, sc[2])) if out_int8
            else _t(y).to(torch.bfloat16))


def _bf16_ulps(a, b):
    """Max distance in bfloat16 steps (bit patterns in a monotonic integer
    order, -0 == +0)."""
    def order(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (order(a) - order(b)).abs().max().item()


def _tile_partial(v, valid, c4o):
    """One tile's per-channel partial sums (s1, s2) in q8_epilogue's order:
    v (TH, TW, C) float32, valid (TH, TW) its in-image pixels."""
    wm_n, mt = (4, 2) if c4o > 16 else (8, 1)  # wide / narrow tiling
    s1 = np.zeros((wm_n, 8, v.shape[-1]), np.float32)
    s2 = np.zeros_like(s1)
    for wm in range(wm_n):
        for g in range(8):
            for i in range(mt):          # row block, then pixel g, g + 8
                for h in range(2):
                    r, c = wm * mt + i, g + 8 * h
                    if valid[r, c]:
                        s1[wm, g] = s1[wm, g] + v[r, c]
                        s2[wm, g] = s2[wm, g] + v[r, c] * v[r, c]
    for x in (1, 2, 4):                  # shfl_xor 4, 8, 16: g ^ 1, 2, 4
        perm = np.arange(8) ^ x
        s1, s2 = s1 + s1[:, perm], s2 + s2[:, perm]
    p1 = np.zeros(v.shape[-1], np.float32)
    p2 = np.zeros_like(p1)
    for wm in range(wm_n):               # the warp rows in order
        p1, p2 = p1 + s1[wm, 0], p2 + s2[wm, 0]
    return p1, p2


def _tiles(h, w):
    return [(r0, c0) for r0 in range(0, h, TH) for c0 in range(0, w, TW)]


def _tile_view(v, r0, c0):
    """The (TH, TW, C) tile of v at (r0, c0), zero past the image, and its
    in-image mask."""
    h, w = v.shape[:2]
    out = np.zeros((TH, TW, v.shape[-1]), v.dtype)
    rows, cols = min(TH, h - r0), min(TW, w - c0)
    out[:rows, :cols] = v[r0:r0 + rows, c0:c0 + cols]
    valid = np.zeros((TH, TW), bool)
    valid[:rows, :cols] = True
    return out, valid


def _finalize(parts):
    """q8::finalize_sums: 32 contiguous chunks of the tiles, each added in
    tile order in double, then the chunks in order; rounded to float32."""
    per = -(-len(parts) // 32)
    total = np.zeros(parts[0].shape, np.float64)
    for k in range(32):
        chunk = np.zeros(parts[0].shape, np.float64)
        for p in parts[k * per:(k + 1) * per]:
            chunk = chunk + p.astype(np.float64)
        total = total + chunk
    return total.astype(np.float32)


def _b4_stats(y):
    """B4's (N, C) sums of y (N, H, W, C) float32, tile by tile."""
    n, h, w, c4o = y.shape
    s1, s2 = [], []
    for b in range(n):
        parts = [_tile_partial(*_tile_view(y[b], r0, c0), c4o)
                 for r0, c0 in _tiles(h, w)]
        s1.append(_finalize([p[0] for p in parts]))
        s2.append(_finalize([p[1] for p in parts]))
    return np.stack(s1), np.stack(s2)


def _reflect_rows_cols(h, w, c4):
    """Per channel, the source of ring row -1 / H and ring column -1 / W
    (ops/folded.py): rows by the channel half, columns by the sub-column
    block."""
    ch = np.arange(c4)
    first = ch < c4 // 2
    sub0 = (ch // (c4 // 4)) % 2 == 0

    def row(r):
        if r < 0:
            return np.where(first, 1, 0)
        if r >= h:
            return np.where(first, h - 1, h - 2)
        return np.full(c4, r)

    def col(c):
        if c < 0:
            return np.where(sub0, 1, 0)
        if c >= w:
            return np.where(sub0, w - 1, w - 2)
        return np.full(c4, c)
    return row, col


def _ring_pos(rb, m):
    """Position of row m of layer 1's ring block rb (folded_conv2_q8.cu
    `ring_pos`), relative to the tile's first pixel; None for block 3's
    unused rows."""
    if rb < 2:
        return (-1 if rb == 0 else TH, m - 1)
    if rb == 2:
        return (m & 7, -1 if m < 8 else TW)
    return ((TH if m & 2 else -1), TW - 1 + (m & 1)) if m < 4 else None


def _b7_split(x, k1, sc1, k2, sc2):
    """B7 tile by tile: y1 (int8), layer 1's post-activation values on the
    image (from each tile's interior) and layer 2's sums (int64)."""
    n, h, w, c4 = x.shape
    c4m, c4o = k1.shape[3], k2.shape[3]
    row, col = _reflect_rows_cols(h, w, c4)
    row_m, col_m = _reflect_rows_cols(h, w, c4m)
    chans, chans_m = np.arange(c4), np.arange(c4m)
    # the listed blocks only (a skipped block is a zero block)
    lists = [np.repeat(np.repeat(block_table(_t(k)).numpy().astype(bool),
                                 k.shape[2] // 4, 2), k.shape[3] // 4, 3)
             for k in (k1, k2)]
    w1 = np.where(lists[0], k1, 0).astype(np.int64)
    w2 = np.where(lists[1], k2, 0).astype(np.int64)
    y1 = np.zeros((n, h, w, c4m), np.int8)
    v1 = np.zeros((n, h, w, c4m), np.float32)
    acc2 = np.zeros((n, h, w, c4o), np.int64)
    interior = [(pr, pc) for pr in range(TH) for pc in range(TW)]
    ring = [p for rb in range(4) for m in range(16)
            if (p := _ring_pos(rb, m)) is not None]
    assert len(ring) == 2 * (TW + 2) + 2 * TH  # two rows of 18, columns of 8
    for b in range(n):
        for r0, c0 in _tiles(h, w):
            # x staged with a 2-pixel border: the reflect ring, zeros beyond
            xs = np.zeros((TH + 4, TW + 4, c4), np.int64)
            for i in range(TH + 4):
                for j in range(TW + 4):
                    r, c = r0 - 2 + i, c0 - 2 + j
                    if -1 <= r <= h and -1 <= c <= w:
                        xs[i, j] = x[b, row(r), col(c), chans]
            region = np.zeros((TH + 2, TW + 2, c4m), np.int8)

            def layer1(pos):
                acc = np.zeros((len(pos), c4m), np.int64)
                for dr in range(3):
                    for dc in range(3):
                        a = np.stack([xs[pr + 1 + dr, pc + 1 + dc]
                                      for pr, pc in pos])
                        acc += a @ w1[dr, dc]
                return _epilogue(acc, sc1)

            for pos in (interior, ring):
                for (pr, pc), v in zip(pos, layer1(pos)):
                    r, c = r0 + pr, c0 + pc
                    if 0 <= r < h and 0 <= c < w:
                        region[pr + 1, pc + 1] = _requant(v, sc1[2])
                        if 0 <= pr < TH and 0 <= pc < TW:  # the interior
                            y1[b, r, c] = region[pr + 1, pc + 1]
                            v1[b, r, c] = v
            # y1's reflect ring from the computed in-image positions
            for i in range(TH + 2):
                for j in range(TW + 2):
                    r, c = r0 - 1 + i, c0 - 1 + j
                    if (r in (-1, h) or c in (-1, w)) and -1 <= r <= h \
                            and -1 <= c <= w:
                        region[i, j] = region[row_m(r) - r0 + 1,
                                              col_m(c) - c0 + 1, chans_m]
            # layer 2 on the tile from the region
            for pr, pc in interior:
                r, c = r0 + pr, c0 + pc
                if r < h and c < w:
                    acc2[b, r, c] = sum(
                        region[pr + dr, pc + dc].astype(np.int64)
                        @ w2[dr, dc] for dr in range(3) for dc in range(3))
    return y1, v1, acc2


# ---------------------------------------------------------------- the table

@pytest.mark.parametrize("impl", ["port", "rpst"])
def test_quantized_fold_lists_36_blocks(impl):
    """round(0 / s) = 0: quantizing a folded kernel keeps its zero blocks,
    so the launch's table lists the unfolded conv's 36 of 144 blocks (9
    per output block), exactly those of ``listed_blocks``; the port's and
    rpst's quantizers give the same int8 kernel."""
    rng = np.random.default_rng(11)
    k = rng.standard_normal((3, 3, 32, 32)).astype(np.float32) * 0.1
    port = quantize_weights(fold_conv_kernel(_t(k)))[0].numpy()
    ref = np.asarray(j_quantize_w(j_fold_conv_kernel(jnp.asarray(k)))[0])
    np.testing.assert_array_equal(port, ref)
    q = port if impl == "port" else ref
    table = block_table(_t(q)).numpy()
    assert int(table.sum()) == 36
    assert table.sum(axis=(0, 1, 2)).tolist() == [9, 9, 9, 9]
    np.testing.assert_array_equal(table.astype(bool),
                                  listed_blocks().numpy())
    assert np.count_nonzero(q) > 0.9 * 36 * 32 * 32  # the 36 blocks' values


# ---------------------------------------------------------------- B4

@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("out_int8", [True, False])
def test_b4_walk_matches_plain_and_pallas(rng, dense, out_int8):
    """The path's width, 4C = 4Co = 128 (one K step is one input block), at
    a small size: int8 / bf16 bit-equal to the plain version and rpst's
    kernel, the stats in the written order within rpst's gate of both."""
    x, k, sc = _layer(rng, 2, 8, 8, 128, 128, dense)
    acc, taps = _walk(x, k)
    y = _epilogue(acc, sc)
    got = _out(y, sc, out_int8)
    plain = fused_folded_conv_q8_plain(_t(x), _t(k), _t(sc), out_int8, True)
    ref = j_conv_q8(jnp.asarray(x), jnp.asarray(k), jnp.asarray(sc),
                    out_int8=out_int8, with_stats=True, block_rows=4,
                    interpret=True)
    if out_int8:
        assert torch.equal(got, plain[0])
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref[0]))
    else:
        assert torch.equal(got.view(torch.int16), plain[0].view(torch.int16))
        # rpst's interpret mode on the CPU fuses acc * deq + bias (one
        # rounding, not the kernel's two): a value at a bfloat16 rounding
        # boundary then lands one ulp apart, so rpst is held to one ulp
        jref = _t(np.asarray(ref[0]).astype(np.float32)).to(torch.bfloat16)
        assert _bf16_ulps(got, jref) <= 1
    s1, s2 = _b4_stats(y)
    for r1, r2 in ((plain[1], plain[2]), (ref[1], ref[2])):
        np.testing.assert_allclose(s1, np.asarray(r1), **STATS_TOL)
        np.testing.assert_allclose(s2, np.asarray(r2), **STATS_TOL)
    # per tile and K step, the step's block's listed (tap, output block)
    # pairs x 4 n-tiles of an output block: 2 images x 1 tile x 4 steps
    assert taps == 2 * 4 * (144 if dense else 36)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape", [
    (3, 10, 33, 16, 4),    # N = 3, W = 33, 4C = 16 (a step spans the 4
                           # blocks), 4Co = 4 (the narrow tiling)
    (1, 2, 37, 16, 132),   # H = 2, W = 37, 4Co = 132 (contiguous channels,
                           # two channel tiles)
    (2, 9, 17, 48, 64),    # 4C = 48 (steps across blocks), blocked 4Co = 64
    (1, 3, 5, 128, 12),    # 4Co = 12: Co = 3, narrow
])
def test_b4_walk_matches_plain_at_the_edges(rng, shape, dense):
    """Ragged tiles, the union mask at 4C = 16 and 48 and the tilings of
    4Co, both outputs bit-equal to the plain version, the stats in the
    written order within rpst's gate."""
    x, k, sc = _layer(rng, *shape, dense)
    acc, _ = _walk(x, k)
    y = _epilogue(acc, sc)
    for out_int8 in (True, False):
        plain = fused_folded_conv_q8_plain(_t(x), _t(k), _t(sc), out_int8,
                                           True)
        got = _out(y, sc, out_int8)
        if out_int8:
            assert torch.equal(got, plain[0])
        else:
            assert torch.equal(got.view(torch.int16),
                               plain[0].view(torch.int16))
    s1, s2 = _b4_stats(y)
    np.testing.assert_allclose(s1, plain[1].numpy(), **STATS_TOL)
    np.testing.assert_allclose(s2, plain[2].numpy(), **STATS_TOL)


# ---------------------------------------------------------------- B7

B7_SHAPES = [
    (1, 9, 18, 128, 128, 128),  # the path's widths, ragged tiles
    (2, 2, 2, 16, 32, 4),       # the smallest image; narrow layer 2
    (1, 10, 33, 16, 16, 12),    # narrow layers, W = 33
]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape", B7_SHAPES)
def test_b7_split_matches_two_b4(rng, shape, dense):
    """Layer 1 on the interior plus its halo ring, y1's ring filled by the
    reflect rule, layer 2 from the region: y1 and y2 (both outputs) equal
    to two plain B4 launches, and layer 1's interior values are B4's."""
    n, h, w, c4, c4m, c4o = shape
    x, k1, sc1 = _layer(rng, n, h, w, c4, c4m, dense)
    _, k2, sc2 = _layer(rng, n, h, w, c4m, c4o, dense, 0.02)
    y1, v1, acc2 = _b7_split(x, k1, sc1, k2, sc2)
    y2 = _epilogue(acc2, sc2)
    for out_int8 in (True, False):
        ref = fused_folded_conv2_q8_plain(_t(x), _t(k1), _t(sc1), _t(k2),
                                          _t(sc2), out_int8, True)
        assert torch.equal(_t(y1), ref[0])
        got = _out(y2, sc2, out_int8)
        assert torch.equal(got.view(torch.int8) if out_int8
                           else got.view(torch.int16),
                           ref[1].view(torch.int8) if out_int8
                           else ref[1].view(torch.int16))
    np.testing.assert_array_equal(v1, _epilogue(_walk(x, k1)[0], sc1))


@pytest.mark.parametrize("shape", B7_SHAPES)
def test_b7_layer1_sums_bit_equal_to_b4(rng, shape):
    """The written stats order on B7's split (each tile's interior) and on
    a B4 launch's walk gives bit-equal float32 sums, as phase 13's
    fuse_pairs equality needs; both within rpst's gate of plain."""
    n, h, w, c4, c4m, c4o = shape
    x, k1, sc1 = _layer(rng, n, h, w, c4, c4m, False)
    _, k2, sc2 = _layer(rng, n, h, w, c4m, c4o, False, 0.02)
    _, v1, acc2 = _b7_split(x, k1, sc1, k2, sc2)
    pair = _b4_stats(v1)
    launch = _b4_stats(_epilogue(_walk(x, k1)[0], sc1))
    for a, b in zip(pair, launch):
        np.testing.assert_array_equal(a, b)
    ref = fused_folded_conv2_q8_plain(_t(x), _t(k1), _t(sc1), _t(k2),
                                      _t(sc2), True, True)
    np.testing.assert_allclose(pair[0], ref[2].numpy(), **STATS_TOL)
    np.testing.assert_allclose(pair[1], ref[3].numpy(), **STATS_TOL)
    s21, s22 = _b4_stats(_epilogue(acc2, sc2))
    np.testing.assert_allclose(s21, ref[4].numpy(), **STATS_TOL)
    np.testing.assert_allclose(s22, ref[5].numpy(), **STATS_TOL)
