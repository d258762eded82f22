"""B3 on the tensor cores (csrc/folded_conv_bwd.cu), checked on the CPU.

The kernel runs only on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py phase 2). Here:
  * its work list (``b3_items``): per tap a dense sub-GEMM over the listed
    input and output blocks, cut into tiles sized to it;
  * a numpy emulation of the kernel's walk, item by item and segment by
    segment as the CUDA code takes them: chunks of positions whose source
    pixels are resolved per input block (the reflect ring rows and columns
    by their channel rules), the gathered staging of x and gz, the chunk's
    K steps split among groups of warps, the groups added in order, the
    segments' partial tiles summed in order; held against the plain
    version and rpst's Pallas kernel in interpret mode, dense and listed;
  * the listed mode: the plain version's blocks, and the unfolded kernel's
    gradient through ``fold_conv_kernel`` against ``jax.grad`` of rpst's;
  * the float32 arithmetic: three TF32 products with a fresh chain per
    chunk hold phase 2's limit at 65536 positions, one product does not.
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
    fused_folded_conv_grad_weight as j_grad_weight
from rpst_torch.ops.folded import fold_bias, fold_conv_kernel
from test_torch_flash_attention import _tf32_product

# the emulation against the plain version in float64 (the same sums in
# another order), and against rpst's float32 kernel (sums of up to 512
# products of N(0, 1) values)
TOL64 = dict(rtol=1e-10, atol=1e-10)
TOL32 = dict(rtol=1e-5, atol=1e-4)
# phase 2's B3 limit: rtol 1e-4, atol 2e-3 * sqrt(L / 512) for L positions
DK_RTOL, DK_ATOL_512 = 1e-4, 2e-3
WARPS, STEPS = 8, 8  # warps a block, mma K steps a chunk


def _blocks(packed):
    return [(packed >> (4 + 4 * j)) & 15 for j in range(packed & 15)]


def _item(row, c, co):
    tap, m0, n0, wtm, wtn, inb, outb, sums_db = (int(v) for v in row)
    s_in, s_out = _blocks(inb), _blocks(outb)
    return dict(tap=tap, m0=m0, n0=n0, tm=32 * wtm, tn=32 * wtn,
                nwt=wtm * wtn, s_in=s_in, s_out=s_out, mg=len(s_in) * c,
                ng=len(s_out) * co, db=bool(sums_db))


def _gathered(blocks, cb, v):
    """Channels of gathered indices v (-1 past the axis)."""
    v = np.asarray(v)
    j = v // cb
    ok = j < len(blocks)
    blk = np.asarray(blocks + [0])[np.where(ok, j, len(blocks))]
    return np.where(ok, blk * cb + v % cb, -1)


def _sources(p, n_pos, h, w, dr, dc):
    """(len(p), 4) source pixels of the tap's window for each position and
    input block: ring rows by the channel half (block // 2), ring columns
    by the block parity (block % 2); -1 past the positions."""
    out = np.full((len(p), 4), -1)
    ok = p < n_pos
    n, rem = np.divmod(np.where(ok, p, 0), h * w)
    r, c = np.divmod(rem, w)
    for s in range(4):
        rg, cg = r + dr - 1, c + dc - 1
        rg = np.where(rg < 0, 1 if s // 2 == 0 else 0, rg)
        rg = np.where(rg == h, h - 1 if s // 2 == 0 else h - 2, rg)
        cg = np.where(cg < 0, 1 if s % 2 == 0 else 0, cg)
        cg = np.where(cg == w, w - 1 if s % 2 == 0 else w - 2, cg)
        out[:, s] = np.where(ok, (n * h + rg) * w + cg, -1)
    return out


def _emulate(x, gz, listed, chunk, seg_len=None):
    """B3's walk in float64: (dk, db, stats). ``chunk`` is the positions of
    a chunk (64 float32, 128 bfloat16), ``seg_len`` a segment's (the
    wrapper's ``b3_segment`` by default)."""
    n_, h, w, c4 = x.shape
    c4o = gz.shape[3]
    c, co = c4 // 4, c4o // 4
    p_all = n_ * h * w
    xf = x.reshape(p_all, c4).astype(np.float64)
    gf = gz.reshape(p_all, c4o).astype(np.float64)
    items = [_item(r, c, co) for r in fc.b3_items(c4, c4o, listed)]
    seg_len = seg_len or fc.b3_segment(p_all, len(items), chunk)
    assert seg_len % chunk == 0
    segments = -(-p_all // seg_len)
    kstep = chunk // STEPS
    part = np.zeros((segments, len(items), fc.B3_TILE))
    db_part = np.zeros((segments, c4o))
    macs = 0
    for s in range(segments):
        p0, p1 = s * seg_len, min(s * seg_len + seg_len, p_all)
        for ii, it in enumerate(items):
            if it["db"]:  # gz's columns alone
                cols = it["n0"] + np.arange(min(it["tn"], c4o - it["n0"]))
                db_part[s, cols] = gf[p0:p1, cols].sum(axis=0)
                continue
            dr, dc = divmod(it["tap"], 3)
            tm, tn, nwt = it["tm"], it["tn"], it["nwt"]
            groups = WARPS // nwt
            m_ch = _gathered(it["s_in"], c, it["m0"] + np.arange(tm))
            m_blk = np.where(m_ch >= 0, m_ch // c, 0)
            n_ch = _gathered(it["s_out"], co, it["n0"] + np.arange(tn))
            acc = np.zeros((groups, tm, tn))
            for pb in range(p0, p1, chunk):
                p = pb + np.arange(chunk)
                src = _sources(np.where(p < p1, p, p_all), p_all, h, w, dr,
                               dc)
                pix = src[:, m_blk]  # (chunk, tm)
                xs = np.where((pix >= 0) & (m_ch >= 0),
                              xf[np.maximum(pix, 0), np.maximum(m_ch, 0)],
                              0.0)
                live = (p < p1)[:, None] & (n_ch >= 0)[None, :]
                gs = np.where(live, gf[np.minimum(p, p_all - 1)][
                    :, np.maximum(n_ch, 0)], 0.0)
                for kp in range(groups):  # the K steps of group kp
                    sl = np.concatenate([np.arange(ks * kstep,
                                                   ks * kstep + kstep)
                                         for ks in range(kp, STEPS, groups)])
                    acc[kp] += xs[sl].T @ gs[sl]
                macs += chunk * tm * tn
            tile = acc[0]
            for kp in range(1, groups):
                tile = tile + acc[kp]
            part[s, ii, :tm * tn] = tile.reshape(-1)
    dk = np.zeros((9, c4, c4o))
    for ii, it in enumerate(items):
        if it["db"]:
            continue
        tile = part[:, ii, :it["tm"] * it["tn"]].sum(axis=0).reshape(
            it["tm"], it["tn"])
        rows = _gathered(it["s_in"], c, it["m0"] + np.arange(it["tm"]))
        cols = _gathered(it["s_out"], co, it["n0"] + np.arange(it["tn"]))
        dk[it["tap"]][np.ix_(rows[rows >= 0], cols[cols >= 0])] = \
            tile[np.ix_(rows >= 0, cols >= 0)]
    stats = dict(items=len(items), segments=segments, macs=macs)
    return dk.reshape(3, 3, c4, c4o), db_part.sum(axis=0), stats


def _listed_mask(c4, c4o):
    m = fc.listed_blocks().numpy()
    return np.repeat(np.repeat(m, c4 // 4, axis=2), c4o // 4, axis=3)


def _xg(rng, n, h, w, c, co):
    return (rng.standard_normal((n, h, w, 4 * c)).astype(np.float32),
            rng.standard_normal((n, h, w, 4 * co)).astype(np.float32))


# ---------------------------------------------------------------- the list

def test_listed_blocks_are_the_fold_placement_and_a_product_per_tap():
    table = fc.listed_blocks().numpy()
    assert table.shape == (3, 3, 4, 4) and int(table.sum()) == 36
    sizes = []
    for tap in range(9):
        t = table[tap // 3, tap % 3]
        s_in, s_out = np.flatnonzero(t.any(1)), np.flatnonzero(t.any(0))
        assert t[np.ix_(s_in, s_out)].all()
        sizes.append((len(s_in), len(s_out)))
    # the centre 4 x 4, the edges 2 x 2 (top / bottom contiguous, left /
    # right strided), the corners 1 x 1
    assert sizes == [(1, 1), (2, 2), (1, 1), (2, 2), (4, 4), (2, 2), (1, 1),
                     (2, 2), (1, 1)]
    assert _blocks(fc.b3_items(128, 128, True)[1][5]) == [2, 3]
    assert _blocks(fc.b3_items(128, 128, True)[3][5]) == [1, 3]


@pytest.mark.parametrize("c4,c4o,listed,n_items", [
    (128, 128, True, 11), (128, 128, False, 19), (512, 512, True, 76),
    (512, 512, False, 292), (12, 128, True, 10), (128, 12, False, 10)])
def test_items_cover_the_blocks_once_and_fill_their_tiles(c4, c4o, listed,
                                                          n_items):
    """Every (tap, i, o) entry of the listed (or all) blocks lies in
    exactly one item's tile, no other entry in any; at the hidden widths
    (4C = 128, 512) the tiles hold no padding, and every item's warp
    tiles and K groups make 8 warps; db's items cover each output channel
    once."""
    c, co = c4 // 4, c4o // 4
    items = [_item(r, c, co) for r in fc.b3_items(c4, c4o, listed)]
    assert len(items) == n_items
    cover = np.zeros((9, c4, c4o), int)
    area = 0
    db_cols = []
    for it in items:
        if it["db"]:  # db's items: no input block, the output channels
            assert it["mg"] == 0 and it["s_out"] == [0, 1, 2, 3]
            db_cols += range(it["n0"], min(it["n0"] + it["tn"], c4o))
            continue
        assert it["tm"] + it["tn"] <= 192 and it["tm"] * it["tn"] <= 8192
        assert WARPS % it["nwt"] == 0
        rows = _gathered(it["s_in"], c, it["m0"] + np.arange(it["tm"]))
        cols = _gathered(it["s_out"], co, it["n0"] + np.arange(it["tn"]))
        cover[it["tap"]][np.ix_(rows[rows >= 0], cols[cols >= 0])] += 1
        area += it["tm"] * it["tn"]
    want = (_listed_mask(c4, c4o) if listed
            else np.ones((3, 3, c4, c4o), bool)).reshape(9, c4, c4o)
    np.testing.assert_array_equal(cover, want.astype(int))
    if c4 % 128 == 0 and c4o % 128 == 0:
        assert area == want.sum()
    assert db_cols == list(range(c4o))


def test_segments_fill_the_card_at_the_path_shapes():
    """At (1, 256, 256) the listed 128 -> 128 items and segments make at
    least three blocks per SM of 132 (the kernel runs two at a time), in
    whole chunks."""
    for chunk in (64, 128):
        items = len(fc.b3_items(128, 128, True))
        seg = fc.b3_segment(256 * 256, items, chunk)
        assert seg % chunk == 0
        assert items * -(-256 * 256 // seg) >= 3 * 132


# ---------------------------------------------------------------- emulation

@pytest.mark.parametrize("listed", [False, True])
def test_emulation_matches_plain_and_pallas(rng, listed):
    """C4 = 128 at (2, 16, 16): two segments of 256 positions; rpst's
    interpret-mode kernel is dense, so the listed mode is held to its
    listed blocks and to zeros elsewhere."""
    x, gz = _xg(rng, 2, 16, 16, 32, 32)
    dk, db, st = _emulate(x, gz, listed, 64)
    assert st["segments"] == 2
    rdk, rdb = j_grad_weight(jnp.asarray(x), jnp.asarray(gz), interpret=True)
    rdk = np.asarray(rdk)
    if listed:
        rdk = np.where(_listed_mask(128, 128), rdk, 0.0)
        # the listed blocks' MACs: 36 C x C blocks of 32 x 32, no padding
        assert st["macs"] == 512 * 36 * 32 * 32
    pdk, pdb = fc.fused_folded_conv_grad_weight_plain(
        *(torch.from_numpy(a.astype(np.float64)) for a in (x, gz)), listed)
    np.testing.assert_allclose(dk, pdk.numpy(), **TOL64)
    np.testing.assert_allclose(db, pdb.numpy(), **TOL64)
    np.testing.assert_allclose(dk, rdk, **TOL32)
    np.testing.assert_allclose(db, np.asarray(rdb), **TOL32)


@pytest.mark.parametrize("listed", [False, True])
@pytest.mark.parametrize("shape,chunk,seg_len", [
    ((2, 38, 22, 32, 32), 64, None),   # ragged batch, segments across images
    ((1, 5, 7, 3, 32), 64, 64),        # 12 -> 128: three-channel blocks
    ((1, 4, 6, 32, 3), 128, 128),      # 128 -> 12
    ((2, 2, 2, 3, 3), 64, 64),         # the smallest image, 12 -> 12
    ((1, 4, 4, 64, 128), 128, None),   # 256 -> 512: 16 tiles a tap
    ((1, 9, 17, 32, 32), 128, 128),    # bf16 chunks, two segments
])
def test_emulation_matches_plain_at_the_edges(rng, shape, chunk, seg_len,
                                              listed):
    n, h, w, c, co = shape
    x, gz = _xg(rng, n, h, w, c, co)
    dk, db, _ = _emulate(x, gz, listed, chunk, seg_len)
    pdk, pdb = fc.fused_folded_conv_grad_weight_plain(
        *(torch.from_numpy(a.astype(np.float64)) for a in (x, gz)), listed)
    np.testing.assert_allclose(dk, pdk.numpy(), **TOL64)
    np.testing.assert_allclose(db, pdb.numpy(), **TOL64)


# ---------------------------------------------------------------- listed mode

@pytest.mark.parametrize("c,co", [(8, 8), (3, 16), (16, 3)])
def test_listed_plain_is_dense_on_the_listed_blocks_and_zero_elsewhere(
        rng, c, co):
    x, gz = (torch.from_numpy(a) for a in _xg(rng, 2, 5, 6, c, co))
    dense, db = fc.fused_folded_conv_grad_weight_plain(x, gz)
    listed, db_l = fc.fused_folded_conv_grad_weight_plain(x, gz, True)
    mask = torch.from_numpy(_listed_mask(4 * c, 4 * co))
    assert torch.equal(listed[mask], dense[mask])
    assert not listed[~mask].any() and dense[~mask].abs().min() > 0
    assert torch.equal(db, db_l)
    # the CPU wrapper takes the same plain version in both modes
    assert torch.equal(fc.fused_folded_conv_grad_weight(x, gz, True)[0],
                       listed)


@pytest.mark.parametrize("alpha", [0.2, 0.0])
@pytest.mark.parametrize("n,h,w,c,co", [(2, 6, 8, 8, 8), (1, 5, 3, 3, 16),
                                        (1, 4, 6, 16, 3)])
def test_listed_unfolded_gradient_matches_jax_grad(rng, n, h, w, c, co,
                                                   alpha):
    """The image kernel's and bias's gradients through fold_conv_kernel +
    FoldedConvAct with ``listed`` against jax.grad through rpst's
    fold_conv_kernel + folded conv + activation (its XLA ring path: the
    Pallas VJP of ``folded_conv_act`` has no CPU mode), at the training
    parity limits of tests/test_folded.py:133-138; and equal to the dense
    mode's. x's gradient too, which ``listed`` does not touch."""
    x = rng.standard_normal((n, h, w, 4 * c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    g = rng.standard_normal((n, h, w, 4 * co)).astype(np.float32)

    def f(x, k, b):
        y = j_folded_conv(x, j_fold_conv_kernel(k), j_fold_bias(b))
        return jnp.sum(jnp.where(y >= 0, y, alpha * y) * g)

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, k, b)))

    def grads(listed):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
        y = fc.folded_conv_act(leaves[0], fold_conv_kernel(leaves[1]),
                               fold_bias(leaves[2]), alpha, listed=listed)
        return torch.autograd.grad((y * torch.from_numpy(g)).sum(), leaves)

    got, dense = grads(True), grads(False)
    for name, a, d, r in zip(("dx", "dk", "db"), got, dense, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=5e-3,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)
        torch.testing.assert_close(a, d, rtol=1e-6, atol=1e-6, msg=name)


def test_dense_kernel_call_gets_the_dense_gradient(rng):
    """A FoldedConvAct call that does not say ``listed`` (a free folded
    kernel, dense here) gets all 144 blocks, whatever the kernel's zeros:
    its unlisted blocks' gradients are not zero."""
    x, g = (torch.from_numpy(a) for a in _xg(rng, 1, 4, 6, 4, 4))
    kf = fold_conv_kernel(torch.randn(3, 3, 4, 4)).requires_grad_()
    bf = torch.zeros(16, requires_grad=True)
    y = fc.FoldedConvAct.apply(x, kf, bf, 0.2)
    dk, = torch.autograd.grad((y * g).sum(), [kf])
    gz = torch.where(y > 0, g, 0.2 * g)
    ref, _ = fc.fused_folded_conv_grad_weight_plain(x, gz.detach())
    torch.testing.assert_close(dk, ref, rtol=0, atol=0)
    mask = torch.from_numpy(_listed_mask(16, 16))
    assert dk[~mask].abs().min() > 0


# ---------------------------------------------------------------- float32

def test_three_tf32_products_fresh_per_chunk_hold_phase2_at_65536():
    """The float32 kernel's arithmetic at L = 65536 positions, (1, 256,
    256): three TF32 products a fragment, a fresh chain per chunk of 64
    positions added in float32, four segments added in order, against
    float64 within phase 2's B3 limit (rtol 1e-4, atol 2e-3 sqrt(L /
    512)); one TF32 product misses it."""
    rng = np.random.default_rng(5)
    n_pos = 65536
    a = rng.standard_normal((32, n_pos)).astype(np.float32)  # window^T
    b = rng.standard_normal((n_pos, 32)).astype(np.float32)  # gz
    ref = a.astype(np.float64) @ b.astype(np.float64)
    atol = DK_ATOL_512 * (n_pos / 512) ** 0.5
    three = _tf32_product(a, b, 3, 64, parts=4)
    one = _tf32_product(a, b, 1, 64, parts=4)
    assert np.all(np.abs(three - ref) <= atol + DK_RTOL * np.abs(ref))
    assert not np.all(np.abs(one - ref) <= atol + DK_RTOL * np.abs(ref))
