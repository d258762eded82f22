"""B1, B2, B3: the fused folded conv and its backward pair, with autograd.

Ports of ``rpst.ops.pallas.folded_conv``:
  * B1 ``fused_folded_conv``: reflect-ring pad + 3x3 folded conv + bias +
    leaky ReLU, forward (CUDA ``csrc/folded_conv.cu``);
  * B2 ``fused_folded_conv_grad_input``: dx from gz and the rotated,
    transposed kernel, ring adjoint included (CUDA ``csrc/folded_conv_bwd.cu``);
  * B3 ``fused_folded_conv_grad_weight``: dk and db, the folded correlation
    (same source);
  * ``FoldedConvAct``, the counterpart of rpst's custom VJP
    ``folded_conv_act``: forward B1, backward B2 + B3;
  * the halo modes of a row shard (rpst ``folded_conv_act_halo`` :604, the
    trainable core of row-sharded training): B2 with ``row_rings=False``
    (the ring rows' adjoint left out), B3 with the given ``rings``,
    ``fused_folded_conv_ring_grads`` (the gradient of the two given rows,
    plain PyTorch as rpst leaves it to XLA) and ``FoldedConvActHalo``, its
    custom VJP over (x, k, b, above, below).

Each wrapper takes a CUDA tensor to its hand-written kernel or raises; a
CPU tensor takes its ``*_plain`` version, the same function in plain
PyTorch, which the CPU tests hold against rpst. ``<wrapper>.launches``
counts the wrapper's kernel launches and nothing else.

B1 and B2 run on the tensor cores and take only the non-zero blocks of the
folded kernel: each launch packs the kernel K-major (``pack_k_major``'s
layout) and lists its non-zero (tap, input block, output block) blocks
(``block_table``'s table) on the device, in scratch the wrapper allocates,
with no host sync. A kernel from ``fold_conv_kernel`` lists 36 of the 144
blocks, so B1 and B2 do the MACs of the unfolded conv; any other kernel
gives the same function, at the cost of the blocks it lists.

B3 runs on the tensor cores too, as per-tap GEMMs reduced over positions
(``b3_items`` lists its tiles). Which blocks it computes cannot come from
the kernel's values: the gradient of a zero block is not zero. So it is
dense (rpst's function, all 144 blocks) unless the caller says that the
folded kernel is ``fold_conv_kernel``'s output (``listed``, passed by the
live training fold through ``FoldedConvAct``): then it computes the 36
blocks the fold's backward reads and writes zeros in the others.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .folded import (_fold_placement, conv_nhwc, folded_conv,
                     folded_reflect_pad)

_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}
_launch_lock = threading.Lock()
# B3: the blocks to aim for (4 per SM of an H100's 132) when cutting the
# reduction into segments
_B3_TARGET_BLOCKS = 4 * 132


def _count(wrapper, mode: str = "") -> None:
    """One launch of ``wrapper`` (and of its ``mode``, counted again as
    ``launches_<mode>``)."""
    with _launch_lock:
        wrapper.launches += 1
        if mode:
            name = f"launches_{mode}"
            setattr(wrapper, name, getattr(wrapper, name) + 1)


def _check_common(name, tensors, dtype, device):
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {device}")
    # float64 only on the CPU, where the plain versions run (gradcheck)
    if dtype not in _ENTRY and not (dtype == torch.float64
                                    and device.type == "cpu"):
        raise TypeError(f"{name} takes float32/bfloat16 (and float64 on the "
                        f"CPU), got {dtype} on {device}")
    for tname, t in tensors:
        if t.device != device:
            raise ValueError(f"{tname} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{tname} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")


def _acc(t):
    """``t`` in the plain versions' accumulation type: float32, or float64
    for float64 input."""
    return t if t.dtype == torch.float64 else t.float()


def block_table(k):
    """(3, 3, 4, 4) uint8 of a (3, 3, 4C, 4Co) kernel: 1 where the C x Co
    block of (tap, input sub-position block, output sub-position block)
    holds a non-zero (NaN included), the blocks B1 and B2 take (their
    launches build the same table on the card, as bits)."""
    c4, c4o = k.shape[2], k.shape[3]
    nz = k.reshape(3, 3, 4, c4 // 4, 4, c4o // 4).ne(0)
    return nz.any(dim=5).any(dim=3).to(torch.uint8)


def pack_k_major(w):
    """HWIO (K, K, C, Co) weights in the order of the tensor-core kernels'
    ``mma`` (B1 / B2 here, B5 and its 7x7 form in ``ops.conv2d_q8``): (K, K,
    ceil(C / KE), Co, KE) contiguous, KE input channels = 32 bytes (one
    k-step: 8 float32, 16 bfloat16, 32 int8), zeros past C. ``packed[dr, dc,
    s, co, e] = w[dr, dc, s * KE + e, co]``."""
    ke = 32 // w.element_size()
    k, c, co = w.shape[0], w.shape[2], w.shape[3]
    steps = -(-c // ke)
    padded = F.pad(w, (0, 0, 0, steps * ke - c))
    return padded.reshape(k, k, steps, ke, co).permute(0, 1, 2, 4, 3) \
        .contiguous()


def _scratch(k):
    """The launch's scratch for ``k`` (3, 3, Cin, Cout): its K-major copy
    (``pack_k_major``'s size) and its block table as 9 words of bits."""
    ke = 32 // k.element_size()
    packed = torch.empty(9 * -(-k.shape[2] // ke) * k.shape[3] * ke,
                         dtype=k.dtype, device=k.device)
    return packed, torch.empty(9, dtype=torch.int32, device=k.device)


def _launch(lib_fn, what, *args):
    from ..kernels.build import launch
    launch("folded_conv" if what == "B1" else "folded_conv_bwd", lib_fn, what,
           *args)


# ---------------------------------------------------------------- B1

def fused_folded_conv_plain(x_f, folded_kernel, folded_bias, alpha=0.2,
                            rings=None):
    """lrelu_alpha(folded_conv(x_f) + bias) in plain PyTorch, with the same
    ``rings`` override as the kernel."""
    y = folded_conv(x_f, folded_kernel, folded_bias, rings)
    return torch.where(y >= 0, y, alpha * y)


def _check(x_f, k, b, rings):
    if k.ndim != 4 or b.ndim != 1:
        raise ValueError(f"expected x (N,H,W,4C), k (3,3,4C,4Co), b (4Co,); "
                         f"got {tuple(x_f.shape)}, {tuple(k.shape)}, "
                         f"{tuple(b.shape)}")
    n, _, w, c4 = x_f.shape
    c4o = k.shape[3]
    if tuple(k.shape[:3]) != (3, 3, c4) or tuple(b.shape) != (c4o,):
        raise ValueError(f"kernel {tuple(k.shape)} / bias {tuple(b.shape)} "
                         f"do not match x {tuple(x_f.shape)}")
    if c4 % 4 or c4o % 4:
        raise ValueError(f"need 4C, 4Co multiples of 4; got x "
                         f"{tuple(x_f.shape)}, k {tuple(k.shape)}")
    if rings is not None and tuple(rings.shape) != (n, 2, w, c4):
        raise ValueError(f"rings must be {(n, 2, w, c4)}, got "
                         f"{tuple(rings.shape)}")
    tensors = (("x_f", x_f), ("kernel", k), ("bias", b))
    if rings is not None:
        tensors += (("rings", rings),)
    _check_common("fused_folded_conv", tensors, x_f.dtype, x_f.device)


def _check_x(name, x_f):
    if x_f.ndim != 4 or x_f.shape[1] < 2 or x_f.shape[2] < 2:
        raise ValueError(f"{name}: expected (N, Hf, Wf, 4C) with Hf, Wf >= 2, "
                         f"got {tuple(x_f.shape)}")


def fused_folded_conv(x_f, folded_kernel, folded_bias, alpha=0.2,
                      rings=None):
    """lrelu_alpha(folded_reflect_conv(x_f) + bias) for NHWC folded tensors.

    x_f (N, Hf, Wf, 4C) float32 or bfloat16, folded_kernel (3, 3, 4C, 4Co)
    and folded_bias (4Co,) of x_f's type, all contiguous on one device; the
    output has x_f's type. ``rings`` (N, 2, Wf, 4C) overrides the two
    virtual boundary rows (row 0 above x_f, row 1 below); by default they
    are the reflect ring. Both devices check the same contract.

    Under grad mode with an input that requires grad, the call goes through
    ``FoldedConvAct`` (backward B2 + B3), so no gradient is dropped; a
    ``rings`` override has no backward here, as rpst's ``fused_folded_conv``
    has none, and raises there: the differentiable form is
    ``folded_conv_act_halo``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x_f, folded_kernel, folded_bias, rings)):
        if rings is not None:
            raise NotImplementedError(
                "fused_folded_conv: a rings override has no gradient here "
                "(nor in rpst's fused_folded_conv); differentiate through "
                "folded_conv_act_halo (ops.folded_conv.FoldedConvActHalo), "
                "which takes the two rows as inputs")
        return FoldedConvAct.apply(x_f, folded_kernel, folded_bias, alpha)
    _check_x("fused_folded_conv", x_f)
    if rings is not None:  # else the kernel reads the reflect ring of x
        rings = rings.to(x_f.dtype)
    _check(x_f, folded_kernel, folded_bias, rings)
    if x_f.device.type == "cpu":
        return fused_folded_conv_plain(x_f, folded_kernel, folded_bias,
                                       alpha, rings)
    n, h, w, c4 = x_f.shape
    c4o = folded_kernel.shape[3]
    y = torch.empty((n, h, w, c4o), dtype=x_f.dtype, device=x_f.device)
    _launch(f"rpst_folded_conv_{_ENTRY[x_f.dtype]}", "B1", x_f, rings,
            folded_kernel, *_scratch(folded_kernel), folded_bias, y, n, h, w,
            c4, c4o, float(alpha))
    _count(fused_folded_conv)
    return y


fused_folded_conv.launches = 0


# ---------------------------------------------------------------- B2

def _block_masks(c4, device):
    """(sub-column-0, sub-row-0) masks over the 4C folded channels: channel
    g lies in block g // C; blocks {0, 2} are sub-column 0, {0, 1} sub-row
    0."""
    blk = torch.arange(c4, device=device) // (c4 // 4)
    return blk % 2 == 0, blk < 2


def fused_folded_conv_grad_input_plain(gz, khat, row_rings=True):
    """B2 in plain PyTorch: the gradient on the ring-padded grid is the FULL
    conv of gz with khat; its interior is the SAME-zero conv, and the ring
    values go back where ``folded_reflect_pad`` read them from: the ring
    columns (on every padded row) by the sub-column rule, then the ring
    rows by the sub-row rule, unless ``row_rings`` is False (a row shard:
    its ring rows came from elsewhere). Accumulates in float32; returns
    gz's type."""
    h, w = gz.shape[1], gz.shape[2]
    g = conv_nhwc(F.pad(_acc(gz), (0, 0, 2, 2, 2, 2)), _acc(khat))
    sj0, si0 = _block_masks(g.shape[-1], g.device)
    # ring columns -> interior columns, on all H + 2 padded rows
    left, right = g[:, :, 0], g[:, :, w + 1]
    g = g[:, :, 1:w + 1].clone()
    g[:, :, 1] += torch.where(sj0, left, 0.0)
    g[:, :, 0] += torch.where(sj0, 0.0, left)
    g[:, :, w - 1] += torch.where(sj0, right, 0.0)
    g[:, :, w - 2] += torch.where(sj0, 0.0, right)
    # ring rows -> interior rows
    top, bottom = g[:, 0], g[:, h + 1]
    g = g[:, 1:h + 1].clone()
    if not row_rings:
        return g.to(gz.dtype)
    g[:, 1] += torch.where(si0, top, 0.0)
    g[:, 0] += torch.where(si0, 0.0, top)
    g[:, h - 1] += torch.where(si0, bottom, 0.0)
    g[:, h - 2] += torch.where(si0, 0.0, bottom)
    return g.to(gz.dtype)


def fused_folded_conv_grad_input(gz, khat, row_rings=True):
    """dL/dx_f of the fused folded conv given gz = dL/d(pre-activation).

    gz (N, H, W, 4Co), khat (3, 3, 4Co, 4C) = ``kf.flip(0, 1).transpose(2,
    3)``, both of one type (float32/bfloat16), contiguous, on one device.
    Returns dx (N, H, W, 4C) of gz's type, the reflect-ring adjoint (rows
    and columns) included; ``row_rings=False`` (rpst's halo mode, a row
    shard) leaves out the ring rows' part, whose gradient
    ``fused_folded_conv_ring_grads`` gives. ``.launches_halo`` counts the
    launches of that mode."""
    _check_x("fused_folded_conv_grad_input", gz)
    if khat.ndim != 4 or tuple(khat.shape[:3]) != (3, 3, gz.shape[3]) \
            or khat.shape[3] % 4:
        raise ValueError(f"khat must be (3, 3, {gz.shape[3]}, 4C), got "
                         f"{tuple(khat.shape)}")
    _check_common("fused_folded_conv_grad_input",
                  (("gz", gz), ("khat", khat)), gz.dtype, gz.device)
    if gz.device.type == "cpu":
        return fused_folded_conv_grad_input_plain(gz, khat, row_rings)
    n, h, w, c4o = gz.shape
    c4 = khat.shape[3]
    dx = torch.empty((n, h, w, c4), dtype=gz.dtype, device=gz.device)
    mode = "" if row_rings else "halo"
    _launch(f"rpst_folded_conv_grad_input_{mode + '_' if mode else ''}"
            f"{_ENTRY[gz.dtype]}", "B2", gz, khat, *_scratch(khat), dx, n, h,
            w, c4o, c4)
    _count(fused_folded_conv_grad_input, mode)
    return dx


fused_folded_conv_grad_input.launches = 0
fused_folded_conv_grad_input.launches_halo = 0


def fused_folded_conv_ring_grads(gz, khat):
    """The gradients of the two virtual rows of a ``rings`` override
    (rpst ``fused_folded_conv_ring_grads`` :562, XLA there, so plain
    PyTorch here on every device): (d_above, d_below), each (N, 1, W, 4C)
    float32 (float64 for float64 input). The row above reaches output row
    0 through khat[2] (after the rotation), the row below output row H-1
    through khat[0], each with its own ring columns' corner terms scattered
    by the sub-column rule, as B2's ring rows. 2 rows x 3 products an
    image."""
    n, h, w, c4o = gz.shape
    sj0, _ = _block_masks(khat.shape[-1], gz.device)

    def ring_grad(g, kr):
        """g (N, W, 4Co), kr (3, 4Co, 4C) -> (N, 1, W, 4C)."""
        zero = torch.zeros_like(g[:, :1])
        mid = (torch.cat([zero, g[:, :w - 1]], dim=1) @ kr[0] + g @ kr[1]
               + torch.cat([g[:, 1:], zero], dim=1) @ kr[2])
        corner0, corner_w = g[:, 0] @ kr[2], g[:, w - 1] @ kr[0]
        mid[:, 1] += torch.where(sj0, corner0, 0.0)
        mid[:, 0] += torch.where(sj0, 0.0, corner0)
        mid[:, w - 1] += torch.where(sj0, corner_w, 0.0)
        mid[:, w - 2] += torch.where(sj0, 0.0, corner_w)
        return mid[:, None]

    g, k = _acc(gz), _acc(khat)
    return ring_grad(g[:, 0], k[2]), ring_grad(g[:, h - 1], k[0])


# ---------------------------------------------------------------- B3

def listed_blocks():
    """(3, 3, 4, 4) bool: the (tap, input block, output block) C x Co blocks
    that ``fold_conv_kernel`` places the image kernel in, 36 of 144 (its
    placement tensor's support). The only blocks whose gradient reaches the
    image kernel through the fold."""
    return _fold_placement(torch.float32, torch.device("cpu")).any(dim=-1)


def fused_folded_conv_grad_weight_plain(x_f, gz, listed=False, rings=None):
    """B3 in plain PyTorch: dk[dr, dc] = window(dr, dc) of the ring-padded
    x_f, transposed, times gz, summed over every position; db = sum of gz.
    Both float32 (float64 for float64 input). ``listed``: dk is zero outside
    the 36 blocks of ``listed_blocks``. ``rings`` (N, 2, W, 4C): the ring
    rows the forward read, in place of x_f's reflect ring."""
    h, w = x_f.shape[1], x_f.shape[2]
    xp = folded_reflect_pad(_acc(x_f),
                            None if rings is None else _acc(rings))
    g = _acc(gz)
    dk = torch.stack([torch.stack([
        torch.einsum("nhwi,nhwo->io", xp[:, dr:dr + h, dc:dc + w], g)
        for dc in range(3)]) for dr in range(3)])
    if listed:
        c4, c4o = dk.shape[2], dk.shape[3]
        mask = listed_blocks().to(dk.device)[:, :, :, None, :, None]
        dk = (dk.reshape(3, 3, 4, c4 // 4, 4, c4o // 4) * mask).reshape(
            dk.shape)
    return dk, g.sum(dim=(0, 1, 2))


def _ceil_div(a, b):
    return -(-a // b)


def _pow2_ceil(v):
    return 1 << (v - 1).bit_length()


# B3's work list: one row per item (one block of the kernel's grid along
# x), B3_FIELDS int32 each; an item's partial tile holds B3_TILE floats (8
# warp tiles of 32 x 32)
B3_FIELDS, B3_TILE = 8, 8192
# positions per shared-memory chunk (8 mma K steps), by element size
B3_CHUNK = {4: 64, 2: 128}


def _pack_blocks(blocks):
    """count | block j << (4 + 4 j): the channel blocks of a gathered axis."""
    return len(blocks) | sum(b << (4 + 4 * j) for j, b in enumerate(blocks))


@functools.lru_cache(maxsize=None)
def b3_items(c4, c4o, listed):
    """B3's items for a (4C -> 4Co) layer, (items, B3_FIELDS) int32 numpy.

    Per tap, the blocks B3 computes form a dense sub-GEMM over a set of
    input blocks S_in and output blocks S_out (all 4 x 4 when dense; with
    ``listed``, ``listed_blocks``: 4 x 4 at the centre tap, 2 x 2 at an
    edge tap, 1 x 1 at a corner). Its rows (input channels, gathered block
    by block in S_in's order) and columns (output channels, by S_out) are
    cut into tiles of wtm x wtn warp tiles of 32 x 32, at most 8 warp tiles
    and 4 along each side, sized to the sub-GEMM so that no tile is mostly
    padding; a tile of fewer than 8 warp tiles splits each chunk's K steps
    among 8 / (wtm wtn) groups of warps. Row fields: tap, m0, n0 (the
    tile's first gathered row and column), wtm, wtn, S_in and S_out packed
    (``_pack_blocks``), and 0. Then db's items: 1 in the last field, no
    input block, every output block, up to 128 output channels each; their
    blocks stage gz alone and sum its columns."""
    c, co = c4 // 4, c4o // 4
    table = listed_blocks().numpy() if listed else np.ones((3, 3, 4, 4),
                                                             bool)
    rows = []
    for tap in range(9):
        t = table[tap // 3, tap % 3]
        s_in = [s for s in range(4) if t[s].any()]
        s_out = [s for s in range(4) if t[:, s].any()]
        if int(t.sum()) != len(s_in) * len(s_out):
            raise AssertionError(f"tap {tap}: listed blocks not a product")
        mg, ng = len(s_in) * c, len(s_out) * co
        wtn = min(4, _pow2_ceil(_ceil_div(ng, 32)))
        wtm = min(8 // wtn, 4, _pow2_ceil(_ceil_div(mg, 32)))
        for m0 in range(0, mg, 32 * wtm):
            for n0 in range(0, ng, 32 * wtn):
                rows.append([tap, m0, n0, wtm, wtn, _pack_blocks(s_in),
                             _pack_blocks(s_out), 0])
    wtn = min(4, _pow2_ceil(_ceil_div(c4o, 32)))
    for n0 in range(0, c4o, 32 * wtn):
        rows.append([4, 0, n0, 1, wtn, _pack_blocks([]),
                     _pack_blocks([0, 1, 2, 3]), 1])
    out = np.asarray(rows, np.int32)
    out.flags.writeable = False  # cached: one array for every caller
    return out


@functools.lru_cache(maxsize=None)
def _b3_items_on(c4, c4o, listed, device):
    """``b3_items`` as a device tensor, copied once per layer shape."""
    return torch.tensor(b3_items(c4, c4o, listed), device=device)


def b3_segment(p, items, chunk):
    """Positions per segment of B3's reduction over ``p`` positions: enough
    segments that ``items`` x segments blocks fill the card (4 per SM of
    an H100's 132), each at least 4 chunks and a whole number of them."""
    s = max(1, min(_ceil_div(_B3_TARGET_BLOCKS, items),
                   _ceil_div(p, 4 * chunk)))
    return _ceil_div(_ceil_div(p, s), chunk) * chunk


def fused_folded_conv_grad_weight(x_f, gz, listed=False, rings=None):
    """(dL/dKf (3, 3, 4C, 4Co), dL/db (4Co,)), both float32, for the fused
    folded conv: x_f (N, H, W, 4C) and gz (N, H, W, 4Co) of one type,
    contiguous, on one device; the kernel reads the reflect ring from x_f,
    or the ring rows from ``rings`` (N, 2, W, 4C) of x_f's type where given
    (rpst's halo mode: the rows the forward's ``rings`` held; counted again
    in ``.launches_rings``).

    ``listed`` is the caller's word that the folded kernel is
    ``fold_conv_kernel``'s output, so that only the 36 blocks of
    ``listed_blocks`` reach a parameter: B3 computes those and writes zeros
    in the other 108. Never inferred from the kernel's values (the gradient
    of a zero block of a free kernel is not zero); dense by default."""
    _check_x("fused_folded_conv_grad_weight", x_f)
    if gz.ndim != 4 or tuple(gz.shape[:3]) != tuple(x_f.shape[:3]) \
            or x_f.shape[3] % 4 or gz.shape[3] % 4:
        raise ValueError(f"x_f {tuple(x_f.shape)} and gz {tuple(gz.shape)} "
                         f"must share (N, H, W), channels multiples of 4")
    tensors = (("x_f", x_f), ("gz", gz))
    if rings is not None:
        n, _, w, c4 = x_f.shape
        if tuple(rings.shape) != (n, 2, w, c4):
            raise ValueError(f"rings must be {(n, 2, w, c4)}, got "
                             f"{tuple(rings.shape)}")
        tensors += (("rings", rings),)
    _check_common("fused_folded_conv_grad_weight", tensors, x_f.dtype,
                  x_f.device)
    if x_f.device.type == "cpu":
        return fused_folded_conv_grad_weight_plain(x_f, gz, listed, rings)
    n, h, w, c4 = x_f.shape
    c4o = gz.shape[3]
    listed = bool(listed)
    items = _b3_items_on(c4, c4o, listed, x_f.device)
    n_items = items.shape[0]
    seg = b3_segment(n * h * w, n_items, B3_CHUNK[x_f.element_size()])
    segments = _ceil_div(n * h * w, seg)
    f32 = dict(dtype=torch.float32, device=x_f.device)
    # the listed mode's work list leaves 108 blocks of dk unwritten
    dk = (torch.zeros if listed else torch.empty)((3, 3, c4, c4o), **f32)
    db = torch.empty((c4o,), **f32)
    part = (torch.empty((segments, n_items * B3_TILE), **f32),
            torch.empty((segments, c4o), **f32)) if segments > 1 \
        else (None, None)
    if rings is None:
        _launch(f"rpst_folded_conv_grad_weight_{_ENTRY[x_f.dtype]}", "B3",
                x_f, gz, items, dk, db, *part, n_items, n, h, w, c4, c4o, seg)
    else:
        _launch(f"rpst_folded_conv_grad_weight_rings_{_ENTRY[x_f.dtype]}",
                "B3", x_f, rings, gz, items, dk, db, *part, n_items, n, h, w,
                c4, c4o, seg)
    _count(fused_folded_conv_grad_weight, "" if rings is None else "rings")
    return dk, db


fused_folded_conv_grad_weight.launches = 0
fused_folded_conv_grad_weight.launches_rings = 0


# ---------------------------------------------------------------- autograd

class FoldedConvAct(torch.autograd.Function):
    """Differentiable fused reflect-pad + folded conv + bias + leaky ReLU
    (``alpha`` the negative slope; 0 gives the VGG path's ReLU); the
    counterpart of rpst's ``folded_conv_act``.

    Forward is B1, which builds the reflect ring rows itself, so the rings
    are no autograd input: their adjoint comes back through B2's ring
    scatter, counted once. The activation mask is read from the saved
    OUTPUT (a slope >= 0 keeps the sign), so the residuals are (x, kernel,
    y). Backward: gz = where(y > 0, g, alpha g); B2 with khat =
    kf.flip(0, 1).transpose(2, 3) when x needs a gradient, B3 when the
    kernel or bias does (never for the frozen VGG), cast to the kernel's
    type as rpst does. ``listed`` (the caller's word that the kernel is
    ``fold_conv_kernel``'s output) has B3 compute only the 36 blocks the
    fold's backward reads, zeros elsewhere; dense by default."""

    @staticmethod
    def forward(ctx, x_f, folded_kernel, folded_bias, alpha, listed=False):
        y = fused_folded_conv(x_f, folded_kernel, folded_bias, alpha)
        ctx.save_for_backward(x_f, folded_kernel, y)
        ctx.alpha, ctx.listed = alpha, listed
        return y

    @staticmethod
    def backward(ctx, g):
        x_f, kf, y = ctx.saved_tensors
        need_x, need_k, need_b = ctx.needs_input_grad[:3]
        gz = torch.where(y > 0, g, g * ctx.alpha).contiguous()
        dx = dk = db = None
        if need_x:
            khat = kf.flip(0, 1).transpose(2, 3).contiguous()
            dx = fused_folded_conv_grad_input(gz, khat)
        if need_k or need_b:
            dk, db = fused_folded_conv_grad_weight(x_f, gz, ctx.listed)
            dk, db = dk.to(kf.dtype), db.to(kf.dtype)
        return dx, dk, db, None, None


def folded_conv_act(x_f, folded_kernel, folded_bias, alpha, listed=False):
    """``FoldedConvAct``; ``listed`` only where ``folded_kernel`` is
    ``fold_conv_kernel``'s output (the live training fold)."""
    return FoldedConvAct.apply(x_f, folded_kernel, folded_bias, alpha, listed)


# rpst's names for the two epilogues: lrelu 0.2 (RP stacks) and relu (VGG)
def folded_conv_lrelu(x_f, folded_kernel, folded_bias):
    return folded_conv_act(x_f, folded_kernel, folded_bias, 0.2)


def folded_conv_relu(x_f, folded_kernel, folded_bias):
    return folded_conv_act(x_f, folded_kernel, folded_bias, 0.0)


class FoldedConvActHalo(torch.autograd.Function):
    """The fused folded conv on a row shard, differentiable in its two
    virtual rows too; the counterpart of rpst's custom VJP
    ``folded_conv_act_halo`` (:604-647).

    Inputs (x_f, k, b, above, below), ``above`` / ``below`` (N, 1, W, 4C)
    the rows the shard's neighbours hold (or the reflect ring at the image's
    edge), which the caller's halo exchange made and whose gradients its
    backward routes back. Forward: B1 with ``rings = cat(above, below)``.
    Backward: gz = where(y > 0, g, alpha g); dx by B2 with ``row_rings=
    False``, (d_above, d_below) by ``fused_folded_conv_ring_grads``, (dk,
    db) by B3 with the same rings (``listed`` as ``FoldedConvAct``'s), cast
    as rpst casts them: dk, db to the kernel's type, the rows' gradients to
    theirs."""

    @staticmethod
    def forward(ctx, x_f, folded_kernel, folded_bias, above, below, alpha,
                listed=False):
        rings = torch.cat([above, below], dim=1).to(x_f.dtype).contiguous()
        y = fused_folded_conv(x_f, folded_kernel, folded_bias, alpha, rings)
        ctx.save_for_backward(x_f, folded_kernel, y, rings)
        ctx.alpha, ctx.listed = alpha, listed
        ctx.row_dtypes = (above.dtype, below.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x_f, kf, y, rings = ctx.saved_tensors
        need_x, need_k, need_b, need_a, need_be = ctx.needs_input_grad[:5]
        gz = torch.where(y > 0, g, g * ctx.alpha).contiguous()
        khat = kf.flip(0, 1).transpose(2, 3).contiguous()
        dx = dk = db = d_above = d_below = None
        if need_x:
            dx = fused_folded_conv_grad_input(gz, khat, row_rings=False)
        if need_a or need_be:
            d_above, d_below = fused_folded_conv_ring_grads(gz, khat)
            d_above = d_above.to(ctx.row_dtypes[0])
            d_below = d_below.to(ctx.row_dtypes[1])
        if need_k or need_b:
            dk, db = fused_folded_conv_grad_weight(x_f, gz, ctx.listed, rings)
            dk, db = dk.to(kf.dtype), db.to(kf.dtype)
        return dx, dk, db, d_above, d_below, None, None


def folded_conv_act_halo(x_f, folded_kernel, folded_bias, above, below,
                         alpha=0.2, listed=False):
    """``FoldedConvActHalo``; ``listed`` only where ``folded_kernel`` is
    ``fold_conv_kernel``'s output (the live training fold)."""
    return FoldedConvActHalo.apply(x_f, folded_kernel, folded_bias, above,
                                   below, alpha, listed)
