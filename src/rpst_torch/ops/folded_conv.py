"""B1, B2, B3: the fused folded conv and its backward pair, with autograd.

Ports of ``rpst.ops.pallas.folded_conv``:
  * B1 ``fused_folded_conv``: reflect-ring pad + 3x3 folded conv + bias +
    leaky ReLU, forward (CUDA ``csrc/folded_conv.cu``);
  * B2 ``fused_folded_conv_grad_input``: dx from gz and the rotated,
    transposed kernel, ring adjoint included (CUDA ``csrc/folded_conv_bwd.cu``);
  * B3 ``fused_folded_conv_grad_weight``: dk and db, the folded correlation
    (same source);
  * ``FoldedConvAct``, the counterpart of rpst's custom VJP
    ``folded_conv_act``: forward B1, backward B2 + B3.

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
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .folded import _row_ring, conv_nhwc, folded_conv, folded_reflect_pad

_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}
_launch_lock = threading.Lock()
# B3 sizing: the kernel's tile widths (16 for a 12-wide side, else 128), the
# positions per shared-memory chunk, and the blocks to aim for (4 per SM of
# an H100's 132) when cutting the reduction into segments
_B3_KP, _B3_TARGET_BLOCKS = 32, 4 * 132


def _count(wrapper) -> None:
    with _launch_lock:
        wrapper.launches += 1


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


def _ring_rows(x_f):
    """The reflect ring rows (N, 2, W, 4C): row 0 above x_f, row 1 below."""
    return torch.cat([_row_ring(x_f, True), _row_ring(x_f, False)], dim=1)


def block_table(k):
    """(3, 3, 4, 4) uint8 of a (3, 3, 4C, 4Co) kernel: 1 where the C x Co
    block of (tap, input sub-position block, output sub-position block)
    holds a non-zero (NaN included), the blocks B1 and B2 take (their
    launches build the same table on the card, as bits)."""
    c4, c4o = k.shape[2], k.shape[3]
    nz = k.reshape(3, 3, 4, c4 // 4, 4, c4o // 4).ne(0)
    return nz.any(dim=5).any(dim=3).to(torch.uint8)


def pack_k_major(w):
    """HWIO (3, 3, C, Co) weights in the order of the tensor-core kernels'
    ``mma`` (B1 / B2 here, B5 in ``ops.conv2d_q8``): (3, 3, ceil(C / KE),
    Co, KE) contiguous, KE input channels = 32 bytes (one k-step: 8
    float32, 16 bfloat16, 32 int8), zeros past C. ``packed[dr, dc, s, co,
    e] = w[dr, dc, s * KE + e, co]``."""
    ke = 32 // w.element_size()
    c, co = w.shape[2], w.shape[3]
    steps = -(-c // ke)
    padded = F.pad(w, (0, 0, 0, steps * ke - c))
    return padded.reshape(3, 3, steps, ke, co).permute(0, 1, 2, 4, 3) \
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
    ``FoldedConvAct`` (backward B2 + B3), so no gradient is dropped; the
    ``rings`` override has no backward in this slice and raises there."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x_f, folded_kernel, folded_bias, rings)):
        if rings is not None:
            raise NotImplementedError(
                "fused_folded_conv: the gradient of a rings override (the "
                "halo path folded_conv_act_halo) is ROADMAP.md section A "
                "slice 8")
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


def fused_folded_conv_grad_input_plain(gz, khat):
    """B2 in plain PyTorch: the gradient on the ring-padded grid is the FULL
    conv of gz with khat; its interior is the SAME-zero conv, and the ring
    values go back where ``folded_reflect_pad`` read them from: the ring
    columns (on every padded row) by the sub-column rule, then the ring
    rows by the sub-row rule. Accumulates in float32; returns gz's type."""
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
    g[:, 1] += torch.where(si0, top, 0.0)
    g[:, 0] += torch.where(si0, 0.0, top)
    g[:, h - 1] += torch.where(si0, bottom, 0.0)
    g[:, h - 2] += torch.where(si0, 0.0, bottom)
    return g.to(gz.dtype)


def fused_folded_conv_grad_input(gz, khat):
    """dL/dx_f of the fused folded conv given gz = dL/d(pre-activation).

    gz (N, H, W, 4Co), khat (3, 3, 4Co, 4C) = ``kf.flip(0, 1).transpose(2,
    3)``, both of one type (float32/bfloat16), contiguous, on one device.
    Returns dx (N, H, W, 4C) of gz's type, the reflect-ring adjoint (rows
    and columns) included."""
    _check_x("fused_folded_conv_grad_input", gz)
    if khat.ndim != 4 or tuple(khat.shape[:3]) != (3, 3, gz.shape[3]) \
            or khat.shape[3] % 4:
        raise ValueError(f"khat must be (3, 3, {gz.shape[3]}, 4C), got "
                         f"{tuple(khat.shape)}")
    _check_common("fused_folded_conv_grad_input",
                  (("gz", gz), ("khat", khat)), gz.dtype, gz.device)
    if gz.device.type == "cpu":
        return fused_folded_conv_grad_input_plain(gz, khat)
    n, h, w, c4o = gz.shape
    c4 = khat.shape[3]
    dx = torch.empty((n, h, w, c4), dtype=gz.dtype, device=gz.device)
    _launch(f"rpst_folded_conv_grad_input_{_ENTRY[gz.dtype]}", "B2", gz,
            khat, *_scratch(khat), dx, n, h, w, c4o, c4)
    _count(fused_folded_conv_grad_input)
    return dx


fused_folded_conv_grad_input.launches = 0


# ---------------------------------------------------------------- B3

def fused_folded_conv_grad_weight_plain(x_f, gz):
    """B3 in plain PyTorch: dk[dr, dc] = window(dr, dc) of the ring-padded
    x_f, transposed, times gz, summed over every position; db = sum of gz.
    Both float32 (float64 for float64 input)."""
    h, w = x_f.shape[1], x_f.shape[2]
    xp = folded_reflect_pad(_acc(x_f))
    g = _acc(gz)
    dk = torch.stack([torch.stack([
        torch.einsum("nhwi,nhwo->io", xp[:, dr:dr + h, dc:dc + w], g)
        for dc in range(3)]) for dr in range(3)])
    return dk, g.sum(dim=(0, 1, 2))


def _ceil_div(a, b):
    return -(-a // b)


def _b3_segment(n, h, w, c4, c4o):
    """Positions per segment of B3's reduction: enough segments that the
    narrow layers fill the card, each a whole number of chunks."""
    tiles = _ceil_div(c4, 16 if c4 <= 16 else 128) \
        * _ceil_div(c4o, 16 if c4o <= 16 else 128) * 9
    p = n * h * w
    s = max(1, min(_ceil_div(_B3_TARGET_BLOCKS, tiles), _ceil_div(p, 256)))
    return _ceil_div(_ceil_div(p, s), _B3_KP) * _B3_KP


def fused_folded_conv_grad_weight(x_f, gz):
    """(dL/dKf (3, 3, 4C, 4Co), dL/db (4Co,)), both float32, for the fused
    folded conv: x_f (N, H, W, 4C) and gz (N, H, W, 4Co) of one type,
    contiguous, on one device. The ring rows are the reflect ring, built
    here as B1's wrapper builds them."""
    _check_x("fused_folded_conv_grad_weight", x_f)
    if gz.ndim != 4 or tuple(gz.shape[:3]) != tuple(x_f.shape[:3]) \
            or x_f.shape[3] % 4 or gz.shape[3] % 4:
        raise ValueError(f"x_f {tuple(x_f.shape)} and gz {tuple(gz.shape)} "
                         f"must share (N, H, W), channels multiples of 4")
    _check_common("fused_folded_conv_grad_weight",
                  (("x_f", x_f), ("gz", gz)), x_f.dtype, x_f.device)
    if x_f.device.type == "cpu":
        return fused_folded_conv_grad_weight_plain(x_f, gz)
    n, h, w, c4 = x_f.shape
    c4o = gz.shape[3]
    rings = _ring_rows(x_f)
    seg = _b3_segment(n, h, w, c4, c4o)
    segments = _ceil_div(n * h * w, seg)
    f32 = dict(dtype=torch.float32, device=x_f.device)
    dk = torch.empty((3, 3, c4, c4o), **f32)
    db = torch.empty((c4o,), **f32)
    part = (torch.empty((segments, 9 * c4 * c4o), **f32),
            torch.empty((segments, c4o), **f32)) if segments > 1 \
        else (None, None)
    _launch(f"rpst_folded_conv_grad_weight_{_ENTRY[x_f.dtype]}", "B3", x_f,
            rings, gz, dk, db, *part, n, h, w, c4, c4o, seg)
    _count(fused_folded_conv_grad_weight)
    return dk, db


fused_folded_conv_grad_weight.launches = 0


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
    type as rpst does."""

    @staticmethod
    def forward(ctx, x_f, folded_kernel, folded_bias, alpha):
        y = fused_folded_conv(x_f, folded_kernel, folded_bias, alpha)
        ctx.save_for_backward(x_f, folded_kernel, y)
        ctx.alpha = alpha
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
            dk, db = fused_folded_conv_grad_weight(x_f, gz)
            dk, db = dk.to(kf.dtype), db.to(kf.dtype)
        return dx, dk, db, None


def folded_conv_act(x_f, folded_kernel, folded_bias, alpha):
    return FoldedConvAct.apply(x_f, folded_kernel, folded_bias, alpha)


# rpst's names for the two epilogues: lrelu 0.2 (RP stacks) and relu (VGG)
def folded_conv_lrelu(x_f, folded_kernel, folded_bias):
    return folded_conv_act(x_f, folded_kernel, folded_bias, 0.2)


def folded_conv_relu(x_f, folded_kernel, folded_bias):
    return folded_conv_act(x_f, folded_kernel, folded_bias, 0.0)
