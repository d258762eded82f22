"""B1: fused reflect-ring pad + 3x3 folded conv + bias + leaky ReLU.

Port of ``rpst.ops.pallas.folded_conv.fused_folded_conv`` (forward only).
``fused_folded_conv`` is the wrapper: a CUDA tensor launches the hand-written
kernel in ``rpst_torch/csrc/folded_conv.cu`` or raises; a CPU tensor takes
``fused_folded_conv_plain``, the same function in plain PyTorch (ring pad +
``F.conv2d``), which the CPU tests hold against rpst. ``fused_folded_conv.
launches`` counts the kernel's launches and nothing else.

The autograd Function (backward kernels B2/B3) arrives with the training
slice; until then the wrapper refuses inputs that require grad under grad
mode instead of silently detaching them.
"""

from __future__ import annotations

import threading

import torch

from .folded import _row_ring, folded_conv

_ENTRY = {torch.float32: "rpst_folded_conv_f32",
          torch.bfloat16: "rpst_folded_conv_bf16"}
_launch_lock = threading.Lock()


def fused_folded_conv_plain(x_f, folded_kernel, folded_bias, alpha=0.2,
                            rings=None):
    """lrelu_alpha(folded_conv(x_f) + bias) in plain PyTorch, with the same
    ``rings`` override as the kernel."""
    y = folded_conv(x_f, folded_kernel, folded_bias, rings)
    return torch.where(y >= 0, y, alpha * y)


def _check(x_f, k, b, rings):
    if x_f.dtype not in _ENTRY:
        raise TypeError(f"fused_folded_conv takes float32/bfloat16, got "
                        f"{x_f.dtype}")
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
    if tuple(rings.shape) != (n, 2, w, c4):
        raise ValueError(f"rings must be {(n, 2, w, c4)}, got "
                         f"{tuple(rings.shape)}")
    for name, t in (("x_f", x_f), ("kernel", k), ("bias", b),
                    ("rings", rings)):
        if t.device != x_f.device:
            raise ValueError(f"{name} is on {t.device}, x_f on {x_f.device}")
        if t.dtype != x_f.dtype:
            raise TypeError(f"{name} is {t.dtype}, x_f is {x_f.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_folded_conv(x_f, folded_kernel, folded_bias, alpha=0.2,
                      rings=None):
    """lrelu_alpha(folded_reflect_conv(x_f) + bias) for NHWC folded tensors.

    x_f (N, Hf, Wf, 4C) float32 or bfloat16, folded_kernel (3, 3, 4C, 4Co)
    and folded_bias (4Co,) of x_f's type, all contiguous on one device; the
    output has x_f's type. ``rings`` (N, 2, Wf, 4C) overrides the two
    virtual boundary rows (row 0 above x_f, row 1 below); by default they
    are the reflect ring. Both devices check the same contract."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x_f, folded_kernel, folded_bias, rings)):
        raise RuntimeError(
            "fused_folded_conv is forward-only in this slice (its autograd "
            "Function arrives with the backward kernels B2/B3): call it "
            "under torch.no_grad() or torch.inference_mode()")
    if x_f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_folded_conv runs on cuda or cpu tensors, "
                         f"got {x_f.device}")
    if x_f.ndim != 4 or x_f.shape[1] < 2 or x_f.shape[2] < 2:
        raise ValueError(f"expected x_f (N, Hf, Wf, 4C) with Hf, Wf >= 2, got "
                         f"{tuple(x_f.shape)}")
    if rings is None:
        rings = torch.cat([_row_ring(x_f, True), _row_ring(x_f, False)],
                          dim=1)
    rings = rings.to(x_f.dtype)
    _check(x_f, folded_kernel, folded_bias, rings)
    if x_f.device.type == "cpu":
        return fused_folded_conv_plain(x_f, folded_kernel, folded_bias,
                                       alpha, rings)

    from ..kernels.build import load
    n, h, w, c4 = x_f.shape
    c4o = folded_kernel.shape[3]
    y = torch.empty((n, h, w, c4o), dtype=x_f.dtype, device=x_f.device)
    fn = getattr(load("folded_conv"), _ENTRY[x_f.dtype])
    with torch.cuda.device(x_f.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_f.data_ptr(), rings.data_ptr(), folded_kernel.data_ptr(),
                 folded_bias.data_ptr(), y.data_ptr(), n, h, w, c4, c4o,
                 float(alpha), stream)
    if err != 0:
        raise RuntimeError(f"fused_folded_conv launch failed: cudaError {err} "
                           f"at x {tuple(x_f.shape)}, 4Co {c4o}")
    with _launch_lock:
        fused_folded_conv.launches += 1
    return y


fused_folded_conv.launches = 0


# rpst's names for the two epilogues: lrelu 0.2 (RP stacks) and relu (VGG)
def folded_conv_lrelu(x_f, folded_kernel, folded_bias):
    return fused_folded_conv(x_f, folded_kernel, folded_bias, alpha=0.2)


def folded_conv_relu(x_f, folded_kernel, folded_bias):
    return fused_folded_conv(x_f, folded_kernel, folded_bias, alpha=0.0)
