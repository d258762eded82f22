"""Build the CUDA sources under ``rpst_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
into ``build/rpst_torch/lib<name>-<hash>.so`` at the repository root (a
git-ignored directory) the first time a kernel is launched::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas -v -o build/rpst_torch/lib<name>-<hash>.so <name>.cu

The hash covers the source, every header under ``csrc`` and the flags, so
an edited source or header rebuilds and an unchanged one loads the cached
library. A build that fails, or a missing
nvcc, raises: there is no fallback. Nothing is built when a module is
imported; the CPU tests never reach this file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "rpst_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, rings, k, wp and bits scratch (the kernel packed K-major and its
# non-zero block table, filled by the launch), b, y (device pointers), N, H,
# W, C4, C4o, alpha, stream
_FOLDED_CONV_ARGS = [_PTR] * 7 + [_INT] * 5 + [_FLOAT, _PTR]
# gz, khat, wp and bits scratch, dx (device pointers), N, H, W, C4o, C4,
# stream
_GRAD_INPUT_ARGS = [_PTR] * 5 + [_INT] * 5 + [_PTR]
# x, gz, items (B3's work list), dk, db, dk_part, db_part (device
# pointers), n_items, N, H, W, C4, C4o, seg_len, stream
_GRAD_WEIGHT_ARGS = [_PTR] * 7 + [_INT] * 7 + [_PTR]
# x, w, wp and bits scratch (w packed K-major and its block table, filled
# by the launch), scales, y, s1, s2, part (device pointers), N, H, W, C4,
# C4o, out_int8, with_stats, stream
_FOLDED_CONV_Q8_ARGS = [_PTR] * 9 + [_INT] * 7 + [_PTR]
# x, w1, scales1, w2, scales2, wp and bits scratch (both kernels packed and
# their block tables), y1, y2, s11, s12, s21, s22, part (device pointers),
# N, H, W, C4, C4m, C4o, out_int8, with_stats, stream
_FOLDED_CONV2_Q8_ARGS = [_PTR] * 14 + [_INT] * 8 + [_PTR]
# x, packed w (ops.folded_conv.pack_k_major), scales, y (device
# pointers), N, H, W, C, Co, out_int8, reflect, alpha, stream
_CONV2D_Q8_ARGS = [_PTR] * 4 + [_INT] * 7 + [_FLOAT, _PTR]
# x, packed w, bias, y (device pointers), N, H, W, C, Co, reflect, alpha,
# stream
_CONV2D_BF16_ARGS = [_PTR] * 4 + [_INT] * 6 + [_FLOAT, _PTR]
# q, k, v, o, lse or NULL (device pointers), N, Nq, Nk, C, stream
_FLASH_FWD_ARGS = [_PTR] * 5 + [_INT] * 4 + [_PTR]
# q, k, v, d_o, lse, delta, dq (device pointers), N, Nq, Nk, C, stream
_FLASH_DQ_ARGS = [_PTR] * 7 + [_INT] * 4 + [_PTR]
# q, k, v, d_o, lse, delta, dk, dv (device pointers), N, Nq, Nk, C, stream
_FLASH_DKV_ARGS = [_PTR] * 8 + [_INT] * 4 + [_PTR]
# C signature of every exported function, by library: (argtypes, restype);
# every function returns its launch's cudaError_t
SIGNATURES = {
    "folded_conv": {
        "rpst_folded_conv_f32": (_FOLDED_CONV_ARGS, _INT),
        "rpst_folded_conv_bf16": (_FOLDED_CONV_ARGS, _INT),
    },
    "folded_conv_bwd": {
        "rpst_folded_conv_grad_input_f32": (_GRAD_INPUT_ARGS, _INT),
        "rpst_folded_conv_grad_input_bf16": (_GRAD_INPUT_ARGS, _INT),
        "rpst_folded_conv_grad_weight_f32": (_GRAD_WEIGHT_ARGS, _INT),
        "rpst_folded_conv_grad_weight_bf16": (_GRAD_WEIGHT_ARGS, _INT),
    },
    "folded_conv_q8": {
        "rpst_folded_conv_q8": (_FOLDED_CONV_Q8_ARGS, _INT),
        # (H, W) -> the kernel's spatial tile count (sizes the stats scratch)
        "rpst_folded_conv_q8_tiles": ([_INT, _INT], _INT),
    },
    "folded_conv2_q8": {
        "rpst_folded_conv2_q8": (_FOLDED_CONV2_Q8_ARGS, _INT),
        "rpst_folded_conv2_q8_tiles": ([_INT, _INT], _INT),
    },
    "conv2d_q8": {
        "rpst_conv2d_q8": (_CONV2D_Q8_ARGS, _INT),
        "rpst_conv2d_bf16": (_CONV2D_BF16_ARGS, _INT),
    },
    "flash_attention": {
        "rpst_flash_fwd_f32": (_FLASH_FWD_ARGS, _INT),
        "rpst_flash_fwd_bf16": (_FLASH_FWD_ARGS, _INT),
        "rpst_flash_bwd_dq_f32": (_FLASH_DQ_ARGS, _INT),
        "rpst_flash_bwd_dq_bf16": (_FLASH_DQ_ARGS, _INT),
        "rpst_flash_bwd_dkv_f32": (_FLASH_DKV_ARGS, _INT),
        "rpst_flash_bwd_dkv_bf16": (_FLASH_DKV_ARGS, _INT),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when cached), "log": nvcc output}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(nvcc).exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "rpst_torch are built from source at first use")
    return nvcc


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists; returns the library's path."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():  # keep the log of this process's own build
        build_info.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial .so
    build_info[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
    return lib


def build_all() -> None:
    """Build every library of ``SIGNATURES`` at once, one nvcc process per
    source, all started together; raises the first build's error."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(SIGNATURES)) as pool:
        for future in [pool.submit(build, name) for name in SIGNATURES]:
            future.result()


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes``/``restype`` set for every exported function."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]


def launch(name: str, fn: str, what: str, *args) -> None:
    """Call ``fn`` of ``csrc/<name>.cu`` on the current stream of the first
    tensor's device; tensors pass as their data pointers. Raises if the
    launch returns a CUDA error."""
    import torch
    cfn = getattr(load(name), fn)
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = cfn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
