"""What the per-kernel compile checks (``b1_compile_check.py``,
``b4_compile_check.py``, ``b5_compile_check.py``, ``b6_compile_check.py``)
share: building an earlier version of a kernel source by hand, to time it
beside the current one, counting instruction mnemonics in a built library's
SASS, timing calls back to back on the card, and checking a launch's
packed weights and block table (the folded kernels B1, B2, B4, B7)."""

import ctypes
import subprocess
from pathlib import Path

from rpst_torch.kernels import build


def parent_library(name: str, source: Path, tag: str = "parent",
                   signatures=None):
    """``source``, an earlier version of ``csrc/<name>.cu`` (its headers
    beside it), built with the package's nvcc flags into
    ``<tag>_<name>.so`` (one tag a source: a library is loaded once a path)
    and loaded with ``signatures`` ({function: (argtypes, restype)}), by
    default those of ``build.SIGNATURES[name]`` (the same C interface)."""
    out = build.BUILD_DIR / f"{tag}_{name}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if not f.startswith("-DB")]
    subprocess.run([build._nvcc(), *flags, "-o", str(out), str(source)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in (signatures
                                    or build.SIGNATURES[name]).items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    return lib


def device_ms(fn, reps=10, iters=5):
    """Median ms of one ``fn()`` over ``iters`` timings of ``reps`` calls
    back to back between two CUDA events, so that the card, not the host's
    launch latency, sets the time (``chip_smoke.cuda_ms`` times one call from
    an idle card)."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[iters // 2]


def check_prep(op, k, packed, bits):
    """The launch's packing and block table of kernel ``k`` against
    ``pack_k_major`` and ``block_table``: 1 if either differs."""
    import torch
    from rpst_torch.ops import folded_conv as fc
    table = torch.stack([(bits.cpu() >> i) & 1 for i in range(16)], -1)
    ok = (torch.equal(packed, fc.pack_k_major(k).flatten())
          and torch.equal(table.view(3, 3, 4, 4).to(torch.uint8),
                          fc.block_table(k).cpu()))
    if not ok:
        print(f"  {op}: the launch's packed weights or block table differ "
              "from pack_k_major / block_table")
    return int(not ok)


def sass_counts(name: str, mnemonics, function: str = "",
                lib: Path = None) -> str:
    """'SASS: n IMMA, ...' of the built ``csrc/<name>.cu`` (or of the library
    ``lib``), by cuobjdump; with ``function``, of the kernels whose
    (mangled) name contains it only."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return "cuobjdump not in the toolkit"
    text = subprocess.run([str(tool), "-sass", str(lib or build.build(name))],
                          capture_output=True, text=True).stdout
    if function:
        text = "".join(part for part in text.split("Function : ")[1:]
                       if function in part.split("\n", 1)[0])
    return "SASS: " + ", ".join(f"{text.count(m)} {m}" for m in mnemonics)
