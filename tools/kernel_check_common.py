"""What the per-kernel compile checks (``b1_compile_check.py``,
``b5_compile_check.py``, ``b6_compile_check.py``) share: building an earlier
version of a kernel source by hand, to time it beside the current one, and
counting instruction mnemonics in a built library's SASS."""

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


def sass_counts(name: str, mnemonics, function: str = "") -> str:
    """'SASS: n IMMA, ...' of the built ``csrc/<name>.cu``, by cuobjdump; with
    ``function``, of the kernels whose (mangled) name contains it only."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return "cuobjdump not in the toolkit"
    text = subprocess.run([str(tool), "-sass", str(build.build(name))],
                          capture_output=True, text=True).stdout
    if function:
        text = "".join(part for part in text.split("Function : ")[1:]
                       if function in part.split("\n", 1)[0])
    return "SASS: " + ", ".join(f"{text.count(m)} {m}" for m in mnemonics)
