"""The port's native image decoder; counterpart of ``rpst.data.native_io``.

``csrc/host/imageio.cpp`` (libjpeg / libpng and a bit-exact copy of PIL's
fixed-point bilinear resample) is built with the host compiler into
``build/rpst_torch/`` at first use (``kernels.build.load("imageio")``) and
called through ctypes, which releases the GIL for the call: the loader
threads (``data.InfiniteLoader``) decode in parallel.

``load_image_native`` returns what ``data.load_image``'s PIL route returns,
byte for byte, or ``None`` for a file the library declines (CMYK, 16-bit,
interlaced, formats other than JPEG and PNG), which PIL then decodes.

``RPST_NATIVE_IO=0`` (read at first use) switches the library off. The
first use logs which decoder runs. A library that does not build is logged
once as a warning carrying the compiler's error, and PIL decodes, with the
same bytes; ``available()`` and ``reason()`` say which decoder runs.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("rpst_torch")
_lock = threading.Lock()
# "lib": the library or None; "why": why PIL decodes ("" when native)
_state: dict = {}


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if "lib" not in _state:
            lib, why = None, ""
            if os.environ.get("RPST_NATIVE_IO", "1") == "0":
                why = "RPST_NATIVE_IO=0"
                logger.info("image decoder: PIL (RPST_NATIVE_IO=0)")
            else:
                from .kernels import build
                try:
                    lib = build.load("imageio")
                    logger.info(f"image decoder: native libjpeg / libpng "
                                f"({lib._name})")
                except (RuntimeError, OSError) as err:
                    why = str(err)
                    logger.warning("image decoder: PIL; the native decoder "
                                   f"did not build: {why}")
            _state.update(lib=lib, why=why)
        return _state["lib"]


def available() -> bool:
    """Whether the native decoder runs (built, and not switched off)."""
    return _load() is not None


def reason() -> str:
    """Why PIL decodes: ``RPST_NATIVE_IO=0`` or the build's error; empty
    when the native decoder runs."""
    _load()
    return _state["why"]


def load_image_native(path, img_size: int) -> Optional[np.ndarray]:
    """Decode and resize through the library: float32 HWC in [0, 1], or
    ``None``. ``img_size`` 0 keeps the image's size (probed first, as
    ``data.load_image`` skips the resize)."""
    lib = _load()
    if lib is None:
        return None
    p = str(path).encode()
    if img_size:
        w = h = int(img_size)
    else:
        cw, ch = ctypes.c_int32(0), ctypes.c_int32(0)
        if lib.rpst_image_size(p, ctypes.byref(cw), ctypes.byref(ch)) != 0:
            return None
        w, h = cw.value, ch.value
    out = np.empty((h, w, 3), np.float32)
    if lib.rpst_load_image_rgb(
            p, w, h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
        return None  # declined or corrupt: PIL decodes it
    return out
