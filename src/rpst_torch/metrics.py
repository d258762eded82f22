"""The port's logger and image writer; counterpart of the two in
``rpst.train.metrics``, which the port cannot import (``rpst.train`` pulls in
the JAX train step)."""

from __future__ import annotations

import logging

from .data import to_image

logger = logging.getLogger("rpst_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def save_image(image, path):
    """HWC/NHWC float in [0, 1] (clipped) or uint8 -> PNG/JPEG at ``path``."""
    to_image(image).save(path)
