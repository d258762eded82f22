"""The port's logger and image writers; counterpart of the three in
``rpst.train.metrics``, which the port cannot import (``rpst.train`` pulls in
the JAX train step)."""

from __future__ import annotations

import logging

import numpy as np

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


def save_image_row(images, path):
    """Images side by side in one PNG, each clipped to [0, 1] (the
    reference's 3-panel ``{content}-{style}-cat.png``, ``train.py:208-218``)."""
    row = np.concatenate([np.clip(np.asarray(im, np.float32), 0, 1)
                          for im in images], axis=1)
    to_image(row).save(path)
