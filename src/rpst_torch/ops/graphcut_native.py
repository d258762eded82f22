"""The native chain-MRF solvers; counterpart of ``rpst.ops.graphcut_cpp``.

``csrc/host/graphcut.cpp`` (no dependency) is built with the host compiler
into ``build/rpst_torch/`` at first use (``kernels.build.load("graphcut")``;
a failed build raises) and called through ctypes, on float64 numpy:

  * ``chain_viterbi_cpp``     exact MAP labels by dynamic programming,
    O(C k^2); cross-checks ``ops.graphcut.chain_map_labeling``
  * ``aexpansion_chain_cpp``  alpha-expansion, the algorithm of the
    reference's PyMaxflow ``aexpansion_grid`` (``utils/mst.py:3,157``)
  * ``chain_energy_cpp``      the energy of a labelling
  * ``chain_labeling_native`` torch tensors on any device -> Viterbi labels
    on that device, solved on the host (the reference's own round trip,
    ``utils/mst.py:153-158``)

No model path calls them: ``ops.mst`` labels with the DP.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _lib() -> ctypes.CDLL:
    from ..kernels import build
    return build.load("graphcut")


def available() -> bool:
    try:
        _lib()
        return True
    except (RuntimeError, OSError):
        return False


def _as_c(d, v):
    d = np.ascontiguousarray(d, np.float64)
    v = np.ascontiguousarray(v, np.float64)
    c, k = d.shape
    if v.shape != (k, k):
        raise ValueError(f"V must be ({k}, {k}), got {v.shape}")
    return d, v, c, k


def chain_viterbi_cpp(d, v) -> np.ndarray:
    """Exact MAP labels (C,) int32 of D (C, k) and V (k, k)."""
    d, v, c, k = _as_c(d, v)
    out = np.zeros(c, np.int32)
    _lib().chain_viterbi(d.ctypes.data_as(_F64P), v.ctypes.data_as(_F64P),
                         c, k, out.ctypes.data_as(_I32P))
    return out


def aexpansion_chain_cpp(d, v, max_cycles: int = 0) -> np.ndarray:
    """Alpha-expansion labels (C,) int32 from the per-node argmin;
    ``max_cycles`` <= 0 sweeps until no move lowers the energy."""
    d, v, c, k = _as_c(d, v)
    out = np.zeros(c, np.int32)
    _lib().aexpansion_chain(d.ctypes.data_as(_F64P), v.ctypes.data_as(_F64P),
                            c, k, max_cycles, out.ctypes.data_as(_I32P))
    return out


def chain_energy_cpp(d, v, labels) -> float:
    """sum_c D[c, l_c] + sum_c V[l_c, l_{c+1}]."""
    d, v, c, k = _as_c(d, v)
    labels = np.ascontiguousarray(labels, np.int32)
    return float(_lib().chain_energy_of(
        d.ctypes.data_as(_F64P), v.ctypes.data_as(_F64P), c, k,
        labels.ctypes.data_as(_I32P)))


def chain_labeling_native(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``chain_map_labeling`` through the native Viterbi: d (C, k), v (k, k)
    on any device -> (C,) int32 labels on d's device."""
    labels = chain_viterbi_cpp(d.detach().double().cpu().numpy(),
                               v.detach().double().cpu().numpy())
    return torch.from_numpy(labels).to(d.device)
