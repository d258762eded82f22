"""Builds and binds the CUDA sources under rpst_torch/csrc."""
