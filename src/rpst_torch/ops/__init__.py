"""Ports of rpst.ops: folded space-to-depth ops, statistics, kernels."""

from .stats import groupwise_adain

__all__ = ["groupwise_adain"]
