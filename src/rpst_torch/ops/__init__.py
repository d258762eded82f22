"""Ports of rpst.ops: folded space-to-depth ops, statistics, kernels."""
