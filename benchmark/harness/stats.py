"""Whole-window statistics on the host clock."""

from __future__ import annotations

import math
from typing import Sequence


def rate(count: float, seconds: float) -> float:
    """Work done in the window over the window's seconds."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``: the smallest
    value with at least q% of them at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def in_window(done: float, t0: float, t1: float) -> bool:
    return t0 <= done <= t1
