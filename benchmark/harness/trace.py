"""A ``torch.profiler`` window over part of the measured window, and what
the per-layer readers take from it.

``short_name`` and the union arithmetic are copied from
``profile_torch.py`` (``short_name``, ``device_breakdown``): device time by
kernel name, and busy time as the union of every device activity (kernels,
copies, sets) over the first-to-last span; the idle share is one less busy
over that window. Idle gaps are named by the host operation that overlaps
each most (the shortest where several cover it whole), over the longest
gaps only.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

Span = Tuple[float, float, str]   # (start s, end s, name)
GAPS_NAMED = 200
TOP = 10


def short_name(name: str) -> str:
    """'void at::native::reduce_kernel<512, 1, ...>(...)' -> 'reduce_kernel';
    B1 and B2's shared kernel 'folded::folded_mma_kernel<T, WIDE, BWD, ...>'
    -> 'folded_mma_kernel[B1]' or '[B2]' by its BWD argument."""
    bwd = re.search(r"folded_mma_kernel<[^,]+,\s*\w+,\s*(\w+)", name)
    if bwd:
        op = "B2" if bwd.group(1) in ("true", "1") else "B1"
        return f"folded_mma_kernel[{op}]"
    name = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
    name = name.split("<")[0].split("(")[0]
    return name.rsplit("::", 1)[-1].strip()


def union_busy(spans: Sequence[Span]) -> Tuple[float, float, list]:
    """(busy seconds, first-to-last window seconds, merged intervals)."""
    if not spans:
        return 0.0, 0.0, []
    ordered = sorted((s, e) for s, e, _ in spans)
    merged = [list(ordered[0])]
    for s, e in ordered[1:]:
        if s > merged[-1][1]:
            merged.append([s, e])
        else:
            merged[-1][1] = max(merged[-1][1], e)
    busy = sum(e - s for s, e in merged)
    return busy, merged[-1][1] - merged[0][0], merged


def by_name(spans: Sequence[Span]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s, e, name in spans:
        key = short_name(name)
        out[key] = out.get(key, 0.0) + (e - s)
    return out


def name_gaps(merged: list, host: Sequence[Span]) -> Dict[str, float]:
    """Idle seconds by host operation over the ``GAPS_NAMED`` longest gaps
    between the merged device intervals."""
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in
                   zip(merged, merged[1:])), reverse=True)[:GAPS_NAMED]
    if not gaps:
        return {}
    hs = np.array([s for s, _, _ in host]) if host else np.zeros(0)
    he = np.array([e for _, e, _ in host]) if host else np.zeros(0)
    out: Dict[str, float] = {}
    for length, g0, g1 in gaps:
        name = "no host operation"
        if len(hs):
            overlap = np.clip(np.minimum(he, g1) - np.maximum(hs, g0), 0,
                              None)
            best = overlap.max()
            if best > 0:
                near = np.nonzero(overlap >= 0.999 * best)[0]
                pick = near[np.argmin((he - hs)[near])]
                name = host[pick][2]
        out[name] = out.get(name, 0.0) + length
    return out


def top(d: Dict[str, float], n: int = TOP) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def summarize(device: Sequence[Span], host: Sequence[Span]) -> dict:
    """busy_s, window_s, device time by kernel name, and the breakdown."""
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    busy, window, merged = union_busy(device)
    names = by_name(device)
    return {"busy_s": busy, "window_s": window, "by_name": names,
            "breakdown": {"device_ops": top(names),
                          "idle_gaps": top(name_gaps(merged, host))}}


def _events(prof) -> Tuple[List[Span], List[Span]]:
    """(device spans, host spans) in seconds from the profiler's raw
    events (not ``prof.events()``, whose Python objects cost seconds a
    window)."""
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        span = (s, s + d, ev.name())
        (device if ev.device_type().name == "CUDA" else host).append(span)
    return device, host


class Tracer:
    """Start and stop ``torch.profiler`` around part of the window; warm it
    up in set-up so that its start costs little inside the window."""

    def __init__(self):
        self.prof = None

    def _make(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:  # the host operations of every thread: the batcher's too
            from torch._C._profiler import _ExperimentalConfig
            return profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True)))
        except (ImportError, TypeError):  # a PyTorch without the switch
            return profile(activities=acts)

    def warm(self, work):
        with self._make():
            work()

    def start(self):
        self.prof = self._make()
        self.prof.__enter__()

    def stop_recording(self):
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """The recorded window's numbers; read once the measured window
        has closed, so that the reading costs the window nothing."""
        device, host = _events(self.prof)
        self.prof = None
        return summarize(device, host)
