"""Arithmetic the per-layer readers (``metrics/<metric>.py``) share. Each
returns None where its run has nothing to read, and the harness then
leaves the metric out of the line."""

from __future__ import annotations

from typing import Optional

from . import bounds

# kernel names in the device trace (``trace.short_name``) by family: the
# B1 / B2 main kernel and the weight packing each launch runs ahead of
# it, B3's two kernels; B6's forward (B6a and B6b share it), dQ and dK/dV
TRACE_NAMES = {
    "folded_conv": ("folded_mma_kernel[B1]", "folded_mma_kernel[B2]",
                    "prep_weights_kernel", "grad_weight_mma",
                    "grad_weight_reduce"),
    "flash_attention": ("flash_fwd_tf32_kernel", "flash_fwd_mma_kernel",
                        "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
}
# launches of a call may straddle either end of the traced window
EDGE_CALLS = 2


def roofline(run: dict, family: str, phase: str) -> Optional[float]:
    """Σ bound over the family's launches in the traced window ÷ Σ device
    time of its kernels there, in %. The bound of each launch comes from
    the configuration's ``kernel_launches`` plan of one call (a batch or
    a step) at its shapes; the launches are the port's counters over the
    traced window. None when nothing was traced, when the family did not
    run, or when the counters do not fit the plan over the window's calls
    (the program's launch structure changed)."""
    trace, counters = run.get("trace"), run.get("counters")
    plan = run["config"].get("kernel_launches", {}).get(phase)
    if not trace or not counters or not plan or not run.get("trace_calls"):
        return None
    per_call = bounds.plan_per_call(plan, run["batch"])
    total_ms = 0.0
    for kernel, (launches, bound_ms) in per_call.items():
        got = counters.get(kernel, 0)
        if abs(got - launches * run["trace_calls"]) > launches * EDGE_CALLS:
            return None
        total_ms += got * bound_ms / launches
    seconds = sum(trace["by_name"].get(n, 0.0)
                  for n in TRACE_NAMES[family])
    if seconds <= 0 or total_ms <= 0:
        return None
    return 100.0 * total_ms * 1e-3 / seconds


def idle_share(run: dict) -> Optional[float]:
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu(run: dict, flops_key: str) -> Optional[float]:
    """The reference's FLOPs per image (the configuration's ``flops``)
    times the images of the window, over its seconds, as a share of the
    stated compute type's dense peak, in %."""
    per_image = run["config"].get("flops", {}).get(flops_key)
    if not per_image or run["window_s"] <= 0:
        return None
    peak = bounds.MFU_PEAK[run["config"]["settings"]["compute_dtype"]]
    return 100.0 * per_image * run["images"] / run["window_s"] / peak
