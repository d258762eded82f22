"""Peaks and the least time a kernel launch could take, from its shape.

Copied from ``chip_smoke.py`` (``PEAK_OPS``, ``HBM_BYTES_PER_S``,
``bound_ms``, ``folded_bound``) and its B6 phase (``_b6_kernels``), so that
the yardstick stays fixed whatever the program's files become. A bound is
the larger of the operations at the operand type's published dense peak of
one H100 SXM and the bytes (each input read once, each output written once)
at its memory rate; a roofline share is a sum of bounds over a sum of
measured kernel times, and cannot pass 100% unless the count is wrong.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# operations per second by operand type (float32 data held to the TF32
# tensor-core rate) and bytes per second of HBM3
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 495e12}
HBM_BYTES_PER_S = 3.35e12
SIZE = {"int8": 1, "bf16": 2, "f32": 4}
# the compute type a configuration states -> the peak its mfu is held to
MFU_PEAK = {"bfloat16": PEAK_OPS["bf16"], "float32": PEAK_OPS["f32"]}


def bound_ms(ops: float, nbytes: float, kind: str) -> Tuple[float, str]:
    """(least ms the card could take, which limit binds)."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def folded_bound(n, h, w, c4, c4o, kind, structured=True) -> float:
    """B1 / B2 / B3 at (N, Hf, Wf, 4C -> 4Co): the listed blocks'
    operations (the 36 of 144 a folded kernel has, the unfolded conv's;
    all 144 of a dense one) and the input, the kernel and the output moved
    once."""
    px = n * h * w
    ops = 2 * 9 * px * c4 * c4o // (4 if structured else 1)
    return bound_ms(ops, (px * (c4 + c4o) + 9 * c4 * c4o) * SIZE[kind],
                    kind)[0]


def attention_bound(which: str, n, nq, nk, c, kind) -> float:
    """B6a (forward), B6b (forward with the log-sum-exp rows), B6c (dQ) or
    B6d (dK, dV) at (N, Nq, Nk, C)."""
    size = SIZE[kind]
    qb, kb, rows = n * nq * c * size, n * nk * c * size, n * nq * 4
    work = n * nq * nk * c
    ops, nbytes = {
        "B6a": (4 * work, qb + 2 * kb + qb),
        "B6b": (4 * work, qb + 2 * kb + qb + rows),
        "B6c": (6 * work, 2 * qb + 2 * kb + 2 * rows + qb),
        "B6d": (8 * work, 2 * qb + 2 * kb + 2 * rows + 2 * kb)}[which]
    return bound_ms(ops, nbytes, kind)[0]


def launch_bound_ms(kernel: str, entry: Sequence, batch: int) -> float:
    """The bound of one launch of a configuration's ``kernel_launches``
    entry ``[count, batch multiple, *shape, kind]`` at ``batch``."""
    _, mult, *shape, kind = entry
    n = batch * mult
    if kernel.startswith("B6"):
        return attention_bound(kernel, n, *shape, kind)
    return folded_bound(n, *shape, kind)


def plan_per_call(plan: dict, batch: int):
    """{kernel: (launches a call, summed bound ms a call)} of one call's
    plan (a stylize or a step)."""
    return {k: (sum(e[0] for e in entries),
                sum(e[0] * launch_bound_ms(k, e, batch) for e in entries))
            for k, entries in plan.items()}
