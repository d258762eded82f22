"""The numbers that decide ``correct``, and the verdict against the cell's
limits (``cells/<cell>.json``).

Serving, over a seeded sample of the requests completed in the window,
each pair stylized again by the reference from the benchmark's own weights
and images, in float32 and in the configuration's stated compute type
(``Precision``: every product's operands and output and every statistic
rounded to it): ``rel_err``, the widest relative error of a served image
from the float32 reference, ||y - y_ref|| / ||y_ref|| over all its values;
``own_err_pooled``, the reference in the stated type from the float32 one
over the whole sample at once: the error the stated type makes on these
very inputs; ``err_ratio``, the served images' error, pooled alike, in
units of it; and ``err_ratio_max``, the widest such ratio of one image
(its error over the stated type's own on the same image). The ratios are
steady from seed to seed where the errors themselves are not (a seed's
weights set how far rounding carries), so they part the program from a
lower precision where the widest error does not.

Training, over the first three steps of the state the window trains on:

  * ``loss_gap``: the widest |loss - loss_ref| / |loss_ref| of the three,
    and ``loss1_gap`` the first step's alone;
  * ``grad_gap``: the first step's gradient, read from Adam's first moment
    after one step (m = (1 - beta1) g), by the worst leaf: | ||g|| -
    ||g_ref|| | over the larger of ||g_ref|| and the median leaf's;
  * ``change_gap``: the parameters' change after three steps, the same
    measure, leaving out the leaves whose reference gradient is under a
    thousandth of the median leaf's (they move under Adam by round-off
    alone, as a key's bias under a softmax);
  * ``part1_gap``: the first step's loss parts (content, style, identity
    terms, unweighted) by the worst part, each |part - part_ref| /
    |part_ref|: a batch whose images differ moves the parts apart where
    their weighted sum, led by one term, barely moves;
  * ``grad_leaf_err``: the first gradient by the worst leaf, ||g -
    g_ref|| over the larger of ||g_ref|| and the median leaf's: the
    direction, which the norm gaps above do not see;
  * ``change_err``: the parameters' change after three steps, ||d -
    d_ref|| / ||d_ref|| over the moving leaves: its direction (under
    Adam its norm is about lr sqrt(n) whatever the direction);
  * ``grad_err``: the first gradient's relative error over all leaves,
    sqrt(sum ||g - g_ref||^2 / sum ||g_ref||^2): rounding that the norms
    above average away shows here; ``grad_err_own``, the same of the
    reference with its tensors rounded to the configuration's own
    precision (that precision's error on these weights and this batch),
    and ``grad_err_ratio``, the program's in units of it: steady from seed
    to seed where the errors are not (a seed's weights set how far the
    loss's cancellations carry rounding); ``part1_own`` and
    ``part1_ratio``, the same of ``part1_gap``.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# a leaf moves by round-off alone below this share of the median gradient
ROUNDOFF_LEAF = 1e-3


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                 1e-30))


def _sq(a: np.ndarray, b: np.ndarray) -> float:
    """Sum of squared differences, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).sum()) if a.shape == b.shape else float("inf")


def serve_readings(sample: Sequence[Tuple[int, int, np.ndarray]],
                   content: np.ndarray, style: np.ndarray, stylize,
                   stylize_low, device, block: int) -> Dict[str, float]:
    """The serving numbers; ``stylize`` the float32 reference,
    ``stylize_low`` the one in the stated type, run in blocks of
    ``block``."""
    inf = float("inf")
    if not sample:
        return {"rel_err": inf, "own_err_pooled": inf, "err_ratio": inf,
                "err_ratio_max": inf}
    errs, ratios, num, own, den = [], [], 0.0, 0.0, 0.0
    for at in range(0, len(sample), block):
        part = sample[at:at + block]
        c = torch.from_numpy(np.stack([content[i] for i, _, _ in part]))
        s = torch.from_numpy(np.stack([style[j] for _, j, _ in part]))
        c, s = c.to(device), s.to(device)
        with torch.no_grad():
            ref = stylize(c, s).float().cpu().numpy()
            low = stylize_low(c, s).float().cpu().numpy()
        for (_, _, got), r, q in zip(part, ref, low):
            errs.append(rel_err(got, r))
            ratios.append(errs[-1] / max(rel_err(q, r), 1e-30))
            num += _sq(got, r)
            own += _sq(q, r)
            den += float(np.square(r, dtype=np.float64).sum())
    pooled = (num / max(den, 1e-30)) ** 0.5
    own = (own / max(den, 1e-30)) ** 0.5
    return {"rel_err": max(errs), "own_err_pooled": own,
            "err_ratio": pooled / max(own, 1e-30),
            "err_ratio_max": max(ratios)}


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> List[float]:
    """Each leaf's | got - ref | over the larger of its ref and the median
    leaf's ref."""
    med = statistics.median(ref[k] for k in leaves)
    return [abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses", "grad1", "theta0", "theta3"}."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    if not all(np.isfinite(prog["losses"])):
        loss = float("inf")
    g_p, g_r = _norms(prog["grad1"]), _norms(ref["grad1"])
    leaves = sorted(g_r)
    med = statistics.median(g_r[k] for k in leaves)
    moving = [k for k in leaves if g_r[k] >= ROUNDOFF_LEAF * med]
    d_p = _norms({k: prog["theta3"][k] - prog["theta0"][k] for k in moving})
    d_r = _norms({k: ref["theta3"][k] - ref["theta0"][k] for k in moving})
    first = abs(prog["losses"][0] - ref["losses"][0]) / max(
        abs(ref["losses"][0]), 1e-30)

    out = {"loss_gap": loss, "loss1_gap": first,
           "grad_gap": max(leaf_gaps(g_p, g_r, leaves)),
           "change_gap": max(leaf_gaps(d_p, d_r, moving)),
           "grad_leaf_err": max(
               float((prog["grad1"][k].double() - ref["grad1"][k].double())
                     .norm()) / max(g_r[k], med, 1e-30) for k in leaves),
           "change_err": grad_err(
               {k: prog["theta3"][k] - prog["theta0"][k] for k in moving},
               {k: ref["theta3"][k] - ref["theta0"][k] for k in moving}),
           "grad_err": grad_err(prog["grad1"], ref["grad1"])}
    if prog.get("parts1") and ref.get("parts1"):
        out["part1_gap"] = part_gap(prog["parts1"], ref["parts1"])
    return out


def grad_err(got: Dict[str, torch.Tensor],
             ref: Dict[str, torch.Tensor]) -> float:
    diff = sum(float((got[k].double() - ref[k].double()).pow(2).sum())
               for k in ref)
    size = sum(float(ref[k].double().pow(2).sum()) for k in ref)
    return (diff / max(size, 1e-300)) ** 0.5


def part_gap(got: Dict[str, float], ref: Dict[str, float]) -> float:
    """The worst loss part's |got - ref| / |ref| (``total_loss`` aside)."""
    names = sorted((set(got) & set(ref)) - {"total_loss"})
    if not names or not all(np.isfinite(got[k]) for k in names):
        return float("inf")
    return max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30)
               for k in names)


def own_error(got: dict, own: dict, ref: dict) -> Dict[str, float]:
    """The first step in units of the error that the configuration's own
    precision makes on the same weights and batch (``own``: the reference
    rounded to it): ``grad_err_own`` and ``grad_err_ratio`` of the first
    gradient, ``part1_own`` and ``part1_ratio`` of the loss parts."""
    err, base = grad_err(got["grad1"], ref["grad1"]), grad_err(
        own["grad1"], ref["grad1"])
    parts = part_gap(got["parts1"], ref["parts1"])
    parts_own = part_gap(own["parts1"], ref["parts1"])
    return {"grad_err_own": base, "grad_err_ratio": err / max(base, 1e-300),
            "part1_own": parts_own,
            "part1_ratio": parts / max(parts_own, 1e-300)}


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(every compared number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
