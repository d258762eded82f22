"""The adaptive re-weighted attention of ``dynamic_sanet``; port of
``rpst.ops.adaptive_attention`` (reference ``network/sanet.py:26-71,
100-138``).

    O[p] = sum_q w(P[p, q], c_p) H[q],   P = softmax_q(F G^T)

with a per-query threshold c_p: ``aea`` weighs by sigmoid(scale (P - c)),
``aea_lrelu`` by softmax_q(relu(P - c)). Both need the row's normalized P,
so the row's log-sum-exp must be known before the first weight: a two-pass
function, which B6 (one pass, online softmax) does not compute. rpst has no
Pallas kernel here (a ``lax.scan`` that XLA compiles), so the port runs it as
plain PyTorch, as the north star says for code XLA generates.

Two routes, one function:

  * ``adaptive_attention_dense`` materializes the (HWc, HWs) score matrix
    (67 MB per image at 512px relu4_1 in float32), the parity route that
    also returns the claim maps;
  * ``adaptive_reweighted_attention`` streams query blocks of ``block_q``
    rows: one (BQ, HWs) score slab at a time. Under autograd each block runs
    in ``torch.utils.checkpoint``, so the backward recomputes the slab
    instead of keeping every block's: training memory stays O(BQ HWs), as
    rpst's ``jax.checkpoint`` keeps it.

Scores, the softmax and the weights are float32 whatever the inputs' type
(an enclosing autocast is left); the weights are rounded to H's type for the
value product, which sums in float32, and O is returned in H's type, as rpst
computes it (``preferred_element_type=float32``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

VARIANTS = ("aea", "aea_lrelu")


def _check(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown adaptive attention variant {variant!r}")


def reweight(prob: torch.Tensor, clamp: torch.Tensor, variant: str,
             scale_value: float = 50.0) -> torch.Tensor:
    """The dense weights w(P, c) of (N, HWc, HWs) probabilities and (N, HWc,
    1) thresholds (the reference's AEA modules, ``sanet.py:44-46, 68-70``)."""
    _check(variant)
    if variant == "aea":
        return torch.sigmoid(scale_value * (prob - clamp))
    # relu(P - c) <= 1, so exp needs no max-subtraction
    e = torch.exp(torch.relu(prob - clamp))
    return e / e.sum(dim=-1, keepdim=True)


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """exp(s - logsumexp(s)) over the last axis: both routes' P, the same
    float32 rounding row by row."""
    return torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))


def _scores(f, g):
    """float32 F G^T of (N, P, C) and (N, Q, C): products of the inputs'
    values, summed in float32."""
    return torch.matmul(f.float(), g.float().transpose(1, 2))


def _value(w, h, dtype):
    """w rounded to ``dtype`` (H's type), times H, summed in float32."""
    return torch.matmul(w.to(dtype).float(), h)


def adaptive_attention_dense(F, G, H, clamp, variant: str = "aea",
                             scale_value: float = 50.0):
    """(O, P, W): O in H's type, the softmax P and the weights W (N, HWc,
    HWs) in float32. F: (N, HWc, C); G, H: (N, HWs, C); clamp: (N, HWc,
    1)."""
    _check(variant)
    with torch.autocast(F.device.type, enabled=False):
        prob = _softmax(_scores(F, G))
        w = reweight(prob, clamp.float(), variant, scale_value)
        return _value(w, H.float(), H.dtype).to(H.dtype), prob, w


def _block(fb, g, h, cl, variant: str, scale_value: float, dtype):
    prob = _softmax(_scores(fb, g))                        # (N, BQ, HWs)
    if variant == "aea":
        return _value(torch.sigmoid(scale_value * (prob - cl)), h, dtype)
    e = torch.exp(torch.relu(prob - cl))
    return _value(e, h, dtype) / e.sum(dim=-1, keepdim=True)


def adaptive_reweighted_attention(F, G, H, clamp, variant: str = "aea",
                                  scale_value: float = 50.0,
                                  block_q: int = 512) -> torch.Tensor:
    """O[p] = sum_q w(softmax_q(F G^T)[p, q], c_p) H[q], streamed over
    query blocks of ``block_q`` rows (the last one ragged). F: (N, HWc, C);
    G, H: (N, HWs, C); clamp: (N, HWc, 1). Returns (N, HWc, C) in H's
    type."""
    _check(variant)
    if block_q < 1:
        raise ValueError(f"block_q must be >= 1, got {block_q}")
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (F, G, H, clamp))
    with torch.autocast(F.device.type, enabled=False):
        g, h, cl = G.float(), H.float(), clamp.float()
        out = []
        for i in range(0, F.shape[1], block_q):
            args = (F[:, i:i + block_q], g, h, cl[:, i:i + block_q],
                    variant, scale_value, H.dtype)
            out.append(checkpoint(_block, *args, use_reentrant=False)
                       if grad else _block(*args))
        return torch.cat(out, dim=1).to(H.dtype)
