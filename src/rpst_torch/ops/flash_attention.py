"""B6: blockwise softmax attention for SANet, forward and backward; port of
``rpst.ops.pallas.flash_attention``.

``softmax(Q K^T) V`` without the 1/sqrt(C) scaling and without a mask (the
reference SANet applies neither), for Q ``(..., Nq, C)`` and K, V ``(...,
Nk, C)``. At 512px the relu4_1 module has Nq = Nk = 4096: the dense matrix
is 67 MB per image and direction, and the kernels never build it.

  * ``flash_fwd`` (B6a): O, the serving forward;
  * ``flash_fwd_lse`` (B6b): O and LSE = log(sum(exp(S))) per query row,
    (N, Nq) float32, the training forward;
  * ``flash_bwd_dq`` (B6c): dQ from (q, k, v, dO, LSE, Delta);
  * ``flash_bwd_dkv`` (B6d): dK and dV from the same;
  * ``FlashAttention``: the autograd Function (rpst's ``custom_vjp``):
    forward B6b, backward Delta = rowsum(dO * O) in PyTorch, then B6c and
    B6d, each skipped when none of its outputs is needed;
  * ``flash_attention`` / ``sanet_attention``: the public functions. With
    no gradient to record they run B6a, otherwise the Function.

All four wrappers run ``csrc/flash_attention.cu`` on CUDA tensors or raise;
a CPU tensor takes the ``*_plain`` version beside each, the same function
with the same casts in plain PyTorch (scores, softmax state and sums in
float32; P and dS rounded to the tensors' type before their second
product), which the CPU tests hold against rpst's kernels in interpret mode
and a float64 numpy oracle. ``<wrapper>.launches`` counts kernel launches
and nothing else; ``launch_counts()`` sums them as B6_fwd / B6_dq / B6_dkv.
The two forward wrappers launch one of two tensor-core kernels by the
tensors' type, each with K and V tiles arriving by ``cp.async`` in a ring
of two: bfloat16 one ``mma.sync`` bf16 product per fragment on 32 query
rows x 64 keys a step; float32 three TF32 products per fragment (each
operand split as hi + lo, as CUTLASS's fast float32 GEMM does, which keeps
float32 accuracy where one TF32 product moves O by 5e-4 of its size) on 32
query rows x 32 keys a step. ``<wrapper>.launches_bf16`` counts the bfloat16
kernel's launches among ``launches``. The two backward wrappers launch one
kernel each, both types on the tensor cores in the same way (bf16 one
product, float32 three, a fragment): a block owns 16 rows (of Q for dQ, of
K for dK/dV) and sweeps the other side in tiles of 32 through a ``cp.async``
ring of two; dK/dV come from one sweep (the score tile is formed once for
both), and no sum uses atomics, so both are bit-equal run to run.

The CUDA kernels mask ragged tiles themselves, so every Nq, Nk >= 1
launches them: rpst's dense route for short or unaligned sequences
(``_eligible``, a TPU sublane rule), its block picker (``_pick_blocks``, a
VMEM budget) and the 128-lane replicated LSE layout have no counterpart.
C must be a multiple of 128, at most 512 (SANet's width), on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .folded_conv import (_ENTRY, _acc, _check_common, _count,
                          _launch_lock)

_LIB = "flash_attention"
_C_UNIT, _C_MAX = 128, 512


def dense_attention(q, k, v):
    """rpst's ``_dense_attention``: the scores in the tensors' type, cast to
    float32 for the softmax; P cast to v's type for the second product."""
    s = torch.einsum("...qc,...kc->...qk", q, k)
    p = torch.softmax(_acc(s), dim=-1)
    return torch.einsum("...qk,...kc->...qc", p.to(v.dtype), v)


def _scores(a, b):
    """a b^T with float32 sums of the exact products (an enclosing autocast
    must not round the operands)."""
    with torch.autocast(a.device.type, enabled=False):
        return _acc(a) @ _acc(b).transpose(-1, -2)


def _second(p, x):
    """p (rounded to x's type) times x, summed in float32."""
    with torch.autocast(x.device.type, enabled=False):
        return _acc(p.to(x.dtype)) @ _acc(x)


def flash_fwd_lse_plain(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6b in plain PyTorch: exp(S - rowmax) rounded to v's type before the
    second product, the float32 row sum taken before the rounding, one
    division at the end, as the kernel has them."""
    s = _scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (_second(p, v) / l).to(q.dtype)
    return o, (m + torch.log(l)).squeeze(-1)


def flash_fwd_plain(q, k, v) -> torch.Tensor:
    """B6a in plain PyTorch."""
    return flash_fwd_lse_plain(q, k, v)[0]


def attention_f64(q, k, v) -> torch.Tensor:
    """softmax(q k^T) v in float64 from the same inputs, on their device:
    the oracle of the float32 forward at large logits."""
    q, k, v = (t.double() for t in (q, k, v))
    return torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v


# The float32 forward's O (three TF32 products a fragment) is checked at
# both ends of the logit scale. At inputs x 1, a tolerance of 1e-4 is ~0.4%
# of max |O| and would pass one TF32 product, so O is also held to its own
# size: max abs err <= F32_O_REL x max |ref|, mean <= F32_O_MEAN_REL x max
# |ref| (a numpy emulation at (1, 1024, 1024, 512) read, against the plain
# version: float32 summed in order 1.2e-6 / 9.8e-8, three TF32 products
# 1.5e-6 / 1.0e-7, one TF32 product 5.3e-4 / 5.7e-5). At x 30 the logits
# reach ~1e3 and any change of summation order moves O by more than 1e-4,
# so O is held to a float64 oracle instead (``f32_oracle_limit``).
F32_O_REL, F32_O_MEAN_REL = 1e-5, 1e-6
F32_ORACLE_X, F32_ORACLE_FLOOR = 3.0, 2.0 ** -20
# (Nq, Nk) one below, at and one above the float32 forward's tiles (32 query
# rows x 32 keys), and into a third key tile: its tile-edge checks
F32_FWD_EDGES = tuple((nq, nk) for nq in (31, 32, 33)
                      for nk in (31, 32, 33)) + ((33, 65),)


def f32_oracle_limit(plain, ref64) -> float:
    """The most the float32 forward's O may lie from the float64 oracle
    ``ref64`` (max abs): F32_ORACLE_X x the float32 plain version's error,
    or x 2^-20 of max |ref64| (eight float32 ulps) where that is more.

    The plain error is set by rows whose two largest logits nearly tie,
    where rounding a score near 1e3 moves P by ~1e-3 in any float32 order;
    a draw without such a row leaves plain copying one V row exactly, and
    the floor then stands for the 22 of V's 24 bits that the split keeps.
    In the emulation three products read 0.05-0.41 of this limit at
    (1, 64, 64, 512), (2, 100, 70, 512) and (1, 1024, 1024, 512) x 30, one
    product 92-406x it."""
    e_plain = (plain.double() - ref64).abs().max().item()
    size = ref64.abs().max().item()
    return F32_ORACLE_X * max(e_plain, F32_ORACLE_FLOOR * size)


def attention_grads_f64(q, k, v, d_o, lse=None, delta=None):
    """(dQ, dK, dV) in float64 from the same inputs, on their device: the
    oracle of the backward kernels. Without ``lse`` and ``delta``, the
    gradients of sum(softmax(q k^T) v * d_o); with them, the backward
    kernels' own function of those rows, P = exp(q k^T - lse) and dS = P *
    (d_o v^T - delta), each product in float64.

    The second is what B6c / B6d are held to at large logits: there a
    score near 1e3 carries ~1e-3 of float32 rounding in any summation order,
    and exp(S - LSE) turns a score that differs from the one LSE was taken
    from into a relative error of P of that size. Given the plain forward's
    LSE, the plain backward forms its scores in the same (cuBLAS's) order
    and the kernels do not, so at x 30 the kernels lie ~1e-3 of their size
    from the plain version (far past 1e-4) while lying closer than it to
    this oracle."""
    q, k, v, d_o = (t.double() for t in (q, k, v, d_o))
    s = q @ k.transpose(-1, -2)
    dp = d_o @ v.transpose(-1, -2)
    if lse is None:
        p = torch.softmax(s, dim=-1)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    else:
        p = torch.exp(s - lse.double().unsqueeze(-1))
        ds = p * (dp - delta.double().unsqueeze(-1))
    return (ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ d_o)


# The float32 backward (three TF32 products a fragment) is held to its own
# size at inputs x 1 as the forward's O is: max abs err <= F32_GRAD_REL x
# max |ref|, mean <= F32_GRAD_MEAN_REL x max |ref|, ref the float64 oracle
# ``attention_grads_f64`` of the kernels' own function. A numpy emulation of
# the kernels' arithmetic (tests/test_torch_flash_attention.py) at (2, 100,
# 70, 512), (1, 1024, 1024, 512) and (1, 64, 64, 512) read for dQ, dK, dV:
# three products at most 4.8e-7 / 3.4e-8 (max / mean), the float32 plain
# version 1.4e-6 / 8e-8, one TF32 product 4.0e-4 to 7.5e-4 / 5.3e-5 to
# 6.9e-5. At x 30 the kernels are held to ``f32_oracle_limit`` against the
# same oracle (three products 0.06-0.24 of it there, one 141-539x). With
# one key, P = 1 and dS = P (dO V^T - Delta) = 0: dQ and dK are then the
# rounding of Delta, with no size of their own, and take no own-size check
# (as a bias gradient that is zero by construction takes no relative one).
F32_GRAD_REL, F32_GRAD_MEAN_REL = 1e-5, 1e-6
# The bfloat16 backward is held to its own size against the plain versions
# as the bfloat16 forward's O is. With entries of std C^-1/4 a gradient
# entry is ~1e-2 to 1e-1, so rtol = atol = 2e-2 alone would pass a kernel
# 30-50% off or one that drops a swept tile. Both versions compute one
# function (P and dS rounded to bfloat16 before their second product) in
# other orders and round each gradient once, so they differ by about one
# bfloat16 ulp at an element (up to 2^-7 of it) where the float sums fall on
# either side of a rounding step: max abs err <= BF16_GRAD_REL x max |plain|
# (two ulps of the largest value), mean <= BF16_GRAD_MEAN_REL x max |plain|.
BF16_GRAD_REL, BF16_GRAD_MEAN_REL = 2e-2, 2e-3
# (Nq, Nk) one below, at and one above the backward kernels' tiles (16 rows
# a block, of Q in B6c and of K in B6d, x 32 swept rows), in both roles,
# and into a third swept tile: their tile-edge checks
BWD_EDGES = ((15, 31), (16, 32), (17, 33), (31, 15), (32, 16), (33, 17),
             (17, 65), (65, 17))


def _p_ds(q, k, v, d_o, lse, delta):
    p = torch.exp(_scores(q, k) - lse.unsqueeze(-1))
    return p, p * (_scores(d_o, v) - delta.unsqueeze(-1))


def flash_bwd_dq_plain(q, k, v, d_o, lse, delta) -> torch.Tensor:
    """B6c in plain PyTorch: dQ = dS K, dS = P * (dO V^T - Delta) rounded to
    k's type, P = exp(S - LSE)."""
    _, ds = _p_ds(q, k, v, d_o, lse, delta)
    return _second(ds, k).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, d_o, lse, delta):
    """B6d in plain PyTorch: dV = P^T dO (P rounded to dO's type) and dK =
    dS^T Q (dS rounded to q's type)."""
    p, ds = _p_ds(q, k, v, d_o, lse, delta)
    dv = _second(p.transpose(-1, -2), d_o).to(v.dtype)
    dk = _second(ds.transpose(-1, -2), q).to(k.dtype)
    return dk, dv


def _check(name, q, k, v, extra=(), rows=()):
    """(N, Nq, Nk, C) of a checked call: q (N, Nq, C), k and v (N, Nk, C),
    ``extra`` tensors of q's shape and type, ``rows`` (N, Nq) float32."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2] \
            or q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError(f"{name}: expected q (N, Nq, C) and k, v (N, Nk, C), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for tname, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tname} must be {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    _check_common(name, (("q", q), ("k", k), ("v", v), *extra), q.dtype,
                  q.device)
    for tname, t in rows:
        if tuple(t.shape) != tuple(q.shape[:2]):
            raise ValueError(f"{name}: {tname} must be {tuple(q.shape[:2])}, "
                             f"got {tuple(t.shape)}")
    if q.device.type == "cuda":  # on the CPU the row vectors follow q (float64)
        _check_common(name, rows, torch.float32, q.device)
        for tname, t in (("q", q), ("k", k), ("v", v), *extra, *rows):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {tname} must be 16-byte aligned "
                                 "(the kernel reads 4 values at a time)")
    n, nq, c = q.shape
    if q.device.type == "cuda" and (c % _C_UNIT or c > _C_MAX or n > 65535):
        raise ValueError(f"{name}: the CUDA kernel takes C a multiple of "
                         f"{_C_UNIT} up to {_C_MAX} and N <= 65535, got "
                         f"{tuple(q.shape)}")
    return n, nq, k.shape[1], c


def _launch(what, fn, dtype, *args):
    from ..kernels.build import launch
    launch(_LIB, f"rpst_flash_{fn}_{_ENTRY[dtype]}", what, *args)


def _count_fwd(wrapper, dtype) -> None:
    """One launch of a forward wrapper; bfloat16 is the tensor-core kernel."""
    _count(wrapper)
    if dtype == torch.bfloat16:
        with _launch_lock:
            wrapper.launches_bf16 += 1


def flash_fwd(q, k, v) -> torch.Tensor:
    """softmax(q k^T) v for q (N, Nq, C), k, v (N, Nk, C), float32 or
    bfloat16, contiguous, on one device; the output has q's type."""
    n, nq, nk, c = _check("flash_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v)
    o = torch.empty_like(q)
    _launch("B6a", "fwd", q.dtype, q, k, v, o, None, n, nq, nk, c)
    _count_fwd(flash_fwd, q.dtype)
    return o


flash_fwd.launches = 0
flash_fwd.launches_bf16 = 0


def flash_fwd_lse(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_fwd`` and the per-row log-sum-exp (N, Nq) float32."""
    n, nq, nk, c = _check("flash_fwd_lse", q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((n, nq), device=q.device, dtype=torch.float32)
    _launch("B6b", "fwd", q.dtype, q, k, v, o, lse, n, nq, nk, c)
    _count_fwd(flash_fwd_lse, q.dtype)
    return o, lse


flash_fwd_lse.launches = 0
flash_fwd_lse.launches_bf16 = 0


def flash_bwd_dq(q, k, v, d_o, lse, delta) -> torch.Tensor:
    """dQ (N, Nq, C) in q's type from d_o (N, Nq, C) of q's type and the
    float32 rows lse, delta (N, Nq)."""
    n, nq, nk, c = _check("flash_bwd_dq", q, k, v, (("d_o", d_o),),
                          (("lse", lse), ("delta", delta)))
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, d_o, lse, delta)
    dq = torch.empty_like(q)
    _launch("B6c", "bwd_dq", q.dtype, q, k, v, d_o, lse, delta, dq, n, nq, nk,
            c)
    _count(flash_bwd_dq)
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, d_o, lse, delta):
    """(dK, dV), each (N, Nk, C) in k's type; deterministic run to run (a
    block owns its K rows and sweeps the Q tiles in order, no atomics), as
    dQ is (a block owns its Q rows)."""
    n, nq, nk, c = _check("flash_bwd_dkv", q, k, v, (("d_o", d_o),),
                          (("lse", lse), ("delta", delta)))
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, d_o, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("B6d", "bwd_dkv", q.dtype, q, k, v, d_o, lse, delta, dk, dv, n, nq,
            nk, c)
    _count(flash_bwd_dkv)
    return dk, dv


flash_bwd_dkv.launches = 0


def backward_readings(q, k, v, d_o, lse, delta, grads, tol, scale=1.0):
    """How the (dQ, dK, dV) ``grads`` of B6c / B6d (or of a variant of them)
    lie from what the card checks hold them to, and whether they pass:

      * float32 at inputs x ``scale`` != 1: from the float64 oracle
        ``attention_grads_f64`` of the same rows, within ``f32_oracle_limit``
        (in place of the plain version, which shares LSE's summation order);
      * else within rtol = atol = ``tol`` of the plain versions, and within
        their own size: float32 from the float64 oracle by F32_GRAD_REL /
        F32_GRAD_MEAN_REL, bfloat16 from the plain versions by BF16_GRAD_REL
        / BF16_GRAD_MEAN_REL; with one key dQ and dK are zero and take no
        own-size check.

    Returns {"dq" | "dk" | "dv": reading}, a reading a dict of ``ok``,
    ``plain`` (max abs err from the plain version, or None), ``oracle`` and
    ``limit`` (float32 at x != 1), and where taken ``own`` ((max, mean) abs
    err over max |ref|) and ``own_limits``."""
    f32 = q.dtype == torch.float32
    plain = dict(zip(("dq", "dk", "dv"),
                     (flash_bwd_dq_plain(q, k, v, d_o, lse, delta),
                      *flash_bwd_dkv_plain(q, k, v, d_o, lse, delta))))
    ref64 = dict(zip(plain, attention_grads_f64(q, k, v, d_o, lse, delta))
                 ) if f32 else {}
    readings = {}
    for name, got in zip(plain, grads):
        r = {"plain": None}
        ok = (got.shape == plain[name].shape and got.dtype == q.dtype
              and bool(torch.isfinite(got).all()))
        if f32 and scale != 1.0:
            r["limit"] = f32_oracle_limit(plain[name], ref64[name])
            r["oracle"] = (got.double() - ref64[name]).abs().max().item()
            ok = ok and r["oracle"] <= r["limit"]
        else:
            r["plain"] = (got.float() - plain[name].float()).abs().max().item()
            ok = ok and torch.allclose(got.float(), plain[name].float(),
                                       rtol=tol, atol=tol)
            if name == "dv" or k.shape[1] > 1:
                ref, r["own_limits"] = (
                    (ref64[name], (F32_GRAD_REL, F32_GRAD_MEAN_REL)) if f32
                    else (plain[name].double(),
                          (BF16_GRAD_REL, BF16_GRAD_MEAN_REL)))
                err = (got.double() - ref).abs()
                size = ref.abs().max().item() or 1.0
                r["own"] = (err.max().item() / size, err.mean().item() / size)
                ok = ok and all(e <= lim for e, lim in
                                zip(r["own"], r["own_limits"]))
        r["ok"] = bool(ok)
        readings[name] = r
    return readings


def describe_backward(readings) -> str:
    """``backward_readings``' numbers on one line."""
    parts = []
    for name, r in readings.items():
        if r["plain"] is None:
            text = (f"{name} from the float64 oracle {r['oracle']:.3g} "
                    f"(limit {r['limit']:.3g})")
        else:
            text = f"{name} {r['plain']:.3g}"
        if "own" in r:
            text += (f" (own size {r['own'][0]:.3g} / {r['own'][1]:.3g}, "
                     f"limits {r['own_limits'][0]:g} / "
                     f"{r['own_limits'][1]:g})")
        parts.append(text + ("" if r["ok"] else " OUT OF LIMITS"))
    return ", ".join(parts)


def check_backward(q, k, v, d_o, lse, delta, tol, scale=1.0):
    """B6c and B6d, each run twice, under ``backward_readings``: raises
    AssertionError unless dQ, dK and dV pass and are bit-equal across the
    two runs; returns the readings."""
    dq = flash_bwd_dq(q, k, v, d_o, lse, delta)
    dq2 = flash_bwd_dq(q, k, v, d_o, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, d_o, lse, delta)
    dk2, dv2 = flash_bwd_dkv(q, k, v, d_o, lse, delta)
    readings = backward_readings(q, k, v, d_o, lse, delta, (dq, dk, dv), tol,
                                 scale)
    bad = [name for name, r in readings.items() if not r["ok"]]
    if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
            and torch.equal(dv, dv2)):
        bad.append("bit-equality across two runs")
    if bad:
        raise AssertionError(f"B6c / B6d {tuple(q.shape)}, {tuple(k.shape)} "
                             f"x{scale:g}: {', '.join(bad)} failed (tol "
                             f"{tol}): {describe_backward(readings)}")
    return readings


def launch_counts() -> Dict[str, int]:
    """The B6 launches so far: forward (with and without LSE), dQ, dK/dV."""
    return {"B6_fwd": flash_fwd.launches + flash_fwd_lse.launches,
            "B6_dq": flash_bwd_dq.launches,
            "B6_dkv": flash_bwd_dkv.launches}


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T) v on (N, Nq, C) / (N, Nk, C) tensors with the blockwise
    backward: neither pass holds an (Nq, Nk) matrix."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd_lse(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        # the softmax backward's correction term, outside the kernels as in
        # rpst
        delta = (_acc(g) * _acc(o)).sum(dim=-1)
        g = g.to(q.dtype).contiguous()
        need_q, need_k, need_v = ctx.needs_input_grad
        dq = flash_bwd_dq(q, k, v, g, lse, delta) if need_q else None
        dk = dv = None
        if need_k or need_v:
            dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta)
        return dq, dk if need_k else None, dv if need_v else None


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v, blockwise: q (..., Nq, C), k, v (..., Nk, C) of one
    type on one device -> (..., Nq, C) in q's type. Unscaled, unmasked.
    Differentiable in all three; without a gradient to record it runs the
    forward kernel that writes no LSE."""
    if q.ndim < 2 or k.shape != v.shape or q.shape[:-2] != k.shape[:-2]:
        raise ValueError(f"flash_attention: expected q (..., Nq, C) and k, v "
                         f"(..., Nk, C), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    q3, k3, v3 = (t.reshape(-1, *t.shape[-2:]).contiguous()
                  for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o = FlashAttention.apply(q3, k3, v3)
    else:
        o = flash_fwd(q3, k3, v3)
    return o.reshape(q.shape)


def sanet_attention(F: torch.Tensor, G: torch.Tensor,
                    H: torch.Tensor) -> torch.Tensor:
    """SANet's core: O[p] = sum_q softmax_q(F G^T)[p, q] H[q]. F (N, HWc,
    C) queries; G, H (N, HWs, C) keys and values; returns (N, HWc, C)."""
    return flash_attention(F, G, H)
