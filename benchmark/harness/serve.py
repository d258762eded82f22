"""The serving runner: closed-loop clients on the port's
``DynamicBatcher`` over ``serving.make_run_impl``.

Each client submits one request and waits for its image before sending the
next (a callback on its Future: no thread a client). Request i (numbered in the order clients take them) carries the
content pool's image i mod pool and the style ``inputs.style_draws``
gives it. One request in ``keep_one_in``, picked by a hash of the seed and
i (so that the kept ones fall on every content image and batch
position), keeps a copy of its image; after the window a seeded sample of
the kept requests that completed in it is stylized again by the
reference.

Set-up (in ``setup_s``): the pools, the seeded weights, the batcher and
its clients, and ``warmup_batches`` full batches. The window then runs
``seconds`` on the host clock; ``serve_img_per_s`` counts the requests
completed inside it, ``serve_p95_ms`` is the 95th percentile of their
times from ``submit`` to the Future's result.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time

import numpy as np
import torch

from . import check, faults, inputs, program, stats
from .context import Ctx, Result
from .trace import Tracer

WARMUP_TIMEOUT_S = 1000.0
RESULT_TIMEOUT_S = 120.0
TRACE_START_SHARE = 0.25
TRACE_MAX_S = 4.0
CHECK = 6                       # the host stream of the check's sample
STYLE_DRAWS = 1 << 20


class ClosedLoop:
    """``clients`` closed-loop clients: each keeps one request in flight
    and sends its next when its Future resolves. A client is a callback on
    its Future, not a thread of its own, so the harness adds no threads
    that contend with the batcher's for the interpreter."""

    def __init__(self, batcher, content, style, draws, clients, keep_one_in,
                 salt):
        self.batcher, self.content, self.style = batcher, content, style
        self.draws, self.keep, self.salt = draws, keep_one_in, salt
        self.clients = clients
        self.records = []            # (i, submitted, done, ok)
        self.kept = {}               # i -> its image
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._in_flight = 0
        self._drained = threading.Event()

    def _send(self):
        i = next(self._seq)
        c = self.content[i % len(self.content)]
        s = self.style[self.draws[i % len(self.draws)]]
        with self._lock:
            self._in_flight += 1
        t = time.perf_counter()
        self.batcher.submit(c, s).add_done_callback(
            lambda fut: self._done(fut, i, t))

    def _done(self, fut, i, t):
        done = time.perf_counter()
        ok = fut.exception() is None  # a failed request counts as failed
        self.records.append((i, t, done, ok))
        if ok and mix64(i ^ self.salt) % self.keep == 0:
            self.kept[i] = np.array(fut.result(), np.float32)
        with self._lock:
            self._in_flight -= 1
            last = self._in_flight == 0
        if not self._stop.is_set():
            self._send()
        elif last:
            self._drained.set()

    def start(self):
        for _ in range(self.clients):
            self._send()

    def stop(self):
        """No client sends again; wait for the requests in flight."""
        self._stop.set()
        with self._lock:
            if self._in_flight == 0:
                self._drained.set()
        if not self._drained.wait(RESULT_TIMEOUT_S):
            raise RuntimeError("requests in flight did not complete")


def mix64(x: int) -> int:
    """splitmix64's finalizer: a well-spread 64-bit hash of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _sleep_until(t: float):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx: Ctx) -> Result:
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl)
    tr, dev = ctx.traffic, ctx.device
    ctx.mark("import")
    cfg = program.settings(ctx.config, tr, ctx.overrides)
    content, style = inputs.pools(tr, cfg["img_size"], ctx.seed, dev)
    draws = inputs.style_draws(ctx.seed, STYLE_DRAWS, len(style))
    ctx.mark("inputs")
    control = ctx.config["control"]["serve"] if ctx.control else None
    prog = program.build(ctx.config, cfg, ctx.seed, dev,
                         with_vgg=control not in (None, "program_q8"))
    ctx.mark("program")
    b = int(tr["batch_size"])
    if control == "program_q8":   # the program's own int8 path, calibrated
        calib = torch.from_numpy(content[:b]).to(dev)
        st = torch.from_numpy(style[:1]).to(dev).expand_as(calib)
        run_impl = make_run_impl(prog.bundle, "q8", calibrate_scales(
            prog.bundle, calib, st.contiguous()))
    elif control:   # the reference in a lower precision in its place
        run_impl = _reference_impl(ctx, cfg, prog, control)
    else:
        run_impl = make_run_impl(prog.bundle, ctx.config["serve_mode"])
    if ctx.fault:
        run_impl = faults.serve(run_impl, ctx.fault)
    batcher = DynamicBatcher(run_impl, batch_size=b,
                             max_wait_ms=float(tr["max_wait_ms"]), device=dev)
    keep = int(tr["keep_one_in"])
    loop = ClosedLoop(batcher, content, style, draws, int(tr["clients"]),
                      keep, int(inputs.rng(ctx.seed, CHECK).integers(2 ** 62)))
    tracer = Tracer() if ctx.trace else None
    ctx.mark("serving")
    try:
        loop.start()
        deadline = time.perf_counter() + WARMUP_TIMEOUT_S
        while batcher.stats()["batches"] < int(tr["warmup_batches"]):
            if time.perf_counter() > deadline:
                raise RuntimeError("warm-up batches did not complete")
            time.sleep(0.01)
        if tracer:
            tracer.warm(lambda: (torch.ones(8, device=dev) + 1, _sync(dev)))
        t0 = time.perf_counter()
        s0 = batcher.stats()
        t1 = t0 + ctx.seconds
        summary, counters, calls = None, None, None
        if tracer:
            ta = t0 + TRACE_START_SHARE * ctx.seconds
            _sleep_until(ta)
            c0, b0 = program.launch_counters(), batcher.stats()["batches"]
            tracer.start()
            _sleep_until(ta + min(TRACE_MAX_S, TRACE_START_SHARE
                                  * ctx.seconds))
            tracer.stop_recording()
            counters = program.delta(program.launch_counters(), c0)
            calls = batcher.stats()["batches"] - b0
        _sleep_until(t1)
        loop.stop()
        s1 = batcher.stats()
    finally:
        batcher.close()
    peak = (torch.cuda.max_memory_allocated(dev)
            if torch.device(dev).type == "cuda" else 0)
    if tracer:
        summary = tracer.summary()

    done = [r for r in loop.records if stats.in_window(r[2], t0, t1)]
    ok = [r for r in done if r[3]]
    lat_ms = [(r[2] - r[1]) * 1e3 for r in ok]
    e2e = {"serve_img_per_s": stats.rate(len(ok), t1 - t0),
           "serve_p95_ms": (stats.percentile(lat_ms, 95) if lat_ms
                            else float("inf")),
           "setup_s": t0 - ctx.t_start}
    served = s1["served"] - s0["served"]
    batches = s1["batches"] - s0["batches"]

    ok_ids = sorted(r[0] for r in ok if r[0] in loop.kept)
    n = min(int(tr["check_sample"]), len(ok_ids))
    picked = (inputs.rng(ctx.seed, CHECK).choice(ok_ids, n, replace=False)
              if n else [])
    sample = [(i % len(content), int(draws[i % len(draws)]), loop.kept[i])
              for i in sorted(int(i) for i in picked)]
    weights, vgg = prog.weights, prog.vgg_weights
    del prog, run_impl, batcher, loop
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ref, low = _references(ctx, cfg, weights, vgg)
    with tf32_off():
        readings = check.serve_readings(sample, content, style, ref.stylize,
                                        low.stylize, dev,
                                        int(tr["check_batch"]))
    run_record = dict(kind="serve", batch=b, window_s=t1 - t0,
                      images=len(ok), config=ctx.config,
                      p95_ms=e2e["serve_p95_ms"] if lat_ms else None,
                      batcher={"served": served, "batches": batches,
                               "p50_batch_ms": s1["p50_batch_ms"]},
                      trace=summary, trace_calls=calls, counters=counters,
                      setup_phases=ctx.setup_phases(t0))
    return Result(end_to_end=e2e, readings=readings, attempted=len(done),
                  failed=len(done) - len(ok), memory_peak_bytes=int(peak),
                  run=run_record, trace=summary)


def _reference_impl(ctx: Ctx, cfg: dict, prog, precision: str):
    """The reference rounded to ``precision``, serving as the program
    would (the control of a configuration whose program has no lower
    path of its own)."""
    low = ctx.reference.build(cfg, prog.weights, prog.vgg_weights,
                              precision=precision)

    def run(content, style):
        with torch.no_grad(), tf32_off():
            return low.stylize(content.float(), style.float())
    return run


def _references(ctx: Ctx, cfg: dict, weights, vgg):
    """The configuration's reference in float32, and rounded to its
    ``own_precision``, the unit of its checks; they run with TF32 off
    (``tf32_off``)."""
    return (ctx.reference.build(cfg, weights, vgg),
            ctx.reference.build(cfg, weights, vgg,
                                precision=ctx.config["own_precision"]))


@contextlib.contextmanager
def tf32_off():
    """TF32 off for the reference, and the program's own settings back
    after it (a process that serves again, as the readings tool's, serves
    as a fresh one would: with PyTorch's defaults)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
