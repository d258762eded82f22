"""The training runner: ``train.step.train_step`` with Adam at the mix's
batch, fed as ``train_torch.py`` feeds it (host arrays,
``torch.from_numpy(...).to(device)``), TF32 off as ``train_torch.py`` sets
it.

Set-up builds one training state from the seeded weights and drives it
through its first three steps by the window's own call and feed, on rows
that all differ: step k takes the content pool's images k b .. k b + b - 1
(in turn, wrapping at the pool) and styles drawn uniformly. From them it
keeps each step's loss, the first gradient (Adam's first moment after one
step over 1 - beta1) and the parameters after the third step, and the
first step's loss parts. The same state then trains through the window; ``train_img_per_s`` is the images of
every step in it over its seconds, the window ending on a
``torch.cuda.synchronize()``. After the window the reference runs the
first three steps again from the same weights and batches.

With ``control`` the configuration's lower precision takes the program's
place: the reference in float8 (``fp8``), run through the same three
steps and judged by the same numbers.
"""

from __future__ import annotations

import gc
import time

import torch

from . import check, faults, inputs, program
from .context import Ctx, Result
from .serve import TRACE_MAX_S, TRACE_START_SHARE, _sync
from .trace import Tracer

CHECK_STEPS = 3
STYLE_DRAWS = 1 << 16


def _feeder(tr, content, style, seed, device):
    b, nc = int(tr["batch_size"]), len(content)
    draws = inputs.style_draws(seed, STYLE_DRAWS, len(style))

    def host(k):
        rows = [(k * b + j) % nc for j in range(b)]
        cols = [int(draws[(k * b + j) % len(draws)]) for j in range(b)]
        return content[rows], style[cols]

    def feed(k):
        c, s = host(k)
        return (torch.from_numpy(c).to(device),
                torch.from_numpy(s).to(device))
    return feed


def run(ctx: Ctx) -> Result:
    from rpst_torch.train.step import create_train_state, train_step
    tr, dev = ctx.traffic, ctx.device
    ctx.mark("import")
    control = ctx.config["control"]["train"] if ctx.control else None
    cfg = program.settings(ctx.config, tr, ctx.overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    content, style = inputs.pools(tr, cfg["img_size"], ctx.seed, dev)
    feed = _feeder(tr, content, style, ctx.seed, dev)
    ctx.mark("inputs")
    prog = program.build(ctx.config, cfg, ctx.seed, dev, with_vgg=True)
    state = create_train_state(prog.bundle)
    ctx.mark("program")
    step = faults.train(train_step, ctx.fault) if ctx.fault else train_step
    names = [k for k, p in state.model.named_parameters() if p.requires_grad]
    beta1 = state.optimizer.param_groups[0]["betas"][0]

    losses, skipped, grad1, parts1 = [], 0, None, None
    for k in range(CHECK_STEPS):
        parts = step(state, prog.vgg, *feed(k))
        losses.append(float(parts["total_loss"]))
        skipped += int(float(parts["skipped"]))
        if k == 0:
            parts1 = {n: float(v) for n, v in parts.items()
                      if n != "skipped"}
            params = dict(state.model.named_parameters())
            grad1 = {n: state.optimizer.state[params[n]]["exp_avg"].detach()
                     .clone() / (1.0 - beta1) for n in names}
    theta3 = {n: p.detach().clone()
              for n, p in state.model.named_parameters() if n in names}
    ctx.mark("check_steps")
    tracer = Tracer() if ctx.trace else None
    if tracer:
        tracer.warm(lambda: (torch.ones(8, device=dev) + 1, _sync(dev)))
    _sync(dev)
    cuda = torch.device(dev).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    ta = t0 + TRACE_START_SHARE * ctx.seconds
    tb = ta + min(TRACE_MAX_S, TRACE_START_SHARE * ctx.seconds)
    steps = failed = 0
    k, phase, calls, counters = CHECK_STEPS, 0, None, None
    while True:
        now = time.perf_counter()
        if now >= t0 + ctx.seconds:
            break
        if tracer and phase == 0 and now >= ta:
            _sync(dev)
            c0, s0, phase = program.launch_counters(), steps, 1
            tracer.start()
        elif tracer and phase == 1 and now >= tb:
            _sync(dev)
            tracer.stop_recording()
            counters = program.delta(program.launch_counters(), c0)
            calls, phase = steps - s0, 2
        parts = step(state, prog.vgg, *feed(k))
        failed += int(float(parts["skipped"]))
        k += 1
        steps += 1
    _sync(dev)
    t1 = time.perf_counter()
    if tracer and phase == 1:
        tracer.stop_recording()
        counters = program.delta(program.launch_counters(), c0)
        calls = steps - s0
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = tracer.summary() if tracer and phase else None

    b = int(tr["batch_size"])
    e2e = {"train_img_per_s": steps * b / (t1 - t0),
           "setup_s": t0 - ctx.t_start}
    weights, vgg = prog.weights, prog.vgg_weights
    prog_side = {"losses": losses, "grad1": grad1, "theta3": theta3,
                 "theta0": {n: weights[n] for n in names}, "parts1": parts1}
    del state, prog, parts
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    batches = [feed(j) for j in range(CHECK_STEPS)]
    ref = ctx.reference.build(cfg, weights, vgg)
    lr, decay = float(cfg["lr"]), float(cfg["lr_decay"])
    trained = {n: weights[n] for n in names}
    ref_side = _adam(ref, trained, batches, lr, decay)
    if control:   # the reference in a lower precision in the program's place
        low = ctx.reference.build(cfg, weights, vgg, precision=control)
        prog_side = _adam(low, trained, batches, lr, decay)
    readings = check.train_readings(prog_side, ref_side)
    # the error of the configuration's own precision on these weights and
    # this batch: the reference's first gradient rounded to it
    own = ctx.reference.build(cfg, weights, vgg,
                              precision=ctx.config["own_precision"])
    readings.update(check.own_error(
        prog_side, _adam(own, trained, batches[:1], lr, decay), ref_side))
    if skipped:   # a check step the program skipped fails every number
        readings = {k: float("inf") for k in readings}
    run_record = dict(kind="train", batch=b, window_s=t1 - t0,
                      images=steps * b, steps=steps, config=ctx.config,
                      trace=summary, trace_calls=calls, counters=counters,
                      peak_mem_window=window_peak,
                      setup_phases=ctx.setup_phases(t0),
                      check_losses=(prog_side["losses"], ref_side["losses"]))
    return Result(end_to_end=e2e, readings=readings, attempted=steps,
                  failed=failed,
                  memory_peak_bytes=int(max(setup_peak, window_peak)),
                  run=run_record, trace=summary)


def _adam(ref, params, batches, lr, decay) -> dict:
    """The reference's Adam steps as ``check.train_readings`` takes a
    side."""
    from common import adam_steps
    losses, grad1, theta, parts1 = adam_steps(params, ref.loss, batches, lr,
                                              decay)
    return {"losses": losses, "grad1": grad1, "theta3": theta,
            "theta0": params, "parts1": parts1}
