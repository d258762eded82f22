"""Device traces of a training run; counterpart of ``rpst.train.profiler``.

  * ``trace(logdir)``  context manager: a trace of the block
  * ``start_trace(logdir)`` / ``stop_trace()``  the span-style pair for
    captures that straddle loop iterations (``train_torch.py``'s
    ``profile_iter`` window)
  * ``annotate(name)``  a named span in the trace
  * ``StepTimer``  steady-state steps per second (``train.metrics``)

A trace is ``torch.profiler.profile`` over the CPU, and over CUDA too when
the device is a card, written into ``logdir`` by
``torch.profiler.tensorboard_trace_handler`` as ``*.pt.trace.json`` (read by
TensorBoard's profiler plugin and by Perfetto; no tensorboard package
needed). Both ends synchronize the device first, so the window holds the
device work of exactly the steps enqueued inside it: CUDA runs further
ahead of the host than XLA, where rpst blocks only at the stop.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

from .metrics import StepTimer

__all__ = ["trace", "start_trace", "stop_trace", "annotate", "StepTimer"]

_running: dict = {}  # "prof": the open profile, "device": its device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start_trace(logdir, device=None) -> None:
    """Start a trace into ``logdir``; ``device`` None means the current
    card where there is one, else the CPU alone."""
    if _running:
        raise RuntimeError("a trace is already running")
    device = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(str(logdir)))
    prof.start()
    _running.update(prof=prof, device=device)


def stop_trace() -> None:
    """Stop the running trace and write it."""
    _sync(_running["device"])
    _running.pop("prof").stop()
    _running.clear()


@contextlib.contextmanager
def trace(logdir, device=None):
    """Capture a trace: ``with trace('out/trace'): step(...)``."""
    start_trace(logdir, device)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    """A named span (shows in the trace's timeline)."""
    return record_function(name)
