"""Training metrics; port of ``rpst.train.metrics.MetricWriter`` and
``rpst.train.profiler.StepTimer``.

``MetricWriter`` appends one JSON line per logged step to
``<output>/logs/metrics.jsonl``, in the format of rpst's runs
(``docs/convergence/flagship/metrics.jsonl``: ``step``, ``time``, then the
scalars by name), so that the two curves compare line by line, and writes
the same scalars as TensorBoard event files (``events.out.tfevents.*``)
beside it where ``torch.utils.tensorboard`` imports, as rpst's does.
"""

from __future__ import annotations

import json
import sys
import time
import types
from pathlib import Path
from typing import Optional

import torch

from ..metrics import logger


def _summary_writer(log_dir: Path):
    """``torch.utils.tensorboard.SummaryWriter`` on ``log_dir``, or the
    reason it did not import. The writer needs nothing of TensorFlow:
    tensorboard's own switch (the module ``tensorboard.compat.notf`` of its
    ``no_tensorflow`` target) keeps it on its stub, where an installed
    TensorFlow would otherwise be imported (seconds of start-up, and it
    may claim the card's memory)."""
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as err:
        return None, str(err)
    return SummaryWriter(log_dir=str(log_dir)), ""


class MetricWriter:
    """JSONL scalars, and TensorBoard event files beside them (one
    ``add_scalar`` per key, rpst's) when ``tensorboard`` is set and
    ``torch.utils.tensorboard`` imports; it logs once which it writes."""

    def __init__(self, output_dir, tensorboard: bool = True):
        self.log_dir = Path(output_dir) / "logs"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.log_dir / "metrics.jsonl", "a", buffering=1)
        self._tb, why = (_summary_writer(self.log_dir) if tensorboard
                         else (None, "tensorboard=False"))
        logger.info(f"metrics: {self.log_dir / 'metrics.jsonl'}"
                    + (" and TensorBoard event files" if self._tb is not None
                       else f", no TensorBoard event files ({why})"))

    def write(self, step: int, scalars: dict) -> None:
        values = {k: float(scalars[k]) for k in sorted(scalars)}
        rec = {"step": int(step), "time": time.time(), **values}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Steady-state steps per second. ``tick()`` once per step; every
    ``sync_every`` steps it waits for the device (CUDA runs ahead of the
    host) and updates ``steps_per_sec`` over that window. The first tick
    only starts the clock, so compile and warm-up stay out."""

    def __init__(self, sync_every: int = 50,
                 device: Optional[torch.device] = None):
        self.sync_every = sync_every
        self.device = torch.device(device or "cpu")
        self._count = 0
        self._t0: Optional[float] = None
        self.steps_per_sec = float("nan")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self) -> None:
        self._count += 1
        if self._t0 is None:
            self._sync()
            self._t0 = time.perf_counter()
            self._count = 0
            return
        if self._count % self.sync_every == 0:
            self._sync()
            now = time.perf_counter()
            self.steps_per_sec = self.sync_every / (now - self._t0)
            self._t0 = now
