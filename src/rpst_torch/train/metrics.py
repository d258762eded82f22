"""Training metrics; port of ``rpst.train.metrics.MetricWriter`` and
``rpst.train.profiler.StepTimer``.

``MetricWriter`` appends one JSON line per logged step to
``<output>/logs/metrics.jsonl``, in the format of rpst's runs
(``docs/convergence/flagship/metrics.jsonl``: ``step``, ``time``, then the
scalars by name), so that the two curves compare line by line. TensorBoard
is left out.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import torch


class MetricWriter:
    def __init__(self, output_dir):
        self.log_dir = Path(output_dir) / "logs"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.log_dir / "metrics.jsonl", "a", buffering=1)

    def write(self, step: int, scalars: dict) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(scalars[k]) for k in sorted(scalars)})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


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
