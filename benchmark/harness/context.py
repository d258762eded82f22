"""What a runner is given and what it hands back."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Ctx:
    config_name: str
    config: Dict[str, Any]       # configs/<config>.json
    traffic: Dict[str, Any]      # traffic/<mix>.json
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float               # the process's start on the host clock
    reference: Any               # the configuration's reference module
    overrides: Dict[str, Any] = field(default_factory=dict)  # tests only
    fault: Optional[str] = None  # tests only (``faults``)
    control: bool = False        # the configuration's lower precision
    marks: List[Tuple[str, float]] = field(default_factory=list)

    def mark(self, phase: str):
        """The end of a set-up phase, on the host clock."""
        self.marks.append((phase, time.perf_counter()))

    def setup_phases(self, t0: float) -> List[Tuple[str, float]]:
        """Each set-up phase's seconds, from the process's start to the
        window's (``t0``), the last one ``warmup``."""
        out, last = [], self.t_start
        for phase, t in self.marks + [("warmup", t0)]:
            out.append((phase, t - last))
            last = t
        return out


@dataclass
class Result:
    end_to_end: Dict[str, float]
    readings: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    run: Any                     # what the per-layer readers read
    trace: Optional[dict] = None
