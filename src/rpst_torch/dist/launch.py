"""Start the ranks of a multi-device run on this host.

``train_torch.py`` with a ``mesh_shape`` and ``serve_torch.py --mesh`` start
their own ranks when they are not one already: the parent builds every CUDA
kernel first (so the ranks load the libraries it built and never race the
build directory), then runs the same command once per rank with the rank's
place added (``rank_args``), and waits for all of them. The ranks meet
through a file under a fresh temporary directory (``init_method=file://``),
so concurrent runs never clash on a port. A rank that fails ends the run:
the others are stopped and its exit code is returned. ``torchrun`` (its
environment: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...) and the
``distributed`` config keys start the ranks from outside instead.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

from ..metrics import logger


def in_rank() -> bool:
    """Was this process started as a rank by torchrun?"""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def spawn(argv: List[str], world: int,
          rank_args: Callable[[int, str], List[str]],
          build_kernels: bool = False, timeout: Optional[float] = None
          ) -> int:
    """Run ``python argv + rank_args(rank, init_url)`` for rank 0 .. world-1
    and wait; returns 0, or the first failing rank's exit code (the others
    are then terminated). ``build_kernels``: build every CUDA library first
    (``kernels.build.build_all``)."""
    if build_kernels:
        from ..kernels.build import build_all
        t0 = time.perf_counter()
        build_all()
        logger.info(f"built the CUDA kernels for {world} ranks in "
                    f"{time.perf_counter() - t0:.1f} s")
    tmp = Path(tempfile.mkdtemp(prefix="rpst_ranks_"))
    url = f"file://{tmp / 'init'}"
    procs = [subprocess.Popen([sys.executable, *argv, *rank_args(r, url)])
             for r in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    try:
        pending = list(procs)
        while pending:
            for p in list(pending):
                code = p.poll()
                if code is None:
                    continue
                pending.remove(p)
                if code != 0 and rc == 0:
                    rc = code
                    for q in pending:
                        q.terminate()
            if deadline is not None and time.monotonic() > deadline:
                rc = rc or 124
                for q in pending:
                    q.kill()
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return rc
