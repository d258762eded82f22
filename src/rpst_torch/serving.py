"""Serving: execution-mode resolution, calibration, the dynamic batcher and
the line-JSON TCP daemon; port of ``rpst.serving`` on PyTorch.

  * ``resolve_mode`` / ``calibrate_scales`` / ``make_run_impl`` pick the
    execution path (q8, folded or standard), calibrate the int8 path's
    scales, and build ``run(content, style) -> stylized``, shared by the
    folder sweep (``serve_torch.py``) and the daemon;
  * ``DynamicBatcher`` coalesces concurrent single-image requests into
    fixed-shape device batches: the first request opens a ``max_wait_ms``
    window, and the batch dispatches when full or when the window closes,
    padded to the batch size. Launches are asynchronous on CUDA; the
    flusher thread's ``.cpu()`` is the synchronisation point;
  * ``serve_daemon`` is the TCP loop, same protocol as rpst's.

Protocol (one JSON object per line, localhost TCP):

  request   {"id": "r1", "content": "/path/c.png", "style": "/path/s.png"}
  reply     {"id": "r1", "ok": true, "out": "<out_dir>/r1-000000.png", "ms": 12.3}
  stats     {"cmd": "stats"}  ->  {"served": N, "batches": M, ...}
  shutdown  {"cmd": "shutdown"}

rpst's TPU crossover policy (``rpst.policy``) does not apply; ``auto``
resolves by the port's own H100 measurements (``rpst_torch.policy``,
PERF.md section 6).
"""

from __future__ import annotations

import itertools
import json
import re
import socketserver
import threading
import time
from collections import deque
from concurrent.futures import Future
from pathlib import Path
from queue import Empty, Queue
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .data import load_image
from .metrics import logger, save_image
from .policy import AUTO_MODE


def resolve_mode(bundle, mode: str, batch: Optional[int] = None) -> str:
    """Resolve ``--mode`` (q8 | folded | standard | auto) against the
    bundle's coverage. ``auto`` takes q8 at the batches where the H100
    measured it fastest (``bundle.q8_recommended``), on a CUDA device only
    (on the CPU the int8 kernels run their float64 plain versions), and
    otherwise ``policy.AUTO_MODE``. A mode the config does not cover falls
    back to standard with a warning (a config fallback, as in rpst)."""
    if mode == "auto":
        mode = ("q8" if bundle.device.type == "cuda"
                and bundle.q8_recommended(batch) else AUTO_MODE)
        logger.info(f"--mode auto resolved to {mode}"
                    + (f" (batch {batch})" if batch else ""))
    if mode not in ("q8", "folded", "standard"):
        raise ValueError(f"unknown --mode {mode!r}")
    covered = {"q8": bundle.q8_infer, "folded": bundle.folded_infer,
               "standard": lambda: True}[mode]()
    if not covered:
        logger.warning(f"--mode {mode} is unsupported for this network/"
                       "config; falling back to standard")
        mode = "standard"
    return mode


def calibrate_scales(bundle, calib: torch.Tensor,
                     calib_style: torch.Tensor) -> Dict[str, Any]:
    """One-shot PTQ calibration for ``mode='q8'`` on a representative
    batch: {'act_scales': (L,) float32}, by the network's calibrator
    (``bundle.calibrate_q8``; adain and wct cap the batch at 2 images, whose
    512-channel full-resolution activations a larger batch would hold all at
    once; sanet calibrates on the whole batch through ``bundle.vgg``). If
    the card runs out of memory the
    pass retries once on the first image alone, as rpst does on
    RESOURCE_EXHAUSTED: per-tensor absmax scales from one image beat a
    dead serving process."""
    try:
        return bundle.calibrate_q8(calib, calib_style)
    except torch.cuda.OutOfMemoryError:
        if calib.shape[0] <= 1:
            raise
        logger.warning("calibration ran out of device memory; retrying "
                       "with a single-image batch")
        torch.cuda.empty_cache()
        return bundle.calibrate_q8(calib[:1], calib_style[:1])


def make_run_impl(bundle, mode: str, scales=None,
                  fuse_pairs="auto") -> Callable:
    """``run_impl(content, style) -> stylized`` on the resolved mode's
    path: the bundle's int8 (with ``scales`` from ``calibrate_scales``;
    ``fuse_pairs`` as in ``stylize_multi_adain_folded_q8``, for the flagship
    only: adain, wct and sanet run their standard-layout int8 path on B5,
    sanet's attention on B6), folded or standard stylize."""
    if mode == "q8":
        if scales is None:
            raise ValueError("mode q8 needs the scales of calibrate_scales")
        return lambda content, style: bundle.stylize_q8(
            content, style, scales, fuse_pairs=fuse_pairs)
    if mode not in ("folded", "standard"):
        raise ValueError(f"make_run_impl takes a resolved mode, got {mode!r}")
    folded = mode == "folded"
    return lambda content, style: bundle.stylize(content, style,
                                                 folded=folded)


class DynamicBatcher:
    """Coalesce concurrent stylize requests into fixed-shape batches.

    ``run(content, style) -> stylized`` takes exactly ``(batch_size, H, W,
    3)`` tensors on ``device`` (short batches are padded by repeating the
    last request) and may return before the device finishes. Both threads
    run under ``torch.inference_mode``. A failing batch fails only its own
    requests; the worker survives for the next window."""

    def __init__(self, run: Callable, batch_size: int,
                 max_wait_ms: float = 5.0, device="cpu"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.run = run
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.device = torch.device(device)
        self._q: Queue = Queue()
        self._stats_lock = threading.Lock()
        self.served = 0
        self.batches = 0
        self.batch_ms: Any = deque(maxlen=1024)  # recent window only
        self._stop = threading.Event()
        # double buffering: the worker dispatches batch t, hands it to the
        # flusher (which blocks on the device-to-host copy) and collects
        # batch t+1 meanwhile; maxsize=1 keeps one batch in flight
        self._flush_q: Queue = Queue(maxsize=1)
        self._flusher = threading.Thread(target=self._flush_loop,
                                         daemon=True)
        self._flusher.start()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, content: np.ndarray, style: np.ndarray) -> Future:
        """Queue one (H, W, 3) request; the Future resolves to the stylized
        (H, W, 3) numpy image."""
        fut: Future = Future()
        if self._stop.is_set():
            fut.set_exception(RuntimeError("batcher closed"))
            return fut
        self._q.put((content, style, fut))
        return fut

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            ms = sorted(self.batch_ms)
            p50 = ms[len(ms) // 2] if ms else None
            return {"served": self.served, "batches": self.batches,
                    "batch_size": self.batch_size,
                    "p50_batch_ms": round(p50, 2) if p50 else None}

    def close(self):
        """Stop the worker and fail any still-queued requests, so a handler
        blocked in ``Future.result`` gets an error instead of hanging."""
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=10)
        self._flush_q.put(None)  # worker exited: the sentinel lands last
        self._flusher.join(timeout=10)
        self._drain_failed()

    def _drain_failed(self):
        while True:
            try:
                item = self._q.get_nowait()
            except Empty:
                return
            if item is not None and not item[2].done():
                item[2].set_exception(RuntimeError("batcher closed"))

    def _collect(self):
        """Block for the first request, then fill the batch within the
        window."""
        first = self._q.get()
        if first is None:
            return []
        items = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(items) < self.batch_size:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _flush_loop(self):
        with torch.inference_mode():
            while True:
                p = self._flush_q.get()
                if p is None:
                    return
                futs, dev_out, t0 = p
                try:
                    out = dev_out.cpu().numpy()  # waits for the device
                    ms = (time.perf_counter() - t0) * 1e3
                    with self._stats_lock:
                        self.served += len(futs)
                        self.batches += 1
                        self.batch_ms.append(ms)
                    for b, fut in enumerate(futs):
                        fut.set_result(out[b])
                except Exception as e:  # fail THIS batch, keep serving
                    for fut in futs:
                        if not fut.done():
                            fut.set_exception(e)

    def _loop(self):
        # a batch already collected when close() lands still serves;
        # never-collected requests are failed by close()'s drain
        with torch.inference_mode():
            while not self._stop.is_set():
                items = self._collect()
                if not items:
                    continue
                futs = [f for _, _, f in items]
                try:
                    t0 = time.perf_counter()
                    content = np.stack([c for c, _, _ in items])
                    style = np.stack([s for _, s, _ in items])
                    pad = self.batch_size - len(items)
                    if pad:
                        content = np.concatenate(
                            [content, content[-1:].repeat(pad, 0)])
                        style = np.concatenate(
                            [style, style[-1:].repeat(pad, 0)])
                    dev_out = self.run(
                        torch.from_numpy(content).to(self.device),
                        torch.from_numpy(style).to(self.device))
                except Exception as e:
                    for fut in futs:
                        if not fut.done():
                            fut.set_exception(e)
                    continue
                # blocks while one batch is already in flight
                self._flush_q.put((futs, dev_out, t0))


def serve_daemon(batcher: DynamicBatcher, img_size: int, out_dir: Path,
                 port: int = 0, host: str = "127.0.0.1",
                 default_style: Optional[np.ndarray] = None,
                 to_u8=None) -> None:
    """Line-delimited-JSON TCP serving loop over ``batcher``; blocks until a
    ``{"cmd": "shutdown"}`` request. Each stylize request decodes in its own
    thread, so host IO overlaps the device batch in flight and pipelined
    requests on one connection coalesce into one batch."""
    out_dir.mkdir(parents=True, exist_ok=True)
    seq = itertools.count()  # uniquifies output filenames

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            self._wlock = threading.Lock()
            pending = []
            for raw in self.rfile:
                try:
                    req = json.loads(raw)
                except json.JSONDecodeError as e:
                    self._reply({"ok": False, "error": f"bad json: {e}"})
                    continue
                cmd = req.get("cmd")
                if cmd == "stats":
                    self._reply({"ok": True, **batcher.stats()})
                    continue
                if cmd == "shutdown":
                    for t in pending:
                        t.join(timeout=600)
                    self._reply({"ok": True, "shutdown": True})
                    threading.Thread(target=self.server.shutdown,
                                     daemon=True).start()
                    return
                t = threading.Thread(
                    target=lambda r=req: self._reply(self._stylize(r)),
                    daemon=True)
                t.start()
                pending.append(t)
            for t in pending:
                t.join(timeout=600)

        def _stylize(self, req):
            rid = req.get("id", "req")
            t0 = time.perf_counter()
            try:
                cvt = to_u8 if to_u8 is not None else (lambda a: a)
                content = cvt(load_image(req["content"], img_size))
                if "style" in req:
                    style = cvt(load_image(req["style"], img_size))
                elif default_style is not None:
                    style = default_style
                else:
                    return {"id": rid, "ok": False,
                            "error": "no style (request key or --style)"}
                out = batcher.submit(content, style).result(timeout=600)
                # client ids are untrusted: sanitize (no path escapes) and
                # uniquify (colliding ids must not overwrite each other)
                safe = re.sub(r"[^A-Za-z0-9_.-]", "_", str(rid))[:80] \
                    or "req"
                path = out_dir / f"{safe}-{next(seq):06d}.png"
                save_image(out, path)
                return {"id": rid, "ok": True, "out": str(path),
                        "ms": round((time.perf_counter() - t0) * 1e3, 2)}
            except Exception as e:  # one bad request must not end the loop
                return {"id": rid, "ok": False,
                        "error": f"{type(e).__name__}: {str(e)[:200]}"}

        def _reply(self, obj):
            with self._wlock:
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((host, port), Handler) as server:
        bound = server.server_address[1]
        # clients and tests parse this line to find the bound port
        logger.info(f"DAEMON LISTENING {host}:{bound} "
                    f"(batch {batcher.batch_size}, "
                    f"window {batcher.max_wait * 1e3:.0f} ms) -> {out_dir}")
        server.serve_forever()
    logger.info(f"Daemon stopped after {batcher.stats()}")
