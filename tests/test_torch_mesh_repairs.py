"""Two repairs of the port's multi-device training against rpst's trainer:

  * the stop signal (rpst ``train.py:354-381``): a SIGTERM that reaches one
    rank of two stops both at the same step, after one checkpoint, and
    both exit 0 (each rank's flag is maxed over the ranks at ``log_iter``
    boundaries; a rank that stopped alone would leave the other waiting in
    its next collective);
  * ``grad_accum`` on a data mesh (rpst ``train/step.py:78-83``): the
    microbatches are cut from the GLOBAL batch, each then shared over the
    data ranks, so sel_multi_adain's BatchNorm statistics are those of one
    device's microbatches: its float64 step on {data: 2} meets one
    device's to 1e-10 of the largest update.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

import torch_dist_worker as W
from rpst_torch.train.step import train_step
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def test_grad_accum_microbatches_are_rpsts(tmp_path):
    res = W.run_ranks("accum", 2, tmp_path, timeout=300)
    bundle, vgg, c, s, _ = W.dp_case("sel_multi_adain", {}, accum=2,
                                     f64=True)
    before = {n: t.clone() for n, t in bundle.model.state_dict().items()}
    loss = train_step(W.sgd_state(bundle), vgg, c, s)["total_loss"]
    after = bundle.model.state_dict()
    scale = max((before[n] - after[n]).abs().max().item() for n in after)
    for r in res:
        np.testing.assert_allclose(float(r["total_loss"]), float(loss),
                                   rtol=1e-12)
        for n, t in after.items():
            err = (r[f"state/{n}"] - t).abs().max().item()
            assert err <= 1e-10 * scale, (n, err / scale)


def test_stop_signal_to_one_rank_stops_both(tmp_path):
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (tmp_path / sub).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8),
                            "RGB").save(tmp_path / sub / f"{i}.png")
    cfg = dict(network="multi_adain", rp_blocks=2, hidden_dim=8,
               img_size=32, batch_size=2, num_workers=0, max_iter=100000,
               log_iter=2, snapshot_save_iter=100000, vgg="",
               mesh_shape={"data": 2}, content_dir=str(tmp_path / "content"),
               style_dir=str(tmp_path / "style"),
               output=str(tmp_path / "out"))
    (tmp_path / "cfg.yaml").write_text(json.dumps(cfg))
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "train_torch.py"), "--config",
         str(tmp_path / "cfg.yaml"), "--device", "cpu", "--set",
         "distributed=true",
         f"coordinator_address=file://{tmp_path / 'init'}",
         "num_processes=2", f"process_id={r}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    logs = []
    try:
        metrics = tmp_path / "out" / "logs" / "metrics.jsonl"
        deadline = time.time() + 120
        while time.time() < deadline and not (
                metrics.exists() and metrics.read_text().strip()):
            assert all(p.poll() is None for p in procs)
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        for p in procs:  # a rank left alone hangs: this test's own limit
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    stops = [[ln for ln in log.splitlines() if "stops after step" in ln]
             for log in logs]
    steps = [int(s[-1].split("stops after step")[1].split(",")[0])
             for s in stops]
    assert steps[0] == steps[1] and steps[0] % 2 == 0, stops
    ckpts = sorted(p.name for p in (tmp_path / "out" / "checkpoints")
                   .iterdir())
    assert ckpts == [str(steps[0])]
    saved = torch.load(tmp_path / "out" / "checkpoints" / ckpts[0]
                       / "state.pt", weights_only=True)
    assert saved["step"] == steps[0]
