"""The serving daemon over a mesh of ranks (rpst ``serve.py:286-296``):
``serve_torch.py --daemon --mesh 2`` and ``--mesh spatial=2`` (the folded
flagship) on gloo ranks on the CPU. Rank 0 owns the socket and the
batcher and sends each batch to every rank; four requests are answered,
each PNG within one uint8 step of the one-process daemon's (as rpst's
tests/test_spatial_gspmd.py holds its mesh serving), and a shutdown stops
every rank with exit code 0.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("daemon")
    rng = np.random.default_rng(0)
    (root / "c").mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8),
                        "RGB").save(root / "c" / f"c{i}.png")
    Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8),
                    "RGB").save(root / "s.png")
    (root / "cfg.yaml").write_text(json.dumps(dict(
        network="multi_adain", rp_blocks=3, hidden_dim=32, img_size=32,
        attention="none", vgg="")))
    return root


def _daemon(data, out, *extra):
    """Start the daemon, send four requests and a shutdown; returns the
    replies (by id) and the command's exit code and output."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "serve_torch.py"), "--config",
         str(data / "cfg.yaml"), "--content", str(data / "c"), "--style",
         str(data / "s.png"), "--out", str(out), "--device", "cpu",
         "--mode", "folded", "--batch", "2", "--daemon", "--port", "0",
         "--max-wait-ms", "200", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines, replies = [], {}
    try:
        port, deadline = None, time.time() + 180
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "DAEMON LISTENING" in line:
                port = int(line.split("DAEMON LISTENING")[1].split()[0]
                           .rsplit(":", 1)[1])
        assert port, "".join(lines)
        with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
            f = s.makefile("rw")
            for i in range(4):
                f.write(json.dumps({"id": f"r{i}", "content": str(
                    data / "c" / f"c{i}.png")}) + "\n")
            f.flush()
            for _ in range(4):
                r = json.loads(f.readline())
                replies[r["id"]] = r
            f.write(json.dumps({"cmd": "shutdown"}) + "\n")
            f.flush()
            assert json.loads(f.readline())["shutdown"]
        rest = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return replies, proc.returncode, "".join(lines) + (rest or "")


@pytest.mark.parametrize("mesh", ["2", "spatial=2"])
def test_daemon_over_ranks_matches_one_process(data, tmp_path, mesh):
    one, rc, log = _daemon(data, tmp_path / "one")
    assert rc == 0, log
    got, rc, log = _daemon(data, tmp_path / "mesh", "--mesh", mesh)
    assert rc == 0, log
    assert "a rank exited" not in log
    assert sorted(got) == sorted(one) == [f"r{i}" for i in range(4)]
    for rid in one:
        assert one[rid]["ok"] and got[rid]["ok"], (one[rid], got[rid])
        a = np.asarray(Image.open(one[rid]["out"])).astype(int)
        b = np.asarray(Image.open(got[rid]["out"])).astype(int)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1, rid
