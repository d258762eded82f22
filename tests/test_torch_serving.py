"""The port's serving layer: DynamicBatcher semantics (the cases of
tests/test_serving.py on torch tensors), mode resolution, serve_torch.py's
folder sweep and daemon on the CPU, the no-JAX import rule, and the JAX
fixture that chip_smoke.py holds the card against."""

import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.serving import DynamicBatcher, make_run_impl, resolve_mode

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_port_flagship.npz"


def _img(v, size=4):
    return np.full((size, size, 3), v, np.float32)


def test_batcher_coalesces_and_pads():
    """3 concurrent requests with batch_size=4 dispatch as ONE padded
    batch of torch tensors; each future resolves to its own row."""
    seen = []

    def run(c, s):
        seen.append((tuple(c.shape), type(c)))
        return c + s

    b = DynamicBatcher(run, batch_size=4, max_wait_ms=200.0)
    try:
        futs = [b.submit(_img(i), _img(10 * i)) for i in range(3)]
        outs = [f.result(timeout=30) for f in futs]
        for i, out in enumerate(outs):
            np.testing.assert_allclose(out, _img(11 * i))
        assert seen == [((4, 4, 4, 3), torch.Tensor)]  # padded 3 -> 4
        st = b.stats()
        assert st["served"] == 3 and st["batches"] == 1
    finally:
        b.close()


def test_batcher_dispatches_full_batch_without_waiting():
    calls = []

    def run(c, s):
        calls.append(c[:, 0, 0, 0].tolist())
        return c

    b = DynamicBatcher(run, batch_size=2, max_wait_ms=10_000.0)
    try:
        f1, f2 = b.submit(_img(1), _img(0)), b.submit(_img(2), _img(0))
        f1.result(timeout=30), f2.result(timeout=30)
        assert calls == [[1.0, 2.0]]  # no 10 s wait: the batch was full
        t0 = time.perf_counter()
        b3 = DynamicBatcher(run, batch_size=2, max_wait_ms=50.0)
        try:
            b3.submit(_img(3), _img(0)).result(timeout=30)
            assert time.perf_counter() - t0 < 10  # the window, not forever
        finally:
            b3.close()
    finally:
        b.close()


def test_batcher_contains_failures_per_batch():
    state = {"fail": True}

    def run(c, s):
        if state["fail"]:
            raise RuntimeError("boom")
        return c

    b = DynamicBatcher(run, batch_size=1, max_wait_ms=5.0)
    try:
        with pytest.raises(RuntimeError):
            b.submit(_img(1), _img(0)).result(timeout=30)
        state["fail"] = False
        np.testing.assert_allclose(
            b.submit(_img(2), _img(0)).result(timeout=30), _img(2))
        assert b.stats()["served"] == 1
    finally:
        b.close()


def test_batcher_threads_run_in_inference_mode():
    """Grad mode is thread-local: the worker enters inference mode itself,
    so stylize never builds an autograd graph."""
    modes = []

    def run(c, s):
        modes.append((torch.is_inference_mode_enabled(),
                      torch.is_grad_enabled()))
        return c

    b = DynamicBatcher(run, batch_size=1, max_wait_ms=1.0)
    try:
        b.submit(_img(1), _img(0)).result(timeout=30)
    finally:
        b.close()
    assert modes == [(True, False)]


def test_batcher_close_fails_stranded_requests():
    entered, gate = threading.Event(), threading.Event()

    def run(c, s):
        entered.set()
        gate.wait(30)  # hold the worker inside the in-flight batch
        return c

    b = DynamicBatcher(run, batch_size=1, max_wait_ms=1.0)
    f1 = b.submit(_img(1), _img(0))
    assert entered.wait(10)
    f2 = b.submit(_img(2), _img(0))  # queued behind it
    closer = threading.Thread(target=b.close)
    closer.start()
    time.sleep(0.05)
    gate.set()
    closer.join(30)
    assert not closer.is_alive()
    np.testing.assert_allclose(f1.result(timeout=30), _img(1))
    with pytest.raises(RuntimeError):
        f2.result(timeout=30)
    with pytest.raises(RuntimeError):
        b.submit(_img(3), _img(0)).result(timeout=30)  # after close


def test_batcher_concurrent_submitters_stress():
    """More submitting threads than cores, a short switch interval: every
    request gets its own row back and the counts stay consistent."""
    b = DynamicBatcher(lambda c, s: c * 2.0, batch_size=4, max_wait_ms=2.0)
    errs = []

    def client(base):
        try:
            for i in range(10):
                v = float(base * 100 + i)
                out = b.submit(_img(v), _img(0)).result(timeout=60)
                np.testing.assert_allclose(out, _img(2 * v))
        except Exception as e:  # reported below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        b.close()
    assert not errs, errs
    st = b.stats()
    assert st["served"] == 120 and st["batches"] >= 30


def test_resolve_mode(caplog, monkeypatch):
    cfg = dict(network="multi_adain", rp_blocks=2, hidden_dim=4)
    folded = build_model(load_config(dict(cfg, exec_strategy="folded")))
    standard = build_model(load_config(cfg))
    # auto: the measured winner on the H100 (rpst_torch.policy, PERF.md);
    # q8 never at hidden 4 (no int8 layer), and never on a CPU device
    assert resolve_mode(folded, "auto") == "standard"
    assert resolve_mode(folded, "folded") == "folded"
    assert resolve_mode(standard, "auto") == "standard"
    assert resolve_mode(standard, "folded") == "standard"  # unsupported
    # q8 at hidden 32 (4 * 32 fills 128 folded lanes); at hidden 4 there is
    # no int8 layer: standard, with a warning
    q8_ok = build_model(load_config(dict(cfg, hidden_dim=32)))
    assert q8_ok.q8_infer() and resolve_mode(q8_ok, "q8") == "q8"
    assert not folded.q8_infer()
    from rpst_torch.metrics import logger
    monkeypatch.setattr(logger, "propagate", True)  # let caplog see it
    with caplog.at_level("WARNING"):
        assert resolve_mode(folded, "q8", batch=8) == "standard"
    assert "--mode q8 is unsupported" in caplog.text
    # auto at every batch on the CPU: the policy's q8 batches need a card
    for batch in (1, 8):
        assert resolve_mode(q8_ok, "auto", batch=batch) == "standard"
    with pytest.raises(ValueError):
        make_run_impl(folded, "auto")  # takes a resolved mode only
    with pytest.raises(ValueError):
        resolve_mode(folded, "int4")


@pytest.mark.parametrize("network,over", [
    ("multi_adain", dict(hidden_dim=32)),
    ("sel_multi_adain", dict(hidden_dim=32)),
    ("ccam", dict(hidden_dim=32)),
    ("mst", dict(hidden_dim=32)),
    ("adain", dict(hidden_dim=32)),
    ("wct", dict(hidden_dim=32)),
    ("mrf", dict(hidden_dim=32)),
    ("spade", dict(hidden_dim=32)),
    ("seg_adain", dict(hidden_dim=32)),
    ("sanet", dict(img_size=32)),
    ("dynamic_sanet", dict(img_size=32)),
    ("src", dict(img_size=32)),
    ("ld_adain", dict(hidden_dim=64)),
    ("ld_adain2", dict(hidden_dim=64, img_size=32)),
    ("ld_adain3", dict(hidden_dim=8)),
    ("ld_adain4", dict(hidden_dim=8)),
    ("ld_adain5", dict(hidden_dim=8))])
def test_auto_mode_follows_the_q8_table(network, over, monkeypatch):
    """For every ported network ``--mode auto`` on a card resolves to what
    ``policy.Q8_AUTO_BATCHES`` says: q8 at the batches it lists, the
    policy's ``AUTO_MODE`` elsewhere; an entry added to the table is picked
    up at its batch and at no other. A network without an int8 path (LD
    v3-v5) never resolves to q8, even with an entry. The device is named,
    not used: ``resolve_mode`` only asks where the bundle lives."""
    from rpst_torch import policy
    bundle = build_model(load_config(dict(network=network, rp_blocks=2,
                                          **over)))
    monkeypatch.setattr(bundle, "device", torch.device("cuda"))
    if network in ("ld_adain3", "ld_adain4", "ld_adain5"):
        assert not bundle.q8_infer()
        monkeypatch.setitem(policy.Q8_AUTO_BATCHES, network,
                            frozenset({1, 2, 4, 8}))
        assert all(resolve_mode(bundle, "auto", batch=b) == policy.AUTO_MODE
                   for b in (1, 2, 4, 8, 16))
        return
    assert bundle.q8_infer()
    listed = policy.Q8_AUTO_BATCHES.get(network, frozenset())
    for batch in (1, 2, 4, 8, 16):
        want = "q8" if batch in listed else policy.AUTO_MODE
        assert resolve_mode(bundle, "auto", batch=batch) == want, batch
    assert resolve_mode(bundle, "auto") == (
        "q8" if 8 in listed else policy.AUTO_MODE)  # the default batch, 8
    monkeypatch.setitem(policy.Q8_AUTO_BATCHES, network, frozenset({4}))
    assert resolve_mode(bundle, "auto", batch=4) == "q8"
    assert resolve_mode(bundle, "auto", batch=1) == policy.AUTO_MODE
    monkeypatch.setattr(bundle, "device", torch.device("cpu"))
    assert resolve_mode(bundle, "auto", batch=4) == policy.AUTO_MODE


def test_make_run_impl_runs_the_mode_path(monkeypatch):
    """The mode, not the config, picks the path: a bundle configured folded
    serves standard when the resolved mode is standard, and both agree."""
    import rpst_torch.models as models

    cfg = dict(network="multi_adain", rp_blocks=2, hidden_dim=4)
    folded = build_model(load_config(dict(cfg, exec_strategy="folded")))
    calls = []
    real = models.stylize_multi_adain_folded
    monkeypatch.setattr(models, "stylize_multi_adain_folded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    g = torch.Generator().manual_seed(0)
    c, s = torch.rand(2, 1, 8, 8, 3, generator=g)
    y_folded = make_run_impl(folded, "folded")(c, s)
    y_standard = make_run_impl(folded, "standard")(c, s)
    assert len(calls) == 1
    torch.testing.assert_close(y_folded, y_standard, rtol=1e-4, atol=1e-4)
    standard = build_model(load_config(cfg))
    with pytest.raises(ValueError, match="folded"):
        make_run_impl(standard, "folded")(c, s)


# ---------------------------------------------------------------------------
# serve_torch.py end to end on the CPU (subprocesses)
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


@pytest.fixture
def serve_data(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8),
                        "RGB").save(tmp_path / "content" / f"{i:02d}.png")
    Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8),
                    "RGB").save(tmp_path / "style" / "s.png")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(json.dumps(dict(network="multi_adain", rp_blocks=3,
                                   hidden_dim=8, img_size=32)))
    return tmp_path, cfg


def _serve_cmd(data, cfg, out, *extra):
    return [sys.executable, str(REPO / "serve_torch.py"), "--config",
            str(cfg), "--content", str(data / "content"),
            "--style", str(data / "style" / "s.png"), "--out", str(out),
            *extra]


def test_serve_torch_sweep_cpu(serve_data):
    """Folder sweep on --device cpu: one PNG per content image, equal to
    the port's stylize of the same seeded weights through the uint8
    boundary, up to one uint8 step; the CPU run launches no kernel."""
    from PIL import Image
    from rpst_torch.data import load_image, to_u8
    from rpst_torch.nn.blocks import init_torch_default

    data, cfg = serve_data
    out = data / "out"
    proc = subprocess.run(_serve_cmd(data, cfg, out, "--device", "cpu",
                                     "--batch", "2"),
                          capture_output=True, text=True, timeout=300,
                          env=_env(), cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "launches: 0" in proc.stderr
    pngs = sorted(out.glob("*.png"))
    assert [p.name for p in pngs] == [f"{i:02d}-s.png" for i in range(3)]

    bundle = build_model(load_config(str(cfg), {"exec_strategy": "folded"}))
    init_torch_default(bundle.model, 0)
    c = torch.from_numpy(to_u8(load_image(data / "content" / "01.png", 32)))
    s = torch.from_numpy(to_u8(load_image(data / "style" / "s.png", 32)))
    y = bundle.stylize(c[None].float() / 255, s[None].float() / 255)[0]
    want = (torch.clamp(y, 0, 1) * 255 + 0.5).to(torch.uint8).numpy()
    got = np.asarray(Image.open(pngs[1])).astype(np.int16)
    # batch 2 vs 1 may reorder a CPU conv's sums: at most one rounding step
    assert np.abs(got - want).max() <= 1


def test_serve_torch_daemon_cpu(serve_data):
    """Three pipelined requests (one with its own style), stats, shutdown."""
    from PIL import Image

    data, cfg = serve_data
    proc = subprocess.Popen(
        _serve_cmd(data, cfg, data / "served", "--device", "cpu", "--batch",
                   "2", "--daemon", "--max-wait-ms", "100"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=str(REPO))
    try:
        port, lines = None, []
        deadline = time.time() + 120
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "DAEMON LISTENING" in line:
                port = int(line.split("DAEMON LISTENING")[1].split()[0]
                           .rsplit(":", 1)[1])
        assert port, "".join(lines)
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            f = s.makefile("rw")
            for i in range(3):
                req = {"id": f"r{i}",
                       "content": str(data / "content" / f"{i:02d}.png")}
                if i == 2:
                    req["style"] = str(data / "content" / "00.png")
                f.write(json.dumps(req) + "\n")
            f.flush()
            replies = [json.loads(f.readline()) for _ in range(3)]
            assert {r["id"] for r in replies} == {"r0", "r1", "r2"}
            for r in replies:
                assert r["ok"], r
                assert np.asarray(Image.open(r["out"])).shape == (32, 32, 3)
            f.write(json.dumps({"cmd": "stats"}) + "\n")
            f.flush()
            st = json.loads(f.readline())
            assert st["ok"] and st["served"] == 3, st
            f.write(json.dumps({"cmd": "shutdown"}) + "\n")
            f.flush()
            assert json.loads(f.readline())["shutdown"]
        proc.wait(timeout=60)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_serve_torch_refuses_missing_card_and_q8(serve_data):
    """--device cuda without a card exits non-zero (no CPU fallback), and
    --mode q8 on --device cpu calibrates and serves: one PNG per content
    image, 'Calibrated N layer scales' with the count the stack derives,
    no kernel launched. (The name predates the q8 port, which made the
    q8 half positive.)"""
    from PIL import Image
    from rpst_torch.models.fast_path_q8 import q8_plan

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not "
                    "reachable")
    data, cfg = serve_data
    proc = subprocess.run(_serve_cmd(data, cfg, data / "o"),
                          capture_output=True, text=True, timeout=120,
                          env=_env(), cwd=str(REPO))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    out = data / "q8"
    proc = subprocess.run(_serve_cmd(data, cfg, out, "--device", "cpu",
                                     "--mode", "q8", "--batch", "2",
                                     "--set", "hidden_dim=32"),
                          capture_output=True, text=True, timeout=300,
                          env=_env(), cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    bundle = build_model(load_config(str(cfg), {"hidden_dim": 32}))
    enc, dec = bundle.folded_weights(torch.float32)
    n_scales = q8_plan([k for k, _ in enc], [k for k, _ in dec],
                       False)["scales"]
    assert f"Calibrated {n_scales} layer scales" in proc.stderr
    for label in ("B1", "B4", "B7"):
        assert re.search(rf"{label} \w+ launches: 0", proc.stderr), label
    pngs = sorted(out.glob("*.png"))
    assert [p.name for p in pngs] == [f"{i:02d}-s.png" for i in range(3)]
    for p in pngs:
        assert np.asarray(Image.open(p)).shape == (32, 32, 3)


def test_port_never_imports_jax():
    """Importing the port's modules (and serve_torch.py's and
    train_torch.py's) in a fresh interpreter leaves jax, flax, optax and the
    rpst package itself out of sys.modules."""
    code = (
        "import sys; sys.path.insert(0, 'src')\n"
        "import rpst_torch.serving, rpst_torch.models, rpst_torch.bridge\n"
        "import rpst_torch.ops.folded_conv, rpst_torch.kernels.build\n"
        "import rpst_torch.metrics, rpst_torch.models.fast_path\n"
        "import rpst_torch.config, rpst_torch.data\n"
        "import rpst_torch.nn.vgg, rpst_torch.nn.vgg_folded\n"
        "import rpst_torch.train.step, rpst_torch.train.checkpoint\n"
        "import rpst_torch.train.metrics, rpst_torch.train.fault\n"
        "import rpst_torch.ops.folded_conv_q8, rpst_torch.ops.folded_conv2_q8\n"
        "import rpst_torch.models.fast_path_q8, rpst_torch.policy\n"
        "import rpst_torch.ops.conv2d_q8, rpst_torch.ops.wct\n"
        "import rpst_torch.models.fast_path_q8_std, rpst_torch.models.wct_rp\n"
        "import rpst_torch.ops.flash_attention, rpst_torch.models.sanet\n"
        "import rpst_torch.nn.decoder, rpst_torch.models.src_adain\n"
        "import rpst_torch.ops.affinity, rpst_torch.ops.adaptive_attention\n"
        "import rpst_torch.ops.segment, rpst_torch.dumps, rpst_torch.viz\n"
        "import importlib.util as u\n"
        "import rpst_torch.nn.attention, rpst_torch.nn.blocks\n"
        "for name in ('serve_torch', 'train_torch', 'test_torch',\n"
        "             'tools/flops_estimate_torch'):\n"
        "    spec = u.spec_from_file_location(name.split('/')[-1],\n"
        "                                     name + '.py')\n"
        "    spec.loader.exec_module(u.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'rpst')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=_env(), cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr


PORT_FILES = sorted([*(REPO / "src" / "rpst_torch").rglob("*.py"),
                     REPO / "serve_torch.py", REPO / "train_torch.py",
                     REPO / "test_torch.py", REPO / "chip_smoke.py",
                     REPO / "profile_torch.py",
                     REPO / "tools" / "b4_compile_check.py",
                     REPO / "tools" / "flops_estimate_torch.py",
                     REPO / "tools" / "make_photoreal_set.py"])


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_reference_package(path):
    """No file of the port (chip_smoke.py included) imports jax or rpst,
    not even inside a function."""
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|rpst)"
                     r"(\.|\s|$)", re.M)
    assert not bad.findall(path.read_text())


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where
    torch.cuda is unavailable, and likewise alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=120,
                              env=_env(), cwd=str(cwd))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_fixture_matches_fresh_jax_run():
    """tests/fixtures/torch_port_flagship.npz is what
    tools/make_torch_port_fixture.py computes now with rpst."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixture", REPO / "tools" / "make_torch_port_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    fresh = tool.make_fixture()
    with np.load(FIXTURE) as fx:
        assert sorted(fx.files) == sorted(fresh)
        for k in fresh:
            np.testing.assert_allclose(fx[k], fresh[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        assert fx["params/rp_shared_encoder/block_1/PadConv_0/Conv_0/"
                  "kernel"].shape == (3, 3, 32, 32)
        assert fx["out"].shape == (1, 64, 64, 3)
