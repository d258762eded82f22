"""train_torch.py on the CPU: a 3-step folded run at 32px on a tiny PNG
folder writes metrics.jsonl and checkpoints, a resume continues at the next
step, the unported options raise naming their slice (the LD networks, once
refused, train), and ``--device cuda`` without a card exits non-zero."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _driver():
    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def run_dir(tmp_path):
    rng = np.random.default_rng(0)
    for sub in ("content", "style/painter"):  # style in '*/*' subfolders
        (tmp_path / sub).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (40, 36, 3), np.uint8),
                            "RGB").save(tmp_path / sub / f"{i}.png")
    cfg = dict(network="multi_adain", rp_blocks=3, hidden_dim=8,
               img_size=32, batch_size=2, num_workers=2,
               exec_strategy="folded", lr_decay=0.1, max_iter=4,
               snapshot_save_iter=2, content_dir=str(tmp_path / "content"),
               style_dir=str(tmp_path / "style"),
               output=str(tmp_path / "out"))
    (tmp_path / "cfg.yaml").write_text(json.dumps(cfg))
    return tmp_path


def test_cpu_run_writes_metrics_and_checkpoints_and_resumes(run_dir):
    main = _driver().main
    cfg = str(run_dir / "cfg.yaml")
    main(["--config", cfg, "--device", "cpu"])
    out = run_dir / "out"
    lines = [json.loads(ln) for ln in
             (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2, 3]
    for ln in lines:
        assert set(ln) == {"step", "time", "content_loss", "style_loss",
                           "total_loss", "skipped"}
        assert np.isfinite(ln["total_loss"]) and ln["skipped"] == 0.0
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == \
        ["2", "3"]
    saved = torch.load(out / "checkpoints" / "3" / "state.pt",
                       weights_only=True)
    assert saved["step"] == 3 and set(saved) == {"step", "params",
                                                 "opt_state", "rng"}

    main(["--config", cfg, "--device", "cpu", "--set", "resume=true",
          "max_iter=3"])
    lines = [json.loads(ln) for ln in
             (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2, 3, 4, 5]
    assert (out / "checkpoints" / "5" / "state.pt").exists()


@pytest.mark.parametrize("override,slice_", [
    ("mesh_shape={data: 2}", "slice 8"), ("distributed=true", "slice 8"),
    ("network=ld_adain2", "slice 5b"), ("network=ld_adain3", "slice 5b"),
    ("grad_accum=2", "slice 8"), ("remat=true", "slice 8"),
    ("test_dir=/x", "slice 7"), ("network=ld_adain", "slice 5b")])
def test_unported_options_raise(run_dir, override, slice_):
    """The options of later slices raise naming their slice: the
    multi-device ``mesh_shape`` and ``distributed`` (slice 8). The LD
    networks, which slice 5b refused until the port built them, train: two
    CPU steps of each; ``test_dir``, which slice 7 refused until the port
    took its test dumps, stylizes a photoreal set with its masks every
    ``test_iter`` steps into ``<output>/test/<step>``; ``grad_accum=2`` and
    ``remat=true``, which slice 8 refused until the port took its
    single-device half, train two CPU steps each (these cases keep their
    ids)."""
    args = ["--config", str(run_dir / "cfg.yaml"), "--device", "cpu",
            "--set", override]
    if slice_ == "slice 7":
        sys.path.insert(0, str(REPO / "tools"))
        from make_photoreal_set import make_photoreal_set
        photo = make_photoreal_set(run_dir / "photo", n=3, size=32)
        _driver().main([*args[:-1], f"test_dir={photo}", "use_mask=true",
                        "test_dataset=photoreal", "test_iter=2",
                        "max_iter=4"])
        out = run_dir / "out" / "test"
        names = [f"in{k}-tar{k}{tail}" for k in range(3)
                 for tail in ("-cat.png", ".png")]
        assert sorted(p.name for p in (out / "2").iterdir()) == sorted(names)
        assert sorted(p.name for p in out.iterdir()) == ["2"]
        return
    if slice_ == "slice 5b" or override in ("grad_accum=2", "remat=true"):
        _driver().main([*args, "max_iter=3"])
        lines = [json.loads(ln) for ln in (run_dir / "out" / "logs"
                                           / "metrics.jsonl").read_text()
                 .splitlines()]
        assert [ln["step"] for ln in lines] == [1, 2]
        assert all(np.isfinite(ln["total_loss"]) and ln["skipped"] == 0.0
                   for ln in lines)
        return
    with pytest.raises(NotImplementedError, match=slice_):
        _driver().main(args)


def test_cuda_without_a_card_exits_nonzero(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO / "train_torch.py"), "--config",
         str(run_dir / "cfg.yaml"), "--device", "cuda"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO))
    assert proc.returncode != 0
    assert "is_available() is False" in proc.stderr
    assert not (run_dir / "out").exists()
