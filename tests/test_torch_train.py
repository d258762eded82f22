"""The port's training slice against rpst on the CPU: ModelBundle.loss and
its gradients (folded and standard), the committed full-width train fixture
(no JAX compile), Adam and the lr schedule against optax, the non-finite
skip, checkpoints and resume, and the metric log's format."""

import json
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rpst.config import load_config as j_load_config
from rpst.models import build_model as j_build_model
from rpst.train.metrics import MetricWriter as JMetricWriter
from rpst.train.step import reference_lr_schedule as j_schedule
from rpst_torch.bridge import (flax_tree_from_npz, from_flax_params,
                               vgg_from_flax, vgg_weights_from_seed)
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.nn.blocks import init_torch_default
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from rpst_torch.train.fault import CheckpointOnSignal
from rpst_torch.train.metrics import MetricWriter
from rpst_torch.train.step import (adam_count, create_train_state,
                                   make_optimizer, reference_lr_schedule,
                                   train_step)

TRAIN_FIXTURE = (Path(__file__).resolve().parent / "fixtures"
                 / "torch_port_train.npz")
SMALL = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=3,
             hidden_dim=8, img_size=16)
FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant",
                rp_blocks=5, hidden_dim=32)
LOSS_RTOL = 1e-4   # tests/test_folded.py:133
GRAD_RTOL = 5e-3   # tests/test_folded.py:137; atol 1e-4 x each tensor's max


def _vgg(seed):
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(seed)))
    return vgg


def _images(seed, n=2, size=16):
    rng = np.random.default_rng(seed)
    return (rng.random((n, size, size, 3), dtype=np.float32),
            rng.random((n, size, size, 3), dtype=np.float32))


def _check_grads(model, ref):
    for name, p in model.named_parameters():
        r = ref[name]
        torch.testing.assert_close(
            p.grad, r, rtol=GRAD_RTOL, atol=1e-4 * r.abs().max().item(),
            msg=name)


@pytest.mark.parametrize("strategy", ["folded", "standard"])
def test_loss_and_grads_match_rpst(strategy):
    content, style = _images(0)
    tree = vgg_weights_from_seed(1)
    jvgg = jax.tree.map(jnp.asarray, tree)
    jb = j_build_model(j_load_config(dict(SMALL, exec_strategy=strategy)))
    c, s = jnp.asarray(content), jnp.asarray(style)
    params = jb.init(jax.random.PRNGKey(0), c, s, jvgg)["params"]

    def f(p):
        total, (parts, _) = jb.loss({"params": p}, jvgg, c, s, train=True)
        return total, parts

    (_, ref_parts), ref_grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    bundle = build_model(load_config(dict(SMALL, exec_strategy=strategy)))
    assert bundle.folded_exec() == (strategy == "folded")
    bundle.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    total, parts = bundle.loss(_vgg(1), torch.from_numpy(content),
                               torch.from_numpy(style))
    total.backward()
    assert set(parts) == {"content_loss", "style_loss", "total_loss"}
    for k in parts:
        np.testing.assert_allclose(float(parts[k].detach()),
                                   float(ref_parts[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    _check_grads(bundle.model,
                 from_flax_params(jax.tree.map(np.asarray, ref_grads)))


def test_flagship_matches_train_fixture():
    """Full width (rp_blocks 5, hidden 32) at 64px b2 against rpst's loss,
    gradients and 3-step trajectory in tests/fixtures/torch_port_train.npz
    (tools/make_torch_port_fixture.py --train)."""
    with np.load(TRAIN_FIXTURE) as npz:
        tree = flax_tree_from_npz(npz)
        fx = {k: npz[k] for k in npz.files if "/" not in k}
    grads = from_flax_params(tree.pop("grads"))
    bundle = build_model(load_config(dict(
        FLAGSHIP, img_size=fx["content"].shape[1], exec_strategy="folded",
        lr=float(fx["lr"]), lr_decay=float(fx["lr_decay"]))))
    bundle.load_state_dict(from_flax_params(tree))
    vgg = _vgg(int(fx["vgg_seed"]))
    c, s = torch.from_numpy(fx["content"]), torch.from_numpy(fx["style"])
    total, parts = bundle.loss(vgg, c, s)
    total.backward()
    for k in ("content_loss", "style_loss", "total_loss"):
        np.testing.assert_allclose(float(parts[k].detach()), float(fx[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    _check_grads(bundle.model, grads)
    bundle.model.zero_grad(set_to_none=True)
    state = create_train_state(bundle)
    losses = [float(train_step(state, vgg, c, s)["total_loss"])
              for _ in range(len(fx["trajectory"]))]
    np.testing.assert_allclose(losses, fx["trajectory"], rtol=LOSS_RTOL)
    assert state.step == 3 and adam_count(state.optimizer) == 3


def test_adam_and_schedule_match_optax():
    """The same gradient sequence through make_optimizer + the reference
    schedule and through optax.adam(rpst's schedule): params to 1e-6."""
    cfg = load_config(dict(SMALL, lr=1e-2, lr_decay=0.5))
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(5)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(cfg, [param])
    schedule = reference_lr_schedule(cfg.lr, cfg.lr_decay)
    tx = optax.adam(j_schedule(cfg.lr, cfg.lr_decay))
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    for g in grads:
        param.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = schedule(adam_count(opt))
        opt.step()
        updates, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-6)
    assert adam_count(opt) == 5
    assert schedule(0) == pytest.approx(float(j_schedule(1e-2, 0.5)(0)))


def _small_state(seed=0, **over):
    bundle = build_model(load_config(dict(SMALL, exec_strategy="folded",
                                          lr=1e-3, lr_decay=0.1, **over)))
    init_torch_default(bundle.model, seed)
    return create_train_state(bundle)


def test_nonfinite_step_is_skipped():
    """rpst's skip: the step advances, the parameters and the Adam state
    (its count, so the lr schedule) stay, skipped = 1; the next finite step
    is the one an uninterrupted run takes."""
    vgg = _vgg(1)
    c, s = (torch.from_numpy(a) for a in _images(2))
    bad = c.clone()
    bad[0, 0, 0, 0] = float("nan")
    skipping, plain = _small_state(), _small_state()
    train_step(skipping, vgg, c, s)
    train_step(plain, vgg, c, s)
    before = {k: v.clone() for k, v in skipping.model.state_dict().items()}
    moments = [t.clone() for st in skipping.optimizer.state.values()
               for t in (st["exp_avg"], st["exp_avg_sq"])]
    parts = train_step(skipping, vgg, bad, s)
    assert float(parts["skipped"]) == 1.0
    assert not np.isfinite(float(parts["total_loss"]))
    assert skipping.step == 2 and adam_count(skipping.optimizer) == 1
    for k, v in skipping.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    for a, b in zip([t for st in skipping.optimizer.state.values()
                     for t in (st["exp_avg"], st["exp_avg_sq"])], moments):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(train_step(skipping, vgg, c, s)["skipped"]) == 0.0
    train_step(plain, vgg, c, s)
    for (k, v), w in zip(skipping.model.state_dict().items(),
                         plain.model.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


def test_checkpoint_round_trip_and_resume(tmp_path):
    """Save after 2 steps, restore into a differently initialized state:
    the third step's loss is the uninterrupted run's."""
    vgg = _vgg(1)
    batches = [tuple(torch.from_numpy(a) for a in _images(i)) for i in range(3)]
    run = _small_state(seed=0)
    for c, s in batches[:2]:
        train_step(run, vgg, c, s)
    run.generator.manual_seed(123)
    path = save_checkpoint(tmp_path / "checkpoints", run)
    assert latest_step(tmp_path / "checkpoints") == 2
    assert path.endswith("/2")
    rng_state = run.generator.get_state()
    want = float(train_step(run, vgg, *batches[2])["total_loss"])

    resumed = _small_state(seed=7)
    restore_checkpoint(path, resumed)
    assert resumed.step == 2 and adam_count(resumed.optimizer) == 2
    assert torch.equal(resumed.generator.get_state(), rng_state)
    got = float(train_step(resumed, vgg, *batches[2])["total_loss"])
    assert got == want
    for a, b in zip(resumed.model.parameters(), run.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_trains_after_serving_in_one_process():
    """The fold's cached placement tensor and the VGG's folded weights,
    first made under inference_mode (stylize, a loss evaluation), still
    work inside autograd."""
    from rpst_torch.ops import folded
    folded._fold_placement.cache_clear()
    state = _small_state()
    c, s = (torch.from_numpy(a) for a in _images(4))
    vgg = _vgg(1)
    state.bundle.stylize(c, s, folded=True)
    with torch.inference_mode():  # an evaluation of the loss first
        state.bundle.loss(vgg, c, s)
    parts = train_step(state, vgg, c, s)
    assert float(parts["skipped"]) == 0.0


def test_latest_step_ignores_partial_directories(tmp_path):
    root = tmp_path / "checkpoints"
    assert latest_step(root) is None
    (root / "7").mkdir(parents=True)  # no state file: an interrupted save
    assert latest_step(root) is None


def test_metric_lines_match_rpst_format(tmp_path):
    parts = {"total_loss": 3.0, "content_loss": 1.0, "style_loss": 2.0,
             "skipped": 0.0}
    ours, ref = MetricWriter(tmp_path / "a"), JMetricWriter(
        tmp_path / "b", tensorboard=False)
    ours.write(5, {k: torch.tensor(v) for k, v in parts.items()})
    ref.write(5, dict(sorted(parts.items())))
    ours.close()
    ref.close()
    a, b = (json.loads((tmp_path / d / "logs" / "metrics.jsonl").read_text())
            for d in ("a", "b"))
    assert list(a) == list(b)
    assert {k: v for k, v in a.items() if k != "time"} == \
        {k: v for k, v in b.items() if k != "time"}


def test_checkpoint_on_signal():
    with CheckpointOnSignal(signals=(signal.SIGUSR1,)) as stop:
        assert not stop.requested
        signal.raise_signal(signal.SIGUSR1)
        assert stop.requested
