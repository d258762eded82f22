"""spade (SpadeRP: two RP encoders and a SPADE generator that decodes the
style features under the content features) of the port on the CPU.

Live rpst at op and module size: the instance norm (float32 and its
bfloat16 type), ``SPADE`` and ``SpadeResnetBlock`` with the instance norm
and flax's BatchNorm ('syncbatch': no scale or bias, momentum 0.9) in train
and eval mode, their moved statistics, the model in bfloat16 (the generator
computes float32, as rpst's flax convs promote). At model size against
``tests/fixtures/torch_port_spade.npz`` (``tools/make_torch_port_fixture.py
--spade``: 64px, batch 2, hidden 32, condition 512, nhidden 128, the
instance norm): no JAX compile. Tolerances are test_torch_mrf.py's (ops
1e-5, modules 1e-4); the bfloat16 module MAE < 1e-2 of the output's span.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.models.spade_rp import SpadeRP as JaxSpadeRP
from rpst.nn.blocks import instance_norm as jax_instance_norm
from rpst.nn.spade import SPADE as JaxSPADE
from rpst.nn.spade import SpadeResnetBlock as JaxSpadeResnetBlock
from rpst_torch.bridge import (from_flax_batch_stats, from_flax_params,
                               spade_weights_from_seed, vgg_from_flax,
                               vgg_weights_from_seed)
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.models.fast_path_q8_std import spade_q8_plan
from rpst_torch.models.spade_rp import SpadeRP
from rpst_torch.nn.blocks import init_torch_default, instance_norm
from rpst_torch.nn.spade import SPADE, SpadeResnetBlock
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.train.step import create_train_state, train_step
from test_torch_mrf import (OP_TOL, TOL, check_loss_grads_trajectory,
                            check_q8, check_stylize, check_steps, corpus,
                            port_log, run_serve, run_train)
from test_torch_sel_multi_adain import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _stats(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_instance_norm_matches_rpst(dtype):
    x = np.random.default_rng(0).normal(2.0, 3.0, (2, 5, 7, 6)) \
        .astype(np.float32)
    ref = jax_instance_norm(jnp.asarray(x, dtype))
    got = instance_norm(_nchw(x).to(torch.bfloat16 if dtype == jnp.bfloat16
                                    else torch.float32))
    assert str(got.dtype)[6:] == str(ref.dtype)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref, np.float32),
                               **(OP_TOL if dtype == jnp.float32
                                  else dict(rtol=2e-2, atol=2e-2)))


def _spade_inputs(seed, c=6, cond_c=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(1.0, 2.0, (2, 6, 5, c)).astype(np.float32),
            np.abs(rng.normal(size=(2, 6, 5, cond_c))).astype(np.float32))


@pytest.mark.parametrize("norm", ["instance", "syncbatch"])
@pytest.mark.parametrize("train", [False, True])
def test_spade_matches_flax(norm, train):
    """One SPADE: the param-free norm (running or batch statistics) times
    1 + gamma plus beta; the moved running statistics."""
    x, cond = _spade_inputs(1)
    jm = JaxSPADE(norm_nc=6, param_free_norm_type=norm)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond))
    v = dict(v)
    port = SPADE(6, norm, condition_nc=5)
    sd = from_flax_params(_stats(v["params"]))
    if norm != "instance":  # running statistics away from (0, 1)
        rng = np.random.default_rng(2)
        v["batch_stats"] = {"pf_bn": {
            "mean": rng.normal(size=6).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}}
        sd.update(from_flax_batch_stats(v["batch_stats"]))
    port.load_state_dict(sd)
    port.train(train)
    if train and norm != "instance":
        ref, muts = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), train=True,
                             mutable=["batch_stats"])
    else:
        ref = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), train=train)
    got = port(_nchw(x), _nchw(cond))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)
    if train and norm != "instance":
        for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                getattr(port.pf_bn, buf).numpy(),
                np.asarray(muts["batch_stats"]["pf_bn"][leaf]), rtol=1e-5,
                atol=1e-6, err_msg=leaf)


@pytest.mark.parametrize("norm", ["instance", "syncbatch"])
@pytest.mark.parametrize("fin,fout", [(6, 4), (6, 6)])
def test_spade_resnet_block_matches_flax(norm, fin, fout):
    """The learned bias-free 1x1 shortcut (fin != fout) and the identity
    one, train mode (batch statistics)."""
    x, cond = _spade_inputs(3, fin)
    jm = JaxSpadeResnetBlock(fin=fin, fout=fout, spade_norm=norm)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(cond))
    port = SpadeResnetBlock(fin, fout, norm, condition_nc=5)
    sd = from_flax_params(_stats(v["params"]))
    sd.update(from_flax_batch_stats(_stats(v.get("batch_stats", {}))))
    port.load_state_dict(sd)
    assert port.learned_shortcut == (fin != fout)
    if norm == "instance":
        ref = jm.apply(v, jnp.asarray(x), jnp.asarray(cond))
    else:
        ref, _ = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), train=True,
                          mutable=["batch_stats"])
    port.train(norm != "instance")
    got = port(_nchw(x), _nchw(cond))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def test_condition_of_another_size_is_refused():
    x, cond = _spade_inputs(4)
    with pytest.raises(ValueError, match="differ in size"):
        SPADE(6, condition_nc=5)(_nchw(x), _nchw(cond)[:, :, :3])


def _running_stats(tree, rng):
    """flax ``batch_stats`` for every SPADE of a params tree: its pf_bn's
    running mean and variance, drawn away from (0, 1)."""
    out = {}
    for k, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        if "mlp_gamma" in sub:
            nc = sub["mlp_gamma"]["kernel"].shape[-1]
            out[k] = {"pf_bn": {
                "mean": rng.normal(size=nc).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, nc).astype(np.float32)}}
        else:
            inner = _running_stats(sub, rng)
            if inner:
                out[k] = inner
    return out


def _small_pair(norm, dtype=None, seed=5):
    """rpst's SpadeRP and the port's at a small width, on the seeded
    weights (flax's init takes ~25 s eagerly at this size)."""
    rng = np.random.default_rng(seed)
    c, s = (rng.random((2, 16, 16, 3), dtype=np.float32) for _ in range(2))
    jm = JaxSpadeRP(rp_blocks=3, hidden_dim=8, ndf=2, spade_norm=norm,
                    dtype=dtype)
    v = {"params": spade_weights_from_seed(seed, rp_blocks=3, hidden_dim=8,
                                           ndf=2)}
    if norm != "instance":
        v["batch_stats"] = _running_stats(v["params"], rng)
    port = SpadeRP(rp_blocks=3, hidden_dim=8, ndf=2, spade_norm=norm)
    sd = from_flax_params(v["params"])
    sd.update(from_flax_batch_stats(v.get("batch_stats", {})))
    port.load_state_dict(sd)
    return jm, v, port, c, s


@pytest.mark.parametrize("norm", ["instance", "syncbatch"])
def test_module_matches_flax(norm):
    """SpadeRP in eval mode (running statistics) against flax."""
    jm, v, port, c, s = _small_pair(norm)
    port.eval()
    ref = jm.apply(v, jnp.asarray(c), jnp.asarray(s))
    got = port(torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("norm", ["instance", "syncbatch"])
def test_module_in_bfloat16_computes_as_rpst(norm):
    """rpst's SpadeRP(dtype=bfloat16): bfloat16 encoders, the generator's
    convs promoted to float32, the BatchNorm's output cast to bfloat16; the
    port under bfloat16 autocast gives float32 out and lands within 1e-2
    of the span (the parent form, the generator in bfloat16, reads ~3x
    further at the fixture's width)."""
    jm, v, port, c, s = _small_pair(norm, jnp.bfloat16)
    port.eval()
    ref = np.asarray(jm.apply(v, jnp.asarray(c), jnp.asarray(s)))
    f32 = np.asarray(JaxSpadeRP(rp_blocks=3, hidden_dim=8, ndf=2,
                                spade_norm=norm).apply(
        v, jnp.asarray(c), jnp.asarray(s)))
    assert ref.dtype == np.float32
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = port(torch.from_numpy(c), torch.from_numpy(s))
    assert got.dtype == torch.float32
    span = float(f32.max() - f32.min())
    assert np.abs(got.detach().numpy() - ref).mean() < 1e-2 * span
    own = np.abs(ref - f32).mean()
    assert np.abs(got.detach().numpy() - ref).mean() < max(3 * own,
                                                           1e-3 * span)


# -------------------------------------------------------------- fixture

def test_stylize_matches_rpst():
    check_stylize("spade")


def test_q8_matches_rpst():
    """6 act scales and 4 B5 launches a stylize at hidden 32: each
    encoder's 128->256 and 256->512; the generator stays float."""
    check_q8("spade", spade_q8_plan, {"scales": 6, "B5": 4})


def test_loss_gradients_and_trajectory_match_rpst():
    check_loss_grads_trajectory("spade")


def test_train_config_yaml_has_no_int8_layer():
    """configs/TrainConfig.yaml (hidden 2): no width reaches 128, so q8
    launches no B5 (rpst's behaviour) and computes the float path."""
    cfg = load_config(str(REPO / "configs" / "TrainConfig.yaml"),
                      {"img_size": 16, "compute_dtype": "float32"})
    bundle = build_model(cfg)
    init_torch_default(bundle.model, 0)
    assert bundle.q8_infer()
    assert spade_q8_plan(bundle.std_weights(torch.float32)) == {
        "scales": 0, "B5": 0}
    rng = np.random.default_rng(7)
    c, s = (torch.from_numpy(rng.random((1, 16, 16, 3), dtype=np.float32))
            for _ in range(2))
    scales = bundle.calibrate_q8(c, s)
    assert len(scales["act_scales"]) == 0
    got = bundle.stylize_q8(c, s, scales, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), bundle.stylize(c, s).numpy(),
                               **OP_TOL)
    assert not build_model(cfg.replace(spade_norm="syncbatch")).q8_infer()


def test_skipped_step_restores_batchnorm_statistics():
    """syncbatch: a non-finite step leaves the pf_bn running statistics
    where they were (rpst's skip rolls back batch_stats)."""
    bundle = build_model(load_config(dict(
        network="spade", rp_blocks=3, hidden_dim=4, img_size=16,
        spade_norm="syncbatch")))
    init_torch_default(bundle.model, 0)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1)))
    rng = np.random.default_rng(8)
    c, s = (torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
            for _ in range(2))
    state = create_train_state(bundle)
    train_step(state, vgg, c, s)
    before = {k: v.clone() for k, v in state.model.named_buffers()}
    assert before and all(".pf_bn.running_" in k for k in before)
    bad = s.clone()
    bad[0, 0, 0, 0] = float("nan")
    assert float(train_step(state, vgg, c, bad)["skipped"]) == 1.0
    for k, v in state.model.named_buffers():
        assert torch.equal(v, before[k]), k
    assert float(train_step(state, vgg, c, s)["skipped"]) == 0.0
    assert any(not torch.equal(v, before[k])
               for k, v in state.model.named_buffers())


# -------------------------------------------------------------- drivers

def test_drivers_serve_and_train_on_cpu(tmp_path):
    """serve_torch.py standard and q8 (rp_blocks 4 at hidden 32: each
    encoder's 128->256 is int8, 4 scales), train_torch.py with the instance
    norm and with syncbatch, and on configs/TrainConfig.yaml (bfloat16)."""
    root = corpus(tmp_path)
    assert len(run_serve(root, "spade", "standard", rp_blocks=4)) == 2
    with port_log() as lines:
        assert len(run_serve(root, "spade", "q8", rp_blocks=4)) == 2
    assert "Calibrated 4 layer scales" in lines
    check_steps(run_train(root, "spade"))
    check_steps(run_train(root, "spade", "_bn", spade_norm="syncbatch"))
    import importlib.util
    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cli.main(["--config", str(REPO / "configs" / "TrainConfig.yaml"),
              "--device", "cpu", "--set", "img_size=32", "vgg=", "test_dir=",
              "num_workers=1", "max_iter=3", "log_iter=1",
              f"content_dir={root / 'content'}",
              f"style_dir={root / 'style'}", f"output={root / 'yaml'}"])
    import json
    check_steps([json.loads(ln) for ln in (root / "yaml" / "logs" /
                                           "metrics.jsonl").read_text()
                 .splitlines()], (1, 2))
