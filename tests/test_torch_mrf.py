"""mrf (MRFRP: two RP encoders, a channel concat, a halving decoder, the
MRF loss) of the port on the CPU, and the helpers the slice-5b tests share
(tests/test_torch_spade.py, test_torch_seg_adain.py,
test_torch_wct_train.py).

Live rpst at op size: ``cal_dist``, ``cal_affinity_map``, the streamed
``mrf_topk_masked_dist_sum`` against the dense route, ``mrf_loss`` (value
and gradient; bfloat16 features keep their type), the module against flax.
At model size against ``tests/fixtures/torch_port_mrf.npz``
(``tools/make_torch_port_fixture.py --mrf``: rpst's stylize, int8 stylize,
loss parts, gradients and 3-step trajectory at 64px, batch 2, full width):
no JAX compile.

Tolerances: the ops 1e-5 (rtol = atol; the 0/1 masks equal); modules and
the float32 stylize 1e-4 (rpst's ``tests/test_folded.py``); the bfloat16
stylize against rpst's bfloat16 one MAE < 1e-2, or ``BF16_OWN`` (3) x
rpst's own bfloat16 distance from its float32 output where that is more
(each framework rounds bfloat16 at its own places; the slice-4 rule); q8
with rpst's scales PSNR >= 40 dB in float32 around the int8 layers, >= 30
dB in bfloat16 (a one-ulp float statistic moves a requantization by a
step); calibration scales rtol 2e-2 (rpst calibrates in bfloat16); loss
parts rtol 1e-4; gradients: the port's float64 gradients (the model run in
float64) against rpst's float64 ones (the fixtures' ``f64/`` keys), each
leaf's norm rtol 1e-4, every bias and the [..., :8, :8] corner of every
kernel rtol 5e-3, atol 1e-4 x the patch's max: the function is the same
(they read within 6e-5 of max; both frameworks reduce the AdaIN / style
statistics in float32 even there). The float32 gradients: each leaf's
norm rtol 1e-3, or twice rpst's worst own error (below) where that is
more, the biases and
corners rtol 5e-3 with atol 1e-4 x the max, or ``GRAD_SPREAD`` (2) x the
larger of the two frameworks' own float32 errors (each one's float32
gradient against its own float64 one, relative to the max) where that is
more. The port's own error is measured because the CPU's float32 convs
(oneDNN) sum over the 8192 positions of a 64px batch of 2 less exactly
than XLA: up to 5.6e-4 of max at the fixtures' point, where rpst's own
reads up to 2e-4. The port's own error is capped at ``MAX_OWN`` (3e-3), or
at twice rpst's worst own error over the network where that is more: what
float32 is good for at the fixture's point (mrf's encoders 1.5e-3 in both
frameworks, the MRF distances' cancellation; spade up to 1.1e-2 in rpst
and 1.1e-2 in the port, the instance norms of its 2- to 32-channel maps),
so that a path that falls to bfloat16 still fails. A tensor whose float64 gradient in rpst is below ``ZERO_GRAD``
(1e-9) x the largest is zero up to rounding (spade's biases before an
instance norm: 1e-16 in float64, 1e-8 in float32 in both frameworks): the
port's is held below ``NOISE`` (1e-7) x the largest. The trajectory's
first loss rtol
1e-4, steps 2-3 rtol 1e-2 (Adam's first steps move each weight by about lr
whatever its gradient's size, so float32 noise in small gradients moves the
later losses).
"""

import contextlib
import json
import logging
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.models.mrf_rp import MRFRP as JaxMRFRP
from rpst.models.mrf_rp import mrf_loss as jax_mrf_loss
from rpst.ops import affinity as jaff
from rpst_torch.bridge import (from_flax_params, mrf_weights_from_seed,
                               vgg_from_flax, vgg_weights_from_seed)
from rpst_torch.config import load_config
from rpst_torch.models import build_model
from rpst_torch.models.fast_path_q8_std import mrf_q8_plan
from rpst_torch.models.mrf_rp import MRFRP, mrf_loss
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.ops import affinity as aff
from rpst_torch.train.checkpoint import restore_checkpoint
from rpst_torch.train.step import adam_count, create_train_state, train_step
from test_torch_sel_multi_adain import TOOL, _module, psnr
from test_torch_sel_multi_adain import _corpus as corpus
from test_torch_sel_multi_adain import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
OP_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_MAE = 1e-2
BF16_OWN = 3.0
GRAD_SPREAD = 2.0
MAX_OWN = 3e-3
ZERO_GRAD, NOISE = 1e-9, 1e-7
TRAJECTORY_RTOL = 1e-2


# ------------------------------------------------------- shared helpers

def load_fixture(network):
    """The slice-5b fixture's arrays, by key."""
    with np.load(TOOL.SLICE5B_DST[network]) as npz:
        return {k: npz[k] for k in npz.files}


def fixture_bundle(network, fx, **over):
    """The port's bundle and VGG at the fixture's config, weights (drawn
    from ``weights_seed``) and VGG seed."""
    cfg = dict(TOOL.SLICE5B[network], img_size=fx["content"].shape[1],
               lr=float(fx["lr"]), lr_decay=float(fx["lr_decay"]),
               **TOOL.SLICE5B_LOSS)
    bundle = build_model(load_config(dict(cfg, **over)))
    bundle.load_state_dict(from_flax_params(TOOL.slice5b_params(
        network, int(fx["weights_seed"]))))
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    return bundle, vgg


def images(fx):
    return torch.from_numpy(fx["content"]), torch.from_numpy(fx["style"])


def check_stylize(network):
    """The float32 stylize against rpst's, the bfloat16 one against rpst's
    bfloat16 one; no int8 kernel runs."""
    fx = load_fixture(network)
    bundle, _ = fixture_bundle(network, fx)
    c, s = images(fx)
    got = bundle.stylize(c, s)
    assert got.shape == fx["out_f32"].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), fx["out_f32"], **TOL)
    bf16, _ = fixture_bundle(network, fx, compute_dtype="bfloat16")
    out = bf16.stylize(c, s)
    assert out.dtype == torch.float32
    own = np.abs(fx["out_bf16"] - fx["out_f32"]).mean()
    mae = np.abs(out.numpy() - fx["out_bf16"]).mean()
    assert mae < max(BF16_MAE, BF16_OWN * own), (mae, own)
    return fx


def check_q8(network, plan_fn, want_plan):
    """The int8 plan (scales, B5 launches), calibration and the int8
    stylize with rpst's scales; foreign scales are refused."""
    fx = load_fixture(network)
    bundle, _ = fixture_bundle(network, fx)
    c, s = images(fx)
    assert bundle.q8_infer()
    plan = plan_fn(bundle.std_weights(torch.float32))
    assert plan == want_plan
    assert len(fx["act_scales"]) == plan["scales"]
    own = bundle.calibrate_q8(c, s)["act_scales"]
    np.testing.assert_allclose(own, fx["act_scales"], rtol=2e-2)
    scales = {"act_scales": fx["act_scales"]}
    reads = {}
    for dt, key, limit in ((torch.float32, "out_q8_f32", 40.0),
                           (torch.bfloat16, "out_q8_bf16", 30.0)):
        got = bundle.stylize_q8(c, s, scales, dtype=dt)
        assert got.dtype == torch.float32 and got.shape == fx[key].shape
        reads[key] = psnr(got.numpy(), fx[key])
        assert reads[key] >= limit, (key, reads[key])
    with pytest.raises(ValueError, match="act scales"):
        bundle.stylize_q8(c, s, {"act_scales": fx["act_scales"][:3]})
    return reads


def _grads(model):
    """name -> gradient (zeros where the loss has no path, as jax.grad)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in model.named_parameters()}


def port_name(path):
    """A flax param path's name in the port (conv kernels become OIHW
    ``weight``s; the LD v5 upsamplers' ``kernel`` keeps flax's name and
    layout)."""
    name = path.replace("/", ".")
    return name if re.search(r"(^|\.)up_\d+\.kernel$", name) else \
        name.replace("kernel", "weight")


def check_grads(grads, grads64, fx, f64_atol=1e-4):
    """The port's float32 and float64 gradients (name -> tensor) against the
    fixture's norms, biases and kernel corners (see the module docstring);
    returns the count held."""
    keys = [k for k in fx if k.partition("/")[0] in ("grads", "gradpatch")]
    top = max(float(np.abs(fx[f"f64/{k}"]).max()) for k in keys)
    live = [k for k in keys
            if float(np.abs(fx[f"f64/{k}"]).max()) >= ZERO_GRAD * top]
    # rpst's worst float32 error over the network: what float32 is good
    # for at the fixture's point
    rpst_worst = max(float(np.abs(fx[k] - fx[f"f64/{k}"]).max())
                     / float(np.abs(fx[f"f64/{k}"]).max()) for k in live)
    zero = set()
    checked = set()
    for key in keys:
        ref, ref64 = fx[key], fx[f"f64/{key}"]
        kind, _, path = key.partition("/")
        name = port_name(path)
        got, got64 = ((g if kind == "grads" else (
            g if name.endswith(".kernel") else g.permute(2, 3, 1, 0))[
                ..., :8, :8]).double().numpy()
            for g in (grads[name], grads64[name]))
        checked.add(name)
        if key not in live:
            # zero up to rounding (a bias before an instance norm)
            assert float(np.abs(got).max()) <= NOISE * top, name
            assert float(np.abs(got64).max()) <= ZERO_GRAD * top, name
            zero.add(name)
            continue
        size = float(np.abs(ref64).max())
        np.testing.assert_allclose(got64, ref64, rtol=5e-3,
                                   atol=f64_atol * size,
                                   err_msg=f"{name} float64")
        own_rpst = float(np.abs(ref - ref64).max()) / size
        own_port = float(np.abs(got - got64).max()) / size
        assert own_port <= max(MAX_OWN, GRAD_SPREAD * rpst_worst), \
            (name, own_port, rpst_worst)
        np.testing.assert_allclose(
            got, ref, rtol=5e-3,
            atol=max(f64_atol, GRAD_SPREAD * max(own_rpst, own_port)) * size,
            err_msg=name)
    for key in fx:
        kind, _, path = key.partition("/")
        name = port_name(path)
        if kind == "gradnorm" and name not in zero:
            np.testing.assert_allclose(float(grads64[name].norm()),
                                       float(fx[f"f64/{key}"]), rtol=1e-4,
                                       err_msg=f"{name} float64")
            np.testing.assert_allclose(
                float(grads[name].norm()), float(fx[key]),
                rtol=max(1e-3, GRAD_SPREAD * rpst_worst), err_msg=name)
    assert checked == set(grads), set(grads) - checked
    return len(checked)


def _f64_calc_mean_std(feat, eps=1e-5):
    """The port's ``calc_mean_std`` with its reductions in the features'
    own type (it casts them to float32, as rpst does)."""
    mean = feat.mean(dim=(1, 2), keepdim=True)
    n = feat.shape[1] * feat.shape[2]
    var = ((feat - mean) ** 2).sum(dim=(1, 2), keepdim=True) / max(n - 1, 1)
    return mean, torch.sqrt(var + eps)


@contextlib.contextmanager
def float64_stats():
    """The port's feature statistics (AdaIN, the style loss) in float64
    inside the block: the float64 runs held against the LD fixtures, whose
    rpst float64 gradients take them so (tools/make_torch_port_fixture.py
    ``ld_f64_stats``)."""
    from rpst_torch.models import base
    from rpst_torch.ops import stats
    old = stats.calc_mean_std, base.calc_mean_std
    stats.calc_mean_std = base.calc_mean_std = _f64_calc_mean_std
    try:
        yield
    finally:
        stats.calc_mean_std, base.calc_mean_std = old


def check_part(key, got, got64, fx):
    """A float32 loss part against rpst's at rtol 1e-4; where the fixture
    holds rpst's float64 part (``f64/<part>``, mrf's), the two float64
    parts agree to 1e-6 (rpst rounds the style statistics to float32 also
    in float64: 2.2e-8 apart) and the float32 bound is 2 x the larger of the two
    frameworks' own float32 errors where that is more (mrf's k-th
    similarity choice is discontinuous: a near-tie that float32 swaps moves
    the loss; the port's own error there reads 8.0e-4 on an AVX-512 CPU
    with one torch thread, rpst's 4.7e-5)."""
    ref = float(fx[key])
    rtol = 1e-4
    if f"f64/{key}" in fx:
        ref64 = float(fx[f"f64/{key}"])
        np.testing.assert_allclose(got64, ref64, rtol=1e-6,
                                   err_msg=f"{key} float64")
        own = max(abs(got - got64), abs(ref - ref64)) / abs(ref64)
        rtol = max(rtol, GRAD_SPREAD * own)
    np.testing.assert_allclose(got, ref, rtol=rtol, err_msg=key)


def check_loss_grads_trajectory(network, label=None, freeze=(),
                                f64_atol=1e-4, f64_stats=False):
    """3 train steps (with ``label`` as content labels, ``freeze`` left out
    of the optimizer) against rpst's trajectory; the first step's loss
    parts and its gradients, read before Adam applies them, against rpst's
    float32 ones, with the model's float64 gradients against rpst's float64
    ones. Returns the stepped state. ``f64_atol``: the float64 gradients'
    bound (x max), and the float32 ones' floor; ``f64_stats``: the float64
    run takes its feature statistics in float64 (the LD fixtures')."""
    fx = load_fixture(network)
    c, s = images(fx)
    kw = {} if label is None else {"content_label": label}
    b64, vgg64 = fixture_bundle(network, fx)
    b64.model.double().train()
    with float64_stats() if f64_stats else contextlib.nullcontext():
        total, parts64 = b64.loss(vgg64.double(), c.double(), s.double(),
                                  **kw)
        total.backward()
    bundle, vgg = fixture_bundle(network, fx)
    state = create_train_state(bundle, freeze_prefixes=freeze)
    first = {}

    def keep(optimizer, args, kwargs):
        if not first:
            first.update({k: g.clone()
                          for k, g in _grads(bundle.model).items()})

    hook = state.optimizer.register_step_pre_hook(keep)
    steps = [train_step(state, vgg, c, s, **kw)
             for _ in range(len(fx["trajectory"]))]
    hook.remove()
    parts = {k: v for k, v in steps[0].items() if k != "skipped"}
    assert set(parts) == {k for k in fx
                          if k.endswith("_loss") and "/" not in k}
    for k, v in parts.items():
        check_part(k, float(v), float(parts64[k]), fx)
    check_grads(first, _grads(b64.model), fx, f64_atol)
    losses = [float(p["total_loss"]) for p in steps]
    np.testing.assert_allclose(losses[1:], fx["trajectory"][1:],
                               rtol=TRAJECTORY_RTOL)
    assert state.step == 3 and adam_count(state.optimizer) == 3
    return state


# ---------------------------------------------------------------- drivers

def run_serve(root: Path, network: str, mode: str, **over):
    """serve_torch.py in this process on the corpus at 32px, full width
    (hidden 32: int8 layers exist): the written images and the log."""
    cfg = root / f"serve_{network}_{mode}.yaml"
    cfg.write_text(json.dumps(dict(dict(network=network, rp_blocks=3,
                                        hidden_dim=32, img_size=32), **over)))
    out = root / f"out_{network}_{mode}"
    argv = ["serve_torch.py", "--config", str(cfg), "--content",
            str(root / "content"), "--style", str(root / "style"), "--out",
            str(out), "--mode", mode, "--batch", "2", "--device", "cpu"]
    old = __import__("sys").argv
    __import__("sys").argv = argv
    try:
        _module("serve_torch").main()
    finally:
        __import__("sys").argv = old
    return sorted(out.glob("*.png"))


def run_train(root: Path, network: str, tag: str = "", max_iter: int = 4,
              **over):
    """train_torch.py in this process at 32px, batch 2 (max_iter - 1
    steps); the metric lines."""
    out = root / f"train_{network}{tag}"
    cfg = root / f"train_{network}{tag}.yaml"
    cfg.write_text(json.dumps(dict(dict(
        network=network, rp_blocks=3, hidden_dim=8, img_size=32,
        batch_size=2, num_workers=1, max_iter=max_iter,
        snapshot_save_iter=10, content_dir=str(root / "content"),
        style_dir=str(root / "style"), output=str(out)), **over)))
    _module("train_torch").main(["--config", str(cfg), "--device", "cpu"])
    return [json.loads(ln) for ln in
            (out / "logs" / "metrics.jsonl").read_text().splitlines()]


def check_steps(lines, steps=(1, 2, 3)):
    assert [ln["step"] for ln in lines] == list(steps)
    assert all(np.isfinite(ln["total_loss"]) and ln["skipped"] == 0.0
               for ln in lines)


@contextlib.contextmanager
def port_log():
    """The messages the port's logger (which does not propagate) emits
    inside the block."""
    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())
    lines, handler = [], Keep()
    logger = logging.getLogger("rpst_torch")
    logger.addHandler(handler)
    # INFO whatever ran before in this process (the logger's level is set
    # where a driver configures it)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


# ------------------------------------------------------------------ ops

def _feats(seed, shape=(2, 6, 5, 16)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def test_cal_dist_matches_rpst():
    a, b = (np.random.default_rng(1).normal(size=(16, n)).astype(np.float32)
            for n in (30, 30))
    ref = np.asarray(jaff.cal_dist(jnp.asarray(a), jnp.asarray(b)))
    got = aff.cal_dist(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, **OP_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_cal_affinity_map_matches_rpst(reverse):
    cf, sf = _feats(2)
    for i in range(2):
        ref = np.asarray(jaff.cal_affinity_map(jnp.asarray(cf[i]),
                                               jnp.asarray(sf[i]), 3, reverse))
        got = aff.cal_affinity_map(torch.from_numpy(cf[i]),
                                   torch.from_numpy(sf[i]), 3, reverse)
        np.testing.assert_array_equal(got.numpy(), ref)
    batched = aff.cal_affinity_map(torch.from_numpy(cf), torch.from_numpy(sf),
                                   3, reverse)
    assert batched.shape == (2, 30, 30)
    np.testing.assert_array_equal(batched[1].numpy(), got.numpy())


@pytest.mark.parametrize("chunk", [7, 30, 64])
def test_streamed_sum_matches_the_dense_route_and_rpst(chunk):
    """Chunks that divide HW, do not, and exceed it."""
    cf, sf = _feats(3)
    c, s = torch.from_numpy(cf[0]), torch.from_numpy(sf[0])
    dense = (aff.cal_affinity_map(c, s, 4)
             * aff.cal_dist(c.reshape(-1, 16).T, s.reshape(-1, 16).T)).sum()
    got = aff.mrf_topk_masked_dist_sum(c, s, 4, chunk)
    ref = jaff.mrf_topk_masked_dist_sum(jnp.asarray(cf[0]),
                                        jnp.asarray(sf[0]), 4, chunk)
    np.testing.assert_allclose(float(got), float(dense), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("chunk", [0, 8])
def test_mrf_loss_and_its_gradient_match_rpst(chunk):
    """The value, and the gradient in the stylized features (the mask and
    the style side carry none)."""
    cf, sf = _feats(4)
    ref, ref_grad = jax.value_and_grad(
        lambda x: jax_mrf_loss(x, jnp.asarray(sf), 5, chunk))(
        jnp.asarray(cf))
    x = torch.from_numpy(cf).requires_grad_()
    y = torch.from_numpy(sf).requires_grad_()
    got = mrf_loss(x, y, 5, chunk)
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), **OP_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-4, atol=1e-6)
    # the style side's gradient is the distance term's own: the caller
    # stops it (MRFRP.loss takes the style features under no_grad)
    assert y.grad is not None


def test_mrf_loss_in_bfloat16_keeps_rpst_type():
    """rpst's mrf_loss on bfloat16 features (its bf16 VGG's relu4_1)
    computes in bfloat16; the port's keeps the type and lands near its
    value (the top-k of bfloat16 similarities ties where float32 would not,
    and either side may break a tie at another index)."""
    cf, sf = _feats(5, (2, 8, 8, 32))
    ref = jax_mrf_loss(jnp.asarray(cf, jnp.bfloat16),
                       jnp.asarray(sf, jnp.bfloat16), 5)
    got = mrf_loss(torch.from_numpy(cf).bfloat16(),
                   torch.from_numpy(sf).bfloat16(), 5)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(float(got), float(ref), rtol=2e-2)


def test_module_matches_flax():
    """MRFRP's forward and loss against rpst's flax module at a small
    width, on the seeded weights."""
    rng = np.random.default_rng(6)
    c, s = (rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(2))
    jm = JaxMRFRP(rp_blocks=3, hidden_dim=8, k=3)
    v = {"params": mrf_weights_from_seed(6, rp_blocks=3, hidden_dim=8)}
    port = MRFRP(rp_blocks=3, hidden_dim=8, k=3)
    port.load_state_dict(from_flax_params(v["params"]))
    ref = jm.apply(v, jnp.asarray(c), jnp.asarray(s))
    got = port(torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    vgg_vars = vgg_weights_from_seed(1)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_vars))
    from rpst.nn.vgg import VGG19Encoder as JaxVGG
    jvgg = JaxVGG(num_stages=4)
    ref_parts = jm.apply(v, lambda x: jvgg.apply(vgg_vars, x),
                         jnp.asarray(c), jnp.asarray(s), method=jm.loss)
    parts = port.loss(vgg, torch.from_numpy(c), torch.from_numpy(s))
    for k, r in ref_parts.items():
        np.testing.assert_allclose(float(parts[k]), float(r), rtol=1e-4,
                                   err_msg=k)


# -------------------------------------------------------------- fixture

def test_stylize_matches_rpst():
    check_stylize("mrf")


def test_q8_matches_rpst():
    """9 act scales and 7 B5 launches a stylize at hidden 32: each encoder
    128->256, 256->512; the decoder 1024->512, 512->256, 256->128."""
    check_q8("mrf", mrf_q8_plan, {"scales": 9, "B5": 7})


def test_loss_gradients_and_trajectory_match_rpst():
    check_loss_grads_trajectory("mrf")


def test_streamed_loss_at_the_fixture_differs_only_at_exact_ties():
    """At the fixture, relu4_1 repeats positions, so some k-th
    similarities tie exactly: the dense route takes the lower index (as
    rpst's lax.top_k), the streamed one every tied pair (rpst's documented
    difference). The streamed loss equals the sum under the threshold
    union mask, and that mask differs from the dense one only at ties."""
    fx = load_fixture("mrf")
    bundle, vgg = fixture_bundle("mrf", fx, mrf_chunk=16)
    assert bundle.model.mrf_chunk == 16
    c, s = images(fx)
    _, parts = bundle.loss(vgg, c, s)
    with torch.no_grad():
        f, g = vgg(bundle.model(c, s))[-1], vgg(s)[-1]
    n, h, w, ch = f.shape
    totals = []
    for i in range(n):
        a, b = f[i].reshape(-1, ch), g[i].reshape(-1, ch)
        sim = aff.l2_normalize_channels(a[None])[0] \
            @ aff.l2_normalize_channels(b[None])[0].T
        row = torch.topk(sim, 5, dim=1).values[:, -1:]
        col = torch.topk(sim, 5, dim=0).values[-1:]
        union = (sim >= row) | (sim >= col)
        dense = aff.cal_affinity_map(f[i], g[i], 5).bool()
        ties = (sim == row) | (sim == col)
        assert not ((union != dense) & ~ties).any()
        totals.append(float((union * aff.cal_dist(a.T, b.T)).sum()))
    np.testing.assert_allclose(float(parts["mrf_loss"]),
                               np.mean(totals) / (h * w * 5), rtol=1e-5)
    np.testing.assert_allclose(float(parts["mrf_loss"]),
                               float(fx["mrf_loss"]), rtol=2e-3)


# -------------------------------------------------------------- drivers

def test_drivers_serve_and_train_on_cpu(tmp_path):
    """serve_torch.py standard and q8 (rp_blocks 3 at hidden 32: only the
    decoder's 256->128 is int8, one scale; no kernel launches on the CPU),
    train_torch.py with the MRF term weighted in."""
    root = corpus(tmp_path)
    assert len(run_serve(root, "mrf", "standard")) == 2
    with port_log() as lines:
        assert len(run_serve(root, "mrf", "q8")) == 2
    assert "Calibrated 1 layer scales" in lines
    assert "B5 fused_conv2d_q8 launches: 0" in lines
    check_steps(run_train(root, "mrf", mrf_weight=1.0))


def test_train_resume_continues(tmp_path):
    root = corpus(tmp_path)
    run_train(root, "mrf", max_iter=3, snapshot_save_iter=2)
    lines = run_train(root, "mrf", max_iter=3, resume=True)
    check_steps(lines, (1, 2, 3, 4))
    state = create_train_state(build_model(load_config(dict(
        network="mrf", rp_blocks=3, hidden_dim=8, img_size=32))))
    restore_checkpoint(root / "train_mrf" / "checkpoints" / "4", state)
    assert state.step == 4 and adam_count(state.optimizer) == 4
