"""The LD family's int8 path and B5's 7x7 form on the CPU (the CPU runs the
wrapper's plain version; the CUDA kernel is held to it on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py phase 44).

  * ``fused_conv2d_q8_plain`` at K = 7 (reflect pad 3): exact against a
    numpy int64 oracle (the sums and the float32 epilogue written out), and
    against rpst's ``_xla_conv_q8`` on the same int8 inputs within one int8
    step, only at exact .5 ties (rpst divides by the output scale where B5
    multiplies by its stored reciprocal);
  * the wrapper's refusals (5x5 kernels, maps under 4x4, zero padding and
    C > 2048 at 7x7) and its route: a tensor off the CPU reaches the 7x7
    entry of the CUDA library or raises, never the plain version;
  * the ``q8_infer`` gates, case for case as rpst's ``tests/test_q8.py``;
  * v1 / v2 q8 stylize with rpst's scales against
    ``tests/fixtures/torch_port_ld_adain{,2}.npz`` (float32 around the int8
    layers >= 40 dB, bfloat16 >= 30 dB; the plans: 4 scales and 6 B5, two
    of them 7x7, for v1 at hidden 16; 4 and 4 for v2 at hidden 8), the
    calibration within 2e-2 of rpst's (rpst calibrates in bfloat16), and the
    int8 features of the first eligible layer from rpst's own int8 input
    within one step on under 1e-3 of the elements;
  * serve_torch.py --mode q8 for both on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.models import fast_path_q8 as jq8
from rpst_torch.config import load_config
from rpst_torch.models import ModelBundle
from rpst_torch.models.fast_path_q8 import _scale_rows
from rpst_torch.models.fast_path_q8_ld import ld_q8_plan
from rpst_torch.ops import conv2d_q8 as b5
from rpst_torch.ops.folded_conv_q8 import quantize_weights
from test_torch_mrf import (check_q8, fixture_bundle, load_fixture, port_log,
                            run_serve)
from test_torch_sel_multi_adain import _corpus as corpus
from torch_threads import one_torch_thread  # noqa: F401

# rpst's int8 features against the port's: at most one step, on under this
# share of the elements
FEATURE_TIES = 1e-3


def _layer7(seed, n, h, w, c, co):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    k = rng.integers(-127, 128, (7, 7, c, co), dtype=np.int8)
    sc = np.stack([rng.uniform(1e-5, 1e-4, co) * (64 / c),
                   rng.normal(0, 0.5, co),
                   rng.uniform(20.0, 80.0, co)]).astype(np.float32)
    return x, k, sc


def _oracle(x, k, sc, out_int8, alpha):
    """numpy: int64 sums over the reflect-padded input, then the kernel's
    float32 epilogue (two roundings, alpha * y below 0, a multiply by the
    stored reciprocal, half to even)."""
    p = k.shape[0] // 2
    xp = np.pad(x.astype(np.int64), ((0, 0), (p, p), (p, p), (0, 0)),
                mode="reflect")
    n, h, w, _ = x.shape
    acc = np.zeros((n, h, w, k.shape[3]), np.int64)
    for dr in range(k.shape[0]):
        for dc in range(k.shape[1]):
            acc += xp[:, dr:dr + h, dc:dc + w] @ k[dr, dc].astype(np.int64)
    y = (acc.astype(np.float32) * sc[0]).astype(np.float32) + sc[1]
    y = np.where(y >= 0, y, np.float32(alpha) * y).astype(np.float32)
    if out_int8:
        return np.clip(np.rint(y * sc[2]), -127, 127).astype(np.int8)
    return torch.from_numpy(y).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 4, 4, 4, 4), (2, 5, 17, 36, 68),
                                   (1, 17, 33, 64, 132)])
@pytest.mark.parametrize("out_int8,alpha", [(True, 0.2), (False, 0.0)])
def test_7x7_plain_is_the_int64_oracle(shape, out_int8, alpha):
    x, k, sc = _layer7(sum(shape), *shape)
    got = b5.fused_conv2d_q8(torch.from_numpy(x), torch.from_numpy(k),
                             torch.from_numpy(sc), out_int8, alpha,
                             "reflect")
    want = _oracle(x, k, sc, out_int8, alpha)
    if out_int8:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("shape", [(2, 9, 11, 128, 128), (1, 8, 8, 256, 64)])
@pytest.mark.parametrize("out_scale", [None, 0.02])
def test_7x7_plain_matches_rpst_xla_conv_q8(shape, out_scale):
    """The same int8 input and float kernel through rpst's ``_xla_conv_q8``
    and through the port (the kernel quantized per output channel as both
    quantize it): bfloat16 out within one bfloat16 step (rpst casts its
    float32 value once, B5 rounds the same float32 value); int8 out within
    one step, only where rpst's ``f / out_scale`` sits at a .5 tie."""
    n, h, w, c, co = shape
    rng = np.random.default_rng(c + co)
    x_q = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    kf = rng.normal(0, (49 * c) ** -0.5, (7, 7, c, co)).astype(np.float32)
    bias = rng.normal(0, 0.1, co).astype(np.float32)
    x_s = 0.01
    ref = np.asarray(jq8._xla_conv_q8(
        jnp.asarray(x_q), x_s, jnp.asarray(kf), jnp.asarray(bias),
        jnp.bfloat16, out_scale=out_scale, alpha=0.2))
    w_q, w_scale = quantize_weights(torch.from_numpy(kf))
    rows = torch.stack([x_s * w_scale, torch.from_numpy(bias),
                        torch.zeros(co) if out_scale is None
                        else torch.full((co,), 1.0 / out_scale)])
    got = b5.fused_conv2d_q8(torch.from_numpy(x_q), w_q.contiguous(), rows,
                             out_scale is not None, 0.2, "reflect")
    if out_scale is None:
        ref = torch.from_numpy(ref.astype(np.float32))
        torch.testing.assert_close(got.float(), ref, rtol=8e-3, atol=1e-6)
        return
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < FEATURE_TIES, \
        (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("bad,match", [
    (dict(k=(5, 5, 8, 8)), r"K in \(3, 7\)"),
    (dict(x=(1, 3, 8, 8)), "H, W >= 4 for a 7x7"),
    (dict(pad="zero"), "reflect padding"),
    (dict(x=(1, 4, 4, 2052), k=(7, 7, 2052, 4)), "C <= 2048"),
])
def test_7x7_wrapper_refuses(bad, match):
    x = torch.zeros(bad.get("x", (1, 4, 4, 8)), dtype=torch.int8)
    k = torch.zeros(bad.get("k", (7, 7, 8, 8)), dtype=torch.int8)
    sc = torch.zeros((3, k.shape[3]))
    with pytest.raises(ValueError, match=match):
        b5.fused_conv2d_q8(x, k, sc, True, 0.2, bad.get("pad", "reflect"))


def test_7x7_off_the_cpu_reaches_its_kernel_or_raises(monkeypatch):
    """A tensor off the CPU never takes the plain version: the 7x7 weight
    goes to the library's 7x7 entry (with the packed weights it reads), and
    without a card or nvcc that launch raises."""
    from rpst_torch.kernels import build
    x = torch.zeros((1, 4, 4, 32), dtype=torch.int8, device="meta")
    k = torch.zeros((7, 7, 32, 8), dtype=torch.int8, device="meta")
    sc = torch.zeros((3, 8), device="meta")
    monkeypatch.setattr(b5, "check_q8_tensors", lambda *a: None)
    monkeypatch.setattr(b5, "fused_conv2d_q8_plain", None)  # never called
    calls = []

    def fake_launch(lib, fn, what, *args):
        calls.append((lib, fn, tuple(args[1].shape)))
        raise RuntimeError("no card")
    monkeypatch.setattr(build, "launch", fake_launch)
    before = (b5.fused_conv2d_q8.launches, b5.fused_conv2d_q8.launches_7x7)
    with pytest.raises(RuntimeError, match="no card"):
        b5.fused_conv2d_q8(x, k, sc, True, 0.2, "reflect")
    assert calls == [("conv2d_q8_7x7", "rpst_conv2d_q8_7x7",
                      (7, 7, 1, 1, 2, 8, 16))]
    assert (b5.fused_conv2d_q8.launches,
            b5.fused_conv2d_q8.launches_7x7) == before
    monkeypatch.undo()
    monkeypatch.setattr(b5, "check_q8_tensors", lambda *a: None)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError):
        b5.fused_conv2d_q8(x, k, sc, True, 0.2, "reflect")


@pytest.mark.parametrize("c,co", [(4, 4), (36, 132), (128, 64)])
def test_7x7_packed_weights_are_the_hwio_weights_k_major(c, co):
    """The 7x7 kernel's packing: K-major core matrices of wgmma, (7, 7,
    steps, Co groups of 8, 2 K halves, 8 channels, 16 bytes), zeros past C
    and Co; element by element packed[dr, dc, s, q, h, r, b] = w[dr, dc, 32
    s + 16 h + b, 8 q + r]."""
    g = torch.Generator().manual_seed(c + co)
    w = torch.randint(-127, 128, (7, 7, c, co), generator=g).to(torch.int8)
    packed = b5.pack_conv2d_weights(w)
    steps, groups = -(-c // 32), -(-co // 8)
    assert packed.shape == (7, 7, steps, groups, 2, 8, 16)
    assert packed.is_contiguous()
    back = packed.permute(0, 1, 2, 4, 6, 3, 5).reshape(7, 7, steps * 32,
                                                       groups * 8)
    assert torch.equal(back[:, :, :c, :co], w)
    assert not back[:, :, c:].any() and not back[:, :, :, co:].any()
    dr, dc, s, q, h, r, b = 3, 5, steps - 1, groups - 1, 0, 1, 2
    want = w[dr, dc, 32 * s + 16 * h + b, 8 * q + r] \
        if 32 * s + 16 * h + b < c and 8 * q + r < co else 0
    assert int(packed[dr, dc, s, q, h, r, b]) == int(want)
    with pytest.raises(ValueError, match="pack_conv2d_weights"):
        b5.pack_conv2d_weights(w.to(torch.bfloat16))


def test_7x7_plan_counts_the_kernels_tiles_and_bytes():
    """``b5_7x7_plan`` at LD v1's shapes and the tiling's edges, and its
    constants against the kernel source's: the weight and halo bytes a
    launch stages from L2 (the widest shape within the 4 GB budget), the
    grid padded to the cluster, the channel blocks' rows."""
    import re
    from pathlib import Path
    src = (Path(b5.__file__).resolve().parent.parent / "csrc"
           / "conv2d_q8_7x7.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)[;,]", src)[1])
    assert (const("TH"), const("TCO"), const("CLUSTER"), const("STAGES")) \
        == (b5.TILE_7X7, b5.TCO_7X7, b5.CLUSTER_7X7, b5.STAGES_7X7)
    assert re.search(r"THREADS = CONSUMERS \* 128 \+ 128", src) \
        and const("CONSUMERS") * 128 + 128 == b5.THREADS_7X7
    wide = b5.b5_7x7_plan(2, 512, 512, 256, 256)
    assert wide["items"] == 2048 and wide["grid"] == 132
    assert wide["weight_bytes"] == 2048 * 49 * 8 * 128 * 32
    assert wide["halo_bytes"] == 4096 * 8 * 22 * 22 * 32
    assert wide["l2_bytes"] == 3_795_845_120 < 4e9
    narrow = b5.b5_7x7_plan(2, 512, 512, 128, 128)
    assert (narrow["weight_bytes"], narrow["halo_bytes"]) == (
        1024 * 49 * 4 * 128 * 32, 2048 * 4 * 22 * 22 * 32)
    tiny = b5.b5_7x7_plan(1, 4, 4, 4, 4)
    assert tiny["items"] == 1 and tiny["grid"] == 2
    assert tiny["weight_bytes"] == 49 * 8 * 32  # 4 channels padded to 8
    ragged = b5.b5_7x7_plan(3, 17, 33, 36, 260)
    assert ragged["items"] == 3 * 3 * 3 and ragged["grid"] == 54
    assert ragged["weight_bytes"] == 9 * 49 * 2 * (128 + 128 + 8) * 32
    assert wide["smem_bytes"] == (b5.STAGES_7X7 * 7 * 4096 + 2 * 15488
                                  + 8 * 2 * (b5.STAGES_7X7 + 2)) <= 232448


# ---------------------------------------------------------------- gates

def _gate(**kw):
    """``q8_infer`` of a config (the gate reads the config alone, so an
    inception stack, which the port builds only in slice 4, can be asked)."""
    cfg = load_config(dict(dict(img_size=32), **kw))
    return ModelBundle(network=cfg.network, model=None, cfg=cfg,
                       device=torch.device("cpu")).q8_infer()


def test_q8_gates_match_rpst():
    """Case for case rpst's ``tests/test_q8.py::test_q8_ld_gate``."""
    assert _gate(network="ld_adain", hidden_dim=16, rp_blocks=5)
    assert _gate(network="ld_adain2", hidden_dim=8, rp_blocks=5)
    assert not _gate(network="ld_adain2", img_size=33, hidden_dim=8,
                     rp_blocks=5)
    assert not _gate(network="ld_adain2", hidden_dim=4, rp_blocks=5)
    assert not _gate(network="ld_adain2", hidden_dim=8, rp_blocks=5,
                     use_mask=True)
    assert not _gate(network="ld_adain", hidden_dim=4, rp_blocks=5)
    assert not _gate(network="ld_adain", hidden_dim=16, rp_blocks=5,
                     use_mask=True)
    assert not _gate(network="ld_adain", hidden_dim=16, rp_blocks=5,
                     inception_num=1)
    assert not _gate(network="ld_adain", hidden_dim=128, ld_layer_num=1)
    assert not _gate(network="ld_adain5", hidden_dim=16, rp_blocks=5)
    # v1 takes any image size (its 7x7 pads by reflection); v3, v4 never
    assert _gate(network="ld_adain", img_size=33, hidden_dim=16,
                 rp_blocks=5)
    assert not _gate(network="ld_adain3", hidden_dim=128)
    assert not _gate(network="ld_adain4", hidden_dim=128)


# -------------------------------------------------------------- fixture

@pytest.mark.parametrize("network,plan", [
    ("ld_adain", {"scales": 4, "B5": 6, "B5_7x7": 2}),
    ("ld_adain2", {"scales": 4, "B5": 4, "B5_7x7": 0})])
def test_q8_matches_rpst(network, plan):
    """v1 at hidden 16: layers 3 and 4 (128 -> 128, 256 -> 256, each a 3x3
    and a 7x7) and decoder convs 0 and 1; v2 at hidden 8: layer 4's small
    branch, conv_a and conv_b, and decoder conv 0."""
    check_q8(network, ld_q8_plan, plan)


@pytest.mark.parametrize("network", ["ld_adain", "ld_adain2"])
def test_int8_features_match_rpst(network):
    """The first eligible layer from rpst's own int8 input (the fixture's
    ``q8_in``, rpst's float32 pass quantized with its scale): v1's 3x3 and
    7x7 branches requantized to the shared scale and concatenated, v2's
    conv_a requantized to the chain scale, against rpst's ``q8_out``."""
    fx = load_fixture(network)
    bundle, _ = fixture_bundle(network, fx)
    enc_q, _ = bundle.q8_weights()
    layer = int(fx["q8_layer"])
    act = [float(a) for a in fx["act_scales"]]
    x_q = torch.from_numpy(fx["q8_in"])
    if network == "ld_adain":
        small, big = enc_q[layer]
        assert big.w_q.shape[0] == 7
        outs = [b5.fused_conv2d_q8(x_q, q.w_q, _scale_rows(act[0], q, act[1]),
                                   True, 0.2, "reflect") for q in (small, big)]
        got = torch.cat(outs, dim=-1)
    else:
        q_a = enc_q[layer][1]
        got = b5.fused_conv2d_q8(x_q, q_a.w_q, _scale_rows(act[1], q_a,
                                                           act[2]),
                                 True, 0.0, "reflect")
    diff = np.abs(got.numpy().astype(np.int32)
                  - fx["q8_out"].astype(np.int32))
    assert got.shape == fx["q8_out"].shape
    assert diff.max() <= 1 and (diff > 0).mean() < FEATURE_TIES, \
        (diff.max(), (diff > 0).mean())


# -------------------------------------------------------------- drivers

@pytest.mark.parametrize("network,scales", [("ld_adain", 2),
                                            ("ld_adain2", 4)])
def test_serve_q8_on_cpu(tmp_path, network, scales):
    """serve_torch.py --mode q8 at 32px, 3 layers of width 32 .. 128 (v1:
    layer 2 and decoder conv 0 are eligible; v2: layer 2's three convs and
    decoder conv 0); no kernel launches on the CPU."""
    root = corpus(tmp_path)
    with port_log() as lines:
        assert len(run_serve(root, network, "q8")) == 2
    assert f"Calibrated {scales} layer scales" in lines
    assert "B5 fused_conv2d_q8 launches: 0" in lines
