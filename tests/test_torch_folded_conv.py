"""B1 (rpst_torch.ops.folded_conv): the plain version against rpst's Pallas
kernel in interpret mode and against rpst's XLA ring path; the wrapper's
dispatch, checks and launch count; the nvcc build's failure modes. The
kernel itself runs only on the card: tests/test_torch_cuda_kernels.py."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpst.ops.folded import fold_bias as j_fold_bias
from rpst.ops.folded import fold_conv_kernel as j_fold_conv_kernel
from rpst.ops.folded import folded_conv as j_folded_conv
from rpst.ops.pallas.folded_conv import fused_folded_conv as j_fused
from rpst_torch.kernels import build
from rpst_torch.ops.folded_conv import (folded_conv_lrelu, folded_conv_relu,
                                        fused_folded_conv,
                                        fused_folded_conv_plain)


def _layer(rng, n, h, w, c, co):
    """Folded x (n, h, w, 4c) and the folded kernel/bias of a random 3x3
    c -> co conv, as (jax, torch) pairs."""
    x = rng.standard_normal((n, h, w, 4 * c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.2).astype(np.float32)
    b = rng.standard_normal((co,)).astype(np.float32)
    kf = np.array(j_fold_conv_kernel(jnp.asarray(k)))
    bf = np.array(j_fold_bias(jnp.asarray(b)))
    return ((jnp.asarray(x), jnp.asarray(kf), jnp.asarray(bf)),
            (torch.from_numpy(x), torch.from_numpy(kf), torch.from_numpy(bf)))


@pytest.mark.parametrize("alpha", [0.2, 0.0])
@pytest.mark.parametrize("h,w,bs", [(16, 16, 1), (32, 16, 2)])
def test_plain_matches_pallas_interpret(rng, h, w, bs, alpha):
    """C4 = 128, as tests/test_folded.py runs rpst's kernel."""
    (xj, kj, bj), (xt, kt, bt) = _layer(rng, bs, h, w, 32, 32)
    ref = j_fused(xj, kj, bj, interpret=True, alpha=alpha)
    got = fused_folded_conv(xt, kt, bt, alpha=alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_plain_matches_pallas_interpret_rings_override(rng):
    (xj, kj, bj), (xt, kt, bt) = _layer(rng, 2, 16, 8, 32, 32)
    rings = rng.standard_normal((2, 2, 8, 128)).astype(np.float32)
    ref = j_fused(xj, kj, bj, interpret=True, rings=jnp.asarray(rings))
    got = fused_folded_conv(xt, kt, bt, rings=torch.from_numpy(rings))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("c,co", [(3, 3), (3, 32), (32, 3)])
def test_plain_matches_xla_ring_path(rng, c, co):
    """The image layers (4C = 12) against rpst.ops.folded.folded_conv +
    lrelu, the path rpst takes for widths its kernel does not fill."""
    (xj, kj, bj), (xt, kt, bt) = _layer(rng, 2, 8, 6, c, co)
    ref = j_folded_conv(xj, kj, bj)
    ref = jnp.where(ref >= 0, ref, 0.2 * ref)
    got = fused_folded_conv_plain(xt, kt, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("alpha", [0.2, 0.0])
def test_epilogue_forms_match_xla_ring_path(rng, alpha):
    """rpst's names for the two epilogues: folded_conv_lrelu (alpha 0.2)
    and folded_conv_relu (alpha 0)."""
    form = folded_conv_lrelu if alpha else folded_conv_relu
    (xj, kj, bj), (xt, kt, bt) = _layer(rng, 1, 8, 8, 8, 8)
    ref = j_folded_conv(xj, kj, bj)
    ref = jnp.where(ref >= 0, ref, alpha * ref)
    np.testing.assert_allclose(form(xt, kt, bt).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_and_counts_no_launch(rng):
    _, (xt, kt, bt) = _layer(rng, 1, 4, 4, 8, 8)
    before = fused_folded_conv.launches
    y = fused_folded_conv(xt, kt, bt)
    assert fused_folded_conv.launches == before
    torch.testing.assert_close(y, fused_folded_conv_plain(xt, kt, bt),
                               rtol=0, atol=0)


def test_refuses_grad_instead_of_detaching(rng):
    """An input that requires grad takes the autograd Function (B2/B3
    backward) instead of being detached; the rings override, which has no
    gradient here (nor in rpst's fused_folded_conv), is refused, naming the
    halo path that takes the rows as inputs (folded_conv_act_halo)."""
    _, (xt, kt, bt) = _layer(rng, 1, 4, 4, 8, 8)
    y = fused_folded_conv(xt, kt.requires_grad_(), bt)
    assert y.grad_fn is not None and "FoldedConvAct" in type(y.grad_fn).__name__
    with pytest.raises(NotImplementedError, match="folded_conv_act_halo"):
        fused_folded_conv(xt, kt, bt, rings=torch.zeros(1, 2, 4, 32))
    with torch.no_grad():
        assert fused_folded_conv(xt, kt, bt).grad_fn is None


def _bad_inputs(kind):
    x = torch.zeros(1, 4, 4, 8)
    k, b = torch.zeros(3, 3, 8, 12), torch.zeros(12)
    rings = None
    if kind == "dtype":  # float64 is taken on the CPU only (gradcheck)
        x, k, b = x.half(), k.half(), b.half()
    elif kind == "mixed dtype":
        k = k.to(torch.bfloat16)
    elif kind == "kernel shape":
        k = torch.zeros(3, 3, 4, 12)
    elif kind == "bias shape":
        b = torch.zeros(8)
    elif kind == "width not multiple of 4":
        k, b = torch.zeros(3, 3, 8, 6), torch.zeros(6)
    elif kind == "too small":
        x = torch.zeros(1, 1, 4, 8)
    elif kind == "rings shape":
        rings = torch.zeros(1, 2, 5, 8)
    elif kind == "non-contiguous":
        x = torch.zeros(1, 4, 8, 4).transpose(2, 3)
    elif kind == "x rank":
        x = torch.zeros(4, 4, 8)
    return x, k, b, rings


@pytest.mark.parametrize("kind", ["dtype", "mixed dtype", "kernel shape",
                                  "bias shape", "width not multiple of 4",
                                  "too small", "rings shape",
                                  "non-contiguous", "x rank"])
def test_rejects_what_the_kernel_does_not_take(kind):
    """The wrapper checks its contract on CPU tensors too, so both devices
    accept the same inputs."""
    x, k, b, rings = _bad_inputs(kind)
    with pytest.raises((TypeError, ValueError)):
        fused_folded_conv(x, k, b, rings=rings)


def test_rejects_devices_without_a_kernel(rng):
    x = torch.zeros(1, 4, 4, 8, device="meta")
    k = torch.zeros(3, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_folded_conv(x, k, torch.zeros(8, device="meta"))


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir()
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path.parent


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler error raises with nvcc's output; nothing is cached."""
    bindir = _fake_nvcc(tmp_path, 'echo "error: no sm_90a here" >&2; exit 2')
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        build.build("folded_conv")
    assert not list((tmp_path / "out").glob("*.so"))


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("folded_conv")


def test_build_caches_by_source_hash(tmp_path, monkeypatch):
    """The nvcc command line is the documented one, and a second build of
    the same source reuses the library."""
    log = tmp_path / "calls"
    bindir = _fake_nvcc(tmp_path, f'echo "$@" >> {log}\n'
                        'while [ "$1" != "-o" ]; do shift; done; '
                        'touch "$2"')
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.build("folded_conv")
    assert build.build("folded_conv") == first and first.exists()
    calls = log.read_text().splitlines()
    assert len(calls) == 1
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert "-shared" in calls[0] and "-fPIC" in calls[0]
