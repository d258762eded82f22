"""The whole-window statistics, the trace arithmetic and the bounds."""

import math

import pytest

from harness import bounds, readers, stats, trace


def test_rate_and_percentile_over_all_requests():
    assert stats.rate(300, 10.0) == 30.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    lat = list(range(1, 101))            # 1 .. 100 ms
    assert stats.percentile(lat, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(reversed(lat)), 50) == 50
    assert stats.percentile([1, 2, 3, 4, 100], 95) == 100
    assert stats.in_window(1.0, 1.0, 2.0) and not stats.in_window(2.1, 1, 2)


def test_union_busy_merges_overlaps_and_counts_the_window():
    spans = [(0.0, 1.0, "a"), (0.5, 2.0, "b"), (3.0, 4.0, "a"),
             (3.2, 3.5, "c")]
    busy, window, merged = trace.union_busy(spans)
    assert busy == pytest.approx(3.0) and window == pytest.approx(4.0)
    assert merged == [[0.0, 2.0], [3.0, 4.0]]
    # the gap (2, 3) is named by the op that overlaps it most; of those
    # that cover it whole, the shortest
    s = trace.summarize(spans, [(1.9, 3.1, "outer"), (2.2, 2.8, "inner")])
    assert s["by_name"]["a"] == pytest.approx(2.0)
    assert s["breakdown"]["idle_gaps"] == [["outer", pytest.approx(1.0)]]
    s = trace.summarize(spans, [(1.9, 3.1, "outer"), (1.95, 3.05, "tight"),
                                (2.2, 2.8, "inner")])
    assert s["breakdown"]["idle_gaps"] == [["tight", pytest.approx(1.0)]]
    assert 1.0 - s["busy_s"] / s["window_s"] == pytest.approx(0.25)


def test_short_name_tells_b1_from_b2():
    fwd = ("void folded::folded_mma_kernel<__nv_bfloat16, false, false, 2>"
           "(folded::Args<__nv_bfloat16>)")
    bwd = "void folded::folded_mma_kernel<float, true, true, 2>(x)"
    assert trace.short_name(fwd) == "folded_mma_kernel[B1]"
    assert trace.short_name(bwd) == "folded_mma_kernel[B2]"
    assert trace.short_name(
        "void (anonymous namespace)::flash_bwd_dq_kernel<float>(x)") == \
        "flash_bwd_dq_kernel"


def test_bounds_match_chip_smoke():
    # chip_smoke.py's kernels line: B1 f32 (1, 256, 256, 128 -> 128), the
    # folded kernel: 0.0202 ms, bound by bytes; B6a f32 (1, 4096, 4096,
    # 512): 0.0694 ms by operations
    assert bounds.folded_bound(1, 256, 256, 128, 128, "f32") == \
        pytest.approx(0.0202, abs=5e-5)
    assert bounds.attention_bound("B6a", 1, 4096, 4096, 512, "f32") == \
        pytest.approx(0.0694, abs=5e-5)
    assert bounds.attention_bound("B6d", 1, 4096, 4096, 512, "f32") == \
        pytest.approx(0.1388, abs=5e-5)


def test_plans_count_the_ports_launches(manifest):
    fl = manifest.config("rp_adain_flagship")["kernel_launches"]
    sa = manifest.config("sanet")["kernel_launches"]
    count = lambda plan: {k: v[0] for k, v in  # noqa: E731
                          bounds.plan_per_call(plan, 8).items()}
    assert count(fl["serve"]) == {"B1": 15}
    assert count(fl["train"]) == {"B1": 23, "B2": 17, "B3": 15}
    assert count(sa["serve"]) == {"B6a": 2}
    assert count(sa["train"]) == {"B6b": 6, "B6c": 6, "B6d": 6}


def _run(calls, counters, seconds):
    return {"kind": "serve", "batch": 8, "window_s": 1.0, "images": 8,
            "trace_calls": calls, "counters": counters,
            "config": {"kernel_launches": {"serve": {
                "B1": [[15, 1, 256, 256, 128, 128, "bf16"]]}},
                "settings": {"compute_dtype": "bfloat16"},
                "flops": {"stylize_per_image": 1e12}},
            "trace": {"by_name": {"folded_mma_kernel[B1]": seconds},
                      "busy_s": 0.5, "window_s": 2.0}}


def test_roofline_sums_bounds_over_counted_launches():
    one = bounds.folded_bound(8, 256, 256, 128, 128, "bf16")
    run = _run(10, {"B1": 150}, 150 * one * 1e-3 * 4)
    assert readers.roofline(run, "folded_conv", "serve") == \
        pytest.approx(25.0)
    # launches that do not fit the plan leave the metric silent
    assert readers.roofline(_run(10, {"B1": 60}, 1.0), "folded_conv",
                            "serve") is None
    assert readers.roofline(_run(10, {"B1": 150}, 0.0), "folded_conv",
                            "serve") is None
    assert readers.idle_share(run) == pytest.approx(75.0)
    assert readers.mfu(run, "stylize_per_image") == \
        pytest.approx(100 * 8e12 / 989e12)
    assert math.isfinite(readers.mfu(run, "stylize_per_image"))


def test_mantissa_rounding_is_round_to_nearest_even():
    import torch
    from reference.common import round_mantissa
    g = torch.Generator().manual_seed(3)
    x = torch.randn(100_000, generator=g) * torch.exp(
        4 * torch.randn(100_000, generator=g))
    # at bfloat16's 7 bits it is PyTorch's own conversion
    assert torch.equal(round_mantissa(x, 7), x.to(torch.bfloat16).float())
    r = round_mantissa(x, 10)            # TF32
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_the_serving_readers_read_the_window_or_nothing(manifest):
    run = {"kind": "serve", "batch": 8, "p95_ms": 151.5,
           "batcher": {"served": 760, "batches": 100, "p50_batch_ms": 31.0}}
    read = {m: manifest.reader(m).read for m in (
        "batch_fill.serve", "batch_ms_p50.serve", "latency_p95_ms.serve")}
    assert read["batch_fill.serve"](run) == pytest.approx(95.0)
    assert read["batch_ms_p50.serve"](run) == 31.0
    assert read["latency_p95_ms.serve"](run) == 151.5
    # a window with no completed request, or a training run: silent
    assert read["latency_p95_ms.serve"](dict(run, p95_ms=None)) is None
    for r in read.values():
        assert r({"kind": "train"}) is None
