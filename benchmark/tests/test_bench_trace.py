"""The trace reader on a synthetic list of overlapping events."""

import pytest

from benchmark import trace
from benchmark.trace import Event


def events():
    ms = 1_000_000
    return [
        # Two streams overlapping in 10..20 ms, then a gap 30..50 while the
        # host allocates.
        Event("conv3x3_bf16_kernel<1>", True, 10 * ms, 10 * ms),
        Event("conv3x3_bf16_kernel<2>", True, 15 * ms, 15 * ms),
        Event("cudaLaunchKernel", False, 9 * ms, 1 * ms),
        Event("cudaMalloc", False, 30 * ms, 20 * ms),
        Event("void fused_corr_distance_kernel<64>", True, 50 * ms, 20 * ms),
        # A gap 70..90 while the host waits on a copy, then the copy; the
        # gaps 0..10 and 95..100 fall in no CUDA call.
        Event("cudaStreamSynchronize", False, 60 * ms, 35 * ms),
        Event("Memcpy DtoH", True, 90 * ms, 5 * ms),
        # Outside the window: ignored.
        Event("conv3x3_bf16_kernel<1>", True, 150 * ms, 5 * ms),
    ]


def test_union_merges_overlaps():
    assert trace.union([(5, 9), (0, 2), (1, 3), (9, 12)]) == [(0, 3), (5, 12)]


def test_busy_idle_and_split():
    s = trace.summarize(events(), (0, 100_000_000))
    assert s["window_s"] == pytest.approx(0.1)
    # busy: 10..30 (union of the two convs), 50..70, 90..95
    assert s["busy_s"] == pytest.approx(0.045)
    assert s["kernels"] == 4
    assert trace.kernel_seconds(s, "conv3x3_bf16_kernel") == pytest.approx(0.025)
    assert trace.kernel_seconds(s, "fused_corr_distance_kernel") == pytest.approx(0.02)
    idle = dict(s["breakdown"]["idle_gaps"])
    assert idle == {"host": pytest.approx(0.015), "cudaMalloc": pytest.approx(0.02),
                    "cudaStreamSynchronize": pytest.approx(0.02)}
    ops = s["breakdown"]["device_ops"]
    assert ops[0] == ["void fused_corr_distance_kernel<64>", pytest.approx(0.02)]
    assert len(ops) <= 10


def test_idle_reader_and_mfu_reader():
    from benchmark import cells

    s = trace.summarize(events(), (0, 100_000_000))
    idle = cells.reader("idle_pct.eval")(s, {})
    assert idle == pytest.approx(55.0)
    mfu = cells.reader("mfu_pct.eval")(s, {"model_ops_s": 0.01})
    assert mfu == pytest.approx(10.0)
    roof = cells.reader("conv3x3_bf16_roofline")(s, {"layers": {"conv3x3_bf16": {"least_s": 0.02}}})
    assert roof == pytest.approx(80.0)


def test_readers_return_nothing_without_their_kernel():
    from benchmark import cells

    s = trace.summarize([Event("other", True, 0, 5)], (0, 10))
    work = {"layers": {"conv3x3_bf16": {"least_s": 1.0}, "fused_match": {"least_s": 1.0}}}
    assert cells.reader("conv3x3_bf16_roofline")(s, work) is None
    assert cells.reader("fused_match_roofline")(s, work) is None
    empty = trace.summarize([Event("cudaMalloc", False, 0, 10)], (0, 10))
    assert cells.reader("idle_pct.eval")(empty, work) is None
