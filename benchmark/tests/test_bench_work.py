"""The work counts of ``benchmark/work`` against hand counts."""

import pytest

from benchmark import work


def test_surface_trunk_flops_by_hand():
    convs, out = work.vgg_convs(1, 128, 512)
    assert len(convs) == 10
    assert out == (16, 64, 512)
    # conv1_1 2*65536*64*27, conv1_2 2*65536*64*576, then each block's.
    by_hand = 2 * (65536 * 64 * 27 + 65536 * 64 * 576 + 16384 * 128 * 576 + 16384 * 128 * 1152
                   + 4096 * 256 * 1152 + 2 * 4096 * 256 * 2304 + 1024 * 512 * 2304
                   + 2 * 1024 * 512 * 4608)
    total = sum(c.work().ops for c in convs)
    assert total == by_hand
    assert round(total / 1e9, 2) == 36.47


def test_fov_head_and_map_shape():
    convs = work.fov_tower_convs(1, 128, 512)
    assert [c.name for c in convs[-3:]] == ["conv_23", "conv_25", "conv_27"]
    assert [c.stride_h for c in convs[-3:]] == [2, 2, 1]
    assert work.fov_map_shape(128, 512) == (4, 64, 16)
    # conv_23: 8 x 64 outputs of 256 channels from 512.
    assert convs[-3].work().ops == 2 * 8 * 64 * 256 * 9 * 512


def test_fused_match_counts_the_correlation_once():
    one = work.match_work(1, 1, 64, 64, 64)
    assert one.ops == 2 * 64 * 64 * 64  # W shifts x sw columns x hc channels, one product each
    assert one.peak == "tf32"
    calls = work.sweep_work(8884, 256, 1024, 64, 64, 64)
    assert len(calls) == 35 * 9
    assert sum(c.ops for c in calls) == 8884 * 8884 * 2 * 64 * 64 * 64
    # 8884^2 pairs at 494.7 TFLOP/s: 0.0837 s of work per sweep.
    assert work.total(calls)["ops_s"] == pytest.approx(8884 ** 2 * 524288 / 494.7e12)


def test_bound_is_the_larger_of_ops_and_bytes():
    w = work.Work(989e12, 3.35e12 * 2, "bf16")
    assert w.least_s() == pytest.approx(2.0)
    assert w.ops_s() == pytest.approx(1.0)


def test_conv_bytes_read_each_input_once():
    w = work.conv_work(2, 4, 8, 3, 16)
    assert w.nbytes == 2 * 2 * 4 * 8 * (3 + 16) + 2 * 16 * 9 * 3 + 4 * 16


def test_ragged_batches():
    assert work.batches(8884, 64)[-1] == 52
    assert work.batches(8884, 32)[-1] == 20
    assert sum(work.batches(8884, 64)) == 8884
