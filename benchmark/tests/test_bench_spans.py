"""The readers of the program's spans on synthetic span records: the three
metrics' arithmetic, and nothing read where the program has no spans, kept
none, dropped any or recorded no device stretch."""

import pytest

from benchmark import cells, trace
from benchmark.trace import Event
from witw_tpu_torch.utils import profiling
from witw_tpu_torch.utils.profiling import SpanRecord

MS = 1_000_000


def records():
    """Two embeds (device 10 ms each) with their preprocess (device 1 ms
    and 2 ms), then a sweep of device stretch 30 ms;
    one span still open and one without events are not counted."""
    return [
        SpanRecord("embed", None, 0, 0, 4 * MS, 0.010),
        SpanRecord("preprocess", 0, 0, 0, 1 * MS, 0.001),
        SpanRecord("embed", None, 2, 10 * MS, 16 * MS, 0.010),
        SpanRecord("preprocess", 2, 2, 10 * MS, 11 * MS, 0.002),
        SpanRecord("rank", None, 4, 20 * MS, 60 * MS, 0.030),
        SpanRecord("rank.block", 4, 4, 21 * MS, 30 * MS, 0.012),
        SpanRecord("preprocess", None, 6, 70 * MS, None, None),
        SpanRecord("embed", None, 7, 80 * MS, 90 * MS, None),
    ]


def summary():
    """A 100 ms window whose fused match ran 20 ms."""
    return trace.summarize([Event("void fused_corr_distance_kernel<64>", True, 30 * MS, 20 * MS)],
                           (0, 100 * MS))


@pytest.fixture
def program(monkeypatch):
    """The program's span store, given ``records`` and ``dropped``."""
    state = {"records": records(), "dropped": 0}
    monkeypatch.setattr(profiling, "spans", lambda: list(state["records"]))
    monkeypatch.setattr(profiling, "dropped", lambda: state["dropped"])
    return state


METRICS = ["preprocess_pct.eval", "preprocess_pct.eval.safa", "sweep_wrapper_pct.eval"]


@pytest.mark.parametrize("name,want", [
    ("preprocess_pct.eval", 3.0),        # (1 + 2) ms of 100
    ("preprocess_pct.eval.safa", 3.0),
    ("sweep_wrapper_pct.eval", 10.0),    # 30 ms of rank less 20 ms of kernel
])
def test_readers(program, name, want):
    assert cells.reader(name)(summary(), {}) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_nothing_read_when_dropped_empty_or_without_events(program, name):
    read = cells.reader(name)
    program["dropped"] = 1
    assert read(summary(), {}) is None
    program["dropped"] = 0
    program["records"] = []
    assert read(summary(), {}) is None
    program["records"] = [r._replace(device_s=None) for r in records()]
    assert read(summary(), {}) is None


@pytest.mark.parametrize("name", METRICS)
def test_nothing_read_from_a_program_without_spans(monkeypatch, name):
    """A version of the program without ``spans``: the reader returns None
    and does not raise."""
    monkeypatch.delattr(profiling, "spans")
    assert cells.reader(name)(summary(), {}) is None


def test_sweep_wrapper_needs_the_fused_kernel(program):
    empty = trace.summarize([Event("other", True, 0, MS)], (0, 100 * MS))
    assert cells.reader("sweep_wrapper_pct.eval")(empty, {}) is None
