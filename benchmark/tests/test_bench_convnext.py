"""The Sample4Geo cell on the CPU at a tiny size: the ``eval_global``
driver end to end, the control and the faults that have to turn ``correct``
false, the ConvNeXt work counts against the published ones, and the two
span readers."""

import numpy as np
import pytest
import torch

from benchmark import cells, trace
from benchmark.tests.conftest import run_checked
from benchmark.work import convnext as convnext_work
from witw_tpu_torch.utils import profiling
from witw_tpu_torch.utils.profiling import SpanRecord

CELL = "sample4geo-cvusa.eval-bf16"
# A 35 x 96 panorama (35 rows, as the cell's after its stem: 8, 4, 2, 1 rows
# at the stages) and a 64^2 tile; narrow widths; batches of 4, so a 10-pair
# split ends in a ragged batch.
TINY = {"data": {"surface_height": 35, "surface_width_max": 96, "overhead_size": 64},
        "model": {"dims": [16, 32, 64, 128], "depths": [1, 1, 3, 1]},
        "eval": {"batch_size": 4}}
TINY_PARAMS = {"pairs": 10, "check_queries": 6}
READERS = ["convnext_mixer_roofline", "convnext_mlp_roofline"]
MS = 1_000_000


def tiny_driver(seed: int = 2**31 + 11):
    cell = cells.workload(CELL)
    cell["params"] = dict(TINY_PARAMS)
    conf = cells.config(cell["config"])
    return cells.traffic(cell["traffic"]).Driver(cells.experiment(conf, TINY), conf, cell, seed,
                                                 torch.device("cpu"))


def test_driver_end_to_end():
    d = tiny_driver()
    d.setup()
    assert d.params["surface"] is d.params["overhead"]
    result = d.window(0.0)
    assert result["attempted"] == 1 and result["failed"] == 0 and result["eval_pairs_per_s"] > 0
    ranks = d.kept[0][0]
    assert ranks.shape == (10,) and ranks.min() >= 1 and ranks.max() <= 10
    w = d.work()
    assert w["steps"] == 1 and w["pairs"] == 10
    # 3 batches (4, 4, 2) x 2 views x 6 blocks
    assert w["layers"]["convnext_mixer"]["calls"] == w["layers"]["convnext_mlp"]["calls"] == 36
    assert w["model_ops_s"] > 0
    d.release()
    checks = d.check()
    limits = d.cell["limits"]
    assert set(checks) == set(limits)
    assert all(checks[k] <= limits[k] for k in limits), checks


def test_same_seed_same_inputs_and_weights():
    a, b, c = tiny_driver(99), tiny_driver(99), tiny_driver(100)
    for d in (a, b, c):
        d.setup()
        d.draw(3)
    assert torch.equal(a.surface, b.surface) and torch.equal(a.overhead, b.overhead)
    assert all(torch.equal(a.params["surface"][k], b.params["surface"][k])
               for k in a.params["surface"])
    assert not torch.equal(a.surface, c.surface)
    assert not torch.equal(a.params["surface"]["model.stem.0.weight"],
                           c.params["surface"]["model.stem.0.weight"])


def test_control_fails_the_check():
    """The reference in fp8 in the program's place comes out not correct."""
    d = tiny_driver()
    checks, limits, correct = run_checked(d)
    assert correct
    ctl = d.check(control=True)
    assert any(ctl["control_" + k] > limits[k] for k in limits), ctl


def test_an_altered_rank_turns_correct_false(monkeypatch):
    d = tiny_driver()
    real = type(d).rank

    def altered(self, o, s):
        ranks = real(self, o, s).copy()
        ranks[self.sample] = np.where(ranks[self.sample] > 5, 1, 10)
        return ranks

    monkeypatch.setattr(type(d), "rank", altered)
    checks, limits, correct = run_checked(d)
    assert not correct and checks["rank_gap"] > limits["rank_gap"], checks


def test_an_altered_embedding_turns_correct_false(monkeypatch):
    """The overhead embeddings altered where the encoder produces them."""
    d = tiny_driver()
    d.setup()
    real = d.pipeline.embed_step

    def altered(params, batch, generator=None, draws=None):
        s, o = real(params, batch, generator, draws)
        return s, o * 1.5

    monkeypatch.setattr(d.pipeline, "embed_step", altered)
    d.window(0.0)
    d.release()
    checks = d.check()
    assert checks["emb_err"] > d.cell["limits"]["emb_err"], checks


def test_work_counts_the_published_multiply_adds():
    depths, dims = (3, 3, 27, 3), (128, 256, 512, 1024)
    assert round(convnext_work.multiply_adds(224, 224, depths, dims) / 1e9, 2) == 15.35
    assert round(convnext_work.multiply_adds(384, 384, depths, dims) / 1e9, 2) == 45.12
    assert convnext_work.stage_sizes(140, 768, 4) == [(35, 192), (17, 96), (8, 48), (4, 24)]
    calls = convnext_work.encoder_work(64, 384, 384, depths, dims)
    assert len(calls["convnext_mixer"]) == len(calls["convnext_mlp"]) == 36
    # The mixer is bound by its bytes; the MLP by its operations past the
    # first stage (at 128 channels, 205 FLOP a byte, under the 295 of the
    # bf16 peak over the memory rate).
    assert all(w.nbytes / 3.35e12 > w.ops / 989e12 for w in calls["convnext_mixer"])
    assert all(w.ops / 989e12 > w.nbytes / 3.35e12 for w in calls["convnext_mlp"][3:])
    assert all(w.ops / 989e12 < w.nbytes / 3.35e12 for w in calls["convnext_mlp"][:3])


def records():
    """An embed's two views, each with one block: mixer device stretches 1
    and 2 ms, MLP 3 and 5 ms; one mixer still open."""
    return [
        SpanRecord("embed", None, 0, 0, 20 * MS, 0.02),
        SpanRecord("tower.surface", 0, 0, 0, 9 * MS, None),
        SpanRecord("convnext.mixer", 1, 0, 0, MS, 0.001),
        SpanRecord("convnext.mlp", 1, 0, MS, 4 * MS, 0.003),
        SpanRecord("tower.overhead", 0, 0, 9 * MS, 20 * MS, None),
        SpanRecord("convnext.mixer", 4, 0, 9 * MS, 11 * MS, 0.002),
        SpanRecord("convnext.mlp", 4, 0, 11 * MS, 16 * MS, 0.005),
        SpanRecord("convnext.mixer", 4, 0, 17 * MS, None, None),
    ]


WORK = {"layers": {"convnext_mixer": {"least_s": 0.0006}, "convnext_mlp": {"least_s": 0.004}}}


@pytest.fixture
def program(monkeypatch):
    state = {"records": records(), "dropped": 0}
    monkeypatch.setattr(profiling, "spans", lambda: list(state["records"]))
    monkeypatch.setattr(profiling, "dropped", lambda: state["dropped"])
    return state


def summary():
    return trace.summarize([trace.Event("gemm", True, 0, 10 * MS)], (0, 100 * MS))


@pytest.mark.parametrize("name,want", [("convnext_mixer_roofline", 20.0),  # 0.6 ms of 3
                                       ("convnext_mlp_roofline", 50.0)])   # 4 ms of 8
def test_readers(program, name, want):
    assert cells.reader(name)(summary(), WORK) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_nothing_read_without_spans(program, monkeypatch, name):
    read = cells.reader(name)
    program["dropped"] = 1
    assert read(summary(), WORK) is None
    program["dropped"] = 0
    program["records"] = [r for r in records() if not r.name.startswith("convnext")]
    assert read(summary(), WORK) is None
    program["records"] = []
    assert read(summary(), WORK) is None
    program["records"] = records()
    assert read(summary(), {}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert read(summary(), WORK) is None


@pytest.mark.cuda
def test_the_cell_on_the_card(cuda_device):
    """A short window of the cell at its own geometry, widths and batch on
    the card (fewer pairs), held to the cell's limits; the control fails
    them."""
    cell = cells.workload(CELL)
    cell["params"] = {"pairs": 200, "check_queries": 64}
    conf = cells.config(cell["config"])
    d = cells.traffic(cell["traffic"]).Driver(cells.experiment(conf), conf, cell, 2**31 + 3,
                                              cuda_device)
    d.setup()
    d.window(0.0)
    d.release()
    checks = d.check(control=True)
    limits = cell["limits"]
    assert all(checks[k] <= limits[k] for k in limits), checks
    assert any(checks["control_" + k] > limits[k] for k in limits), checks
