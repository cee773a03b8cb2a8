"""Each traffic driver end to end at a tiny size on the CPU (the port's
plain versions of its kernels), the control that has to fail the check, and
the faults of the timed path that have to turn ``correct`` false."""

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.tests.conftest import EVAL_CELLS, run_checked, tiny_driver


@pytest.mark.parametrize("name", EVAL_CELLS)
def test_eval_driver_end_to_end(name):
    d = tiny_driver(name)
    d.setup()
    result = d.window(0.0)
    assert result["attempted"] == 1 and result["failed"] == 0
    assert result["eval_pairs_per_s"] > 0
    ranks = d.kept[0][0]
    assert ranks.shape == (10,) and ranks.min() >= 1 and ranks.max() <= 10
    w = d.work()
    assert w["steps"] == 1 and w["pairs"] == 10
    # 3 batches (4, 4, 2) x 2 towers x the stride-1 convs on conv3x3_bf16
    per_tower = 11 if d.family == "fov_dsm" else 10
    assert w["layers"]["conv3x3_bf16"]["calls"] == 3 * 2 * per_tower
    d.release()
    checks = d.check()
    limits = d.cell["limits"]
    assert set(checks) == set(limits)
    assert all(checks[k] <= limits[k] for k in limits), checks


@pytest.mark.parametrize("name", EVAL_CELLS)
def test_same_seed_same_inputs(name):
    a, b = tiny_driver(name, seed=99), tiny_driver(name, seed=99)
    for d in (a, b):
        d.setup()
        d.draw(3)
    assert torch.equal(a.surface, b.surface) and torch.equal(a.starts, b.starts)
    assert all(torch.equal(a.params["overhead"][k], b.params["overhead"][k])
               for k in a.params["overhead"])
    c = tiny_driver(name, seed=100)
    c.setup()
    c.draw(3)
    assert not torch.equal(a.surface, c.surface)


@pytest.mark.parametrize("name", EVAL_CELLS)
def test_control_fails_the_check(name):
    """The reference in fp8 in the program's place comes out not correct."""
    d = tiny_driver(name)
    checks, limits, correct = run_checked(d)
    assert correct
    ctl = d.check(control=True)
    assert any(ctl["control_" + k] > limits[k] for k in limits), ctl


@pytest.mark.parametrize("name", EVAL_CELLS)
def test_an_altered_rank_turns_correct_false(name, monkeypatch):
    """A rank altered where it is produced: the sampled queries' ranks
    moved to the far end of the gallery."""
    d = tiny_driver(name)
    real = type(d).rank

    def altered(self, o, s):
        ranks = real(self, o, s).copy()
        ranks[self.sample] = np.where(ranks[self.sample] > 5, 1, 10)
        return ranks

    monkeypatch.setattr(type(d), "rank", altered)
    checks, limits, correct = run_checked(d)
    assert not correct and checks["rank_gap"] > limits["rank_gap"], checks


@pytest.mark.parametrize("name", EVAL_CELLS)
def test_an_altered_embedding_turns_correct_false(name, monkeypatch):
    """The overhead embeddings altered where the towers produce them."""
    d = tiny_driver(name)
    d.setup()
    real = d.pipeline.embed_step

    def altered(params, batch, generator=None, draws=None):
        s, o = real(params, batch, generator, draws)
        return s, o * 1.5

    monkeypatch.setattr(d.pipeline, "embed_step", altered)
    d.window(0.0)
    d.release()
    checks = d.check()
    limits = d.cell["limits"]
    assert checks["emb_err"] > limits["emb_err"], checks


def test_fp8_round_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = float(((reference.fp8_round(x) - x).norm() / x.norm()))
    e16 = float(((x.to(torch.bfloat16).float() - x).norm() / x.norm()))
    assert 4 * e16 < e8 < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("name", EVAL_CELLS)
def test_eval_cells_on_the_card(name, cuda_device):
    """A short window of the cell at its own geometry and batch on the card
    (fewer pairs), held to the cell's limits; the control fails them."""
    from benchmark import cells

    cell = cells.workload(name)
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
