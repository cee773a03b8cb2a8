"""The plain reference against the port at a tiny size on the CPU, in
float32: preprocess, both towers of both families, the match and the
ranks. The test imports both; the reference imports nothing of the port."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import functional_call

from benchmark import weights
from benchmark.reference import match as ref_match
from benchmark.reference import preprocess as ref_pre
from benchmark.reference import towers as ref_towers
from benchmark.tests.conftest import EVAL_CELLS, tiny_driver


def f32_pipeline(d):
    from witw_tpu_torch.train.pipeline import make_pipeline

    cfg = d.cfg.replace(model=dataclasses.replace(d.cfg.model, compute_dtype="float32"))
    return make_pipeline(cfg, torch.device("cpu"))


@pytest.mark.parametrize("name", EVAL_CELLS)
def test_preprocess_and_towers_against_the_port(name):
    d = tiny_driver(name)
    d.setup()
    d.draw(0)
    dc = d.cfg.data
    rows = slice(0, 4)
    batch = {"surface": d.surface[rows], "overhead": d.overhead[rows]}
    pipe = f32_pipeline(d)
    surface, polar = pipe.preprocess(batch, draws=d.starts[rows])
    ref_s = ref_pre.surface_input(d.surface[rows], d.starts[rows], dc.surface_width, dc.img_mean,
                                  dc.img_std)
    ref_o = ref_pre.overhead_input(d.overhead[rows], dc.surface_height, dc.surface_width_max,
                                   dc.img_mean, dc.img_std)
    torch.testing.assert_close(surface, ref_s, rtol=0, atol=1e-5)
    torch.testing.assert_close(polar, ref_o, rtol=0, atol=1e-4)
    tower = ref_towers.fov_tower if d.family == "fov_dsm" else ref_towers.safa_tower
    with torch.no_grad():
        for which, model, x, circ in (("surface", pipe.surface_model, ref_s, False),
                                      ("overhead", pipe.overhead_model, ref_o, True)):
            got = functional_call(model, d.params[which], (x,))
            want = tower(x, d.params[which], circ)
            assert ref_match.relative_error(got, want) < 1e-5


def test_dropout_masks_in_the_trunk_against_the_port():
    d = tiny_driver(EVAL_CELLS[0])
    d.setup()
    d.draw(0)
    pipe = f32_pipeline(d)
    x = torch.randn(4, 32, 64, 3, generator=torch.Generator().manual_seed(1))
    keep = [torch.rand(4, 512, generator=torch.Generator().manual_seed(i)) > 0.2 for i in range(3)]
    from witw_tpu_torch.models.backbones.vgg16 import DropoutMasks

    got = functional_call(pipe.surface_model, d.params["surface"], (x,),
                          {"train": True, "generator": DropoutMasks([k[:, :, None, None]
                                                                     for k in keep])})
    want = ref_towers.fov_tower(x, d.params["surface"], False, keep=keep, rate=0.2)
    assert ref_match.relative_error(got, want) < 1e-5


def test_chord_distance_and_ranks_against_the_port():
    from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator
    from witw_tpu_torch.match.correlation import circular_correlation
    from witw_tpu_torch.match.distance import chord_distance

    g = torch.Generator().manual_seed(3)
    o = torch.randn(12, 2, 8, 16, generator=g)
    s = torch.randn(12, 2, 8, 16, generator=g) + 0.5 * o  # true matches closer
    want = ref_match.chord_distances(o, s, block=5)
    got, _ = chord_distance(o, s, circular_correlation(o, s))
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)
    tm = torch.arange(12)
    ranks = FovGalleryEvaluator(query_block=4, gallery_chunk=5, use_fused=True,
                                device=torch.device("cpu")).ranks(o, s)
    assert ref_match.rank_gap(want, tm, ranks) < 1e-5
    assert np.array_equal(ref_match.ranks(want, tm), ranks)


def test_euclidean_against_the_port():
    from witw_tpu_torch.evaluation.gallery import euclidean_ranks

    g = torch.Generator().manual_seed(4)
    o = torch.nn.functional.normalize(torch.randn(20, 64, generator=g), dim=1)
    s = torch.nn.functional.normalize(o + 0.7 * torch.randn(20, 64, generator=g), dim=1)
    d = ref_match.euclidean_sq_distances(o, s)
    torch.testing.assert_close(d, torch.cdist(o.double(), s.double()) ** 2, rtol=0, atol=1e-12)
    ranks = euclidean_ranks(o, s, device=torch.device("cpu"))
    assert ref_match.rank_gap(d, torch.arange(20), ranks) < 1e-5


def test_rank_gap_by_hand():
    # One query (column 0), true match row 0 at distance 1.0; others at
    # 0.7, 1.2, 1.5 (gaps -0.3, 0.2, 0.5); the exact rank is 2.
    d = torch.tensor([[1.0], [0.7], [1.2], [1.5]], dtype=torch.float64)
    tm = torch.tensor([0])
    assert ref_match.ranks(d, tm).tolist() == [2]
    assert ref_match.rank_gap(d, tm, [2]) == 0.0
    assert ref_match.rank_gap(d, tm, [3]) == pytest.approx(0.2)  # counted the 0.2 item
    assert ref_match.rank_gap(d, tm, [1]) == pytest.approx(0.3)  # missed the -0.3 item
    assert ref_match.rank_gap(d, tm, [4]) == pytest.approx(0.5)
    assert ref_match.rank_gap(d, tm, [9]) == float("inf")


def test_weights_fit_the_ports_towers():
    d = tiny_driver(EVAL_CELLS[1])
    d.setup()  # check_layout raises on any name or shape the program lacks
    shapes = weights.tower_shapes(d.cfg)
    assert {n for n, _, _ in shapes["surface"]} == set(d.params["surface"])
