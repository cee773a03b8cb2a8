"""The port's spans (witw_tpu_torch.utils.profiling.span), on the CPU.

- Off (no profiler recording): no record is made and no profiler range
  is entered; ``span`` hands out one shared no-op.
- On, under a CPU ``torch.profiler.profile``: parents and roots nest, each
  thread on its own stack; the host stamps, on ``time.time_ns()``, enclose
  the profiler's own events of an op run inside; past its bound the buffer
  keeps nothing more and counts what it dropped.
- The span trees of ``embed_step`` (the FOV, SAFA, baseline and
  Sample4Geo families, the last with its ConvNeXt blocks' spans),
  ``FovGalleryEvaluator.ranks``, ``euclidean_ranks``, ``test_ranks`` and
  ``train_step`` at tiny sizes; spans leave the results as they were.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses
import threading

import numpy as np
import pytest
import torch

from witw_tpu_torch.configs import (baseline_experiment, fov_experiment, safa_experiment,
                                    sample4geo_experiment)
from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator, euclidean_ranks
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.pipeline import make_pipeline
from witw_tpu_torch.utils import profiling
from witw_tpu_torch.utils import reset, span, spans

CPU = [torch.profiler.ProfilerActivity.CPU]
GEOMETRY = dict(surface_height=32, surface_width_max=64, overhead_size=64)


def _profile():
    return torch.profiler.profile(activities=CPU)


def _tree(records):
    """(name, parent's name, root's name) of each record, in order."""
    return [(r.name, None if r.parent is None else records[r.parent].name,
             records[r.root].name) for r in records]


def _recorded(fn):
    """``fn()``'s result and the spans it made under a CPU profiler."""
    reset()
    with _profile():
        out = fn()
    return out, spans()


def _cfg(make, dropout=None, **data):
    cfg = make("cvusa")
    model = dataclasses.replace(cfg.model, compute_dtype="float32")
    if dropout is not None:
        model = dataclasses.replace(model, dropout_rate=dropout)
    return cfg.replace(data=dataclasses.replace(cfg.data, **{**GEOMETRY, **data}), model=model)


def _batch(cfg, b=2, seed=0):
    d = cfg.data
    g = torch.Generator().manual_seed(seed)
    return {"surface": torch.randint(0, 256, (b, d.surface_height, d.surface_width_max, 3),
                                     generator=g).float(),
            "overhead": torch.randint(0, 256, (b, d.overhead_size, d.overhead_size, 3),
                                      generator=g).float()}


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []
    real = profiling._Range

    def counting(*args, **kwargs):
        entered.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(profiling, "_Range", counting)
    reset()
    with span("outer"):
        with span("inner"):
            torch.ones(4).sum()
    assert euclidean_ranks(torch.eye(3), torch.eye(3), device="cpu").tolist() == [1, 1, 1]
    assert span("a") is span("b")
    assert spans() == [] and profiling.dropped() == 0 and entered == []
    with _profile():  # the same patch counts once a profiler records
        with span("on"):
            pass
    assert len(entered) == 1 and [r.name for r in spans()] == ["on"]


def test_on_spans_nest_and_enclose_the_profilers_events():
    reset()
    with _profile() as prof:
        with span("outer"):
            with span("inner"):
                torch.randn(32, 32) @ torch.randn(32, 32)
            with span("second"):
                pass
        with span("other"):
            pass
    records = spans()
    assert _tree(records) == [("outer", None, "outer"), ("inner", "outer", "outer"),
                              ("second", "outer", "outer"), ("other", None, "other")]
    assert [(r.parent, r.root) for r in records] == [(None, 0), (0, 0), (0, 0), (None, 3)]
    assert all(r.device_s is None for r in records)  # no CUDA events on the CPU
    events = list(prof.profiler.kineto_results.events())
    inner = records[1]
    mm = [e for e in events if e.name() == "aten::mm"]
    ranges = [e for e in events if e.name() == "inner"]
    assert len(mm) == 1 and len(ranges) == 1
    for e in mm + ranges:  # the profiler's clock is the spans' clock
        assert inner.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= inner.end_ns
    outer = records[0]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= records[2].start_ns
    assert records[2].end_ns <= outer.end_ns <= records[3].start_ns


def test_each_thread_has_its_own_stack():
    opened = threading.Event()
    done = threading.Event()

    def worker():
        with span("thread.root"):
            opened.set()
            done.wait(10)

    reset()
    with _profile():
        with span("main.root"):
            t = threading.Thread(target=worker)
            t.start()
            assert opened.wait(10)
            with span("main.child"):
                pass
            done.set()
            t.join(10)
    assert not t.is_alive()
    assert sorted(_tree(spans())) == [("main.child", "main.root", "main.root"),
                                      ("main.root", None, "main.root"),
                                      ("thread.root", None, "thread.root")]


def test_buffer_drops_past_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAPACITY", 3)
    reset()
    with _profile():
        with span("s0"):
            for i in range(1, 5):
                with span(f"s{i}"):
                    pass
    assert _tree(spans()) == [("s0", None, "s0"), ("s1", "s0", "s0"), ("s2", "s0", "s0")]
    assert profiling.dropped() == 2
    reset()
    assert spans() == [] and profiling.dropped() == 0


EMBED_TREE = [("embed", None, "embed"), ("preprocess", "embed", "embed"),
              ("tower.surface", "embed", "embed"), ("tower.overhead", "embed", "embed")]


@pytest.mark.parametrize("make", [fov_experiment, safa_experiment])
def test_embed_step_tree(make):
    cfg = _cfg(make)
    pipeline = make_pipeline(cfg, "cpu")
    params = pipeline.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    draws = torch.tensor([3, 40])
    reset()
    want = pipeline.embed_step(params, batch, draws=draws)
    assert spans() == []
    got, records = _recorded(lambda: pipeline.embed_step(params, batch, draws=draws))
    assert _tree(records) == EMBED_TREE
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # Drawn inside: the crop origins are a child of preprocess.
    _, records = _recorded(lambda: pipeline.embed_step(params, batch, torch.Generator()))
    assert _tree(records) == EMBED_TREE[:2] + [("draw", "preprocess", "embed")] \
        + EMBED_TREE[2:]


def _sample4geo(depths):
    """The Sample4Geo preset at narrow widths and a small geometry, and its
    pipeline and params on the CPU."""
    cfg = sample4geo_experiment("cvusa")
    model = dataclasses.replace(cfg.model, dims=(8, 16, 32, 64), depths=depths,
                                compute_dtype="float32")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, **GEOMETRY), model=model)
    pipeline = make_pipeline(cfg, "cpu")
    return cfg, pipeline, pipeline.init(torch.Generator().manual_seed(0))


def test_embed_step_tree_of_the_sample4geo_blocks():
    """Each ConvNeXt block's ``convnext.mixer`` and ``convnext.mlp`` nest
    under the tower of the view it embeds; the one encoder runs twice."""
    cfg, pipeline, params = _sample4geo((1, 1, 2, 1))
    batch = _batch(cfg)
    want = pipeline.embed_step(params, batch)
    got, records = _recorded(lambda: pipeline.embed_step(params, batch))
    blocks = [("convnext.mixer", "tower.{}", "embed"), ("convnext.mlp", "tower.{}", "embed")] * 5
    assert _tree(records) == EMBED_TREE[:3] + [(n, p.format("surface"), r) for n, p, r in blocks] \
        + EMBED_TREE[3:] + [(n, p.format("overhead"), r) for n, p, r in blocks]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_span_capacity_holds_a_traced_sample4geo_window():
    """The buffer keeps every span of the Sample4Geo cell's traced 30-s
    window at the published depths: 148 spans a batch of 64 (two spans a
    block, 36 blocks, both views), 139 batches an eval of 8,884 pairs, and
    at most as many evals as fit in the window at the bf16 peak (an eval's
    FLOPs at 989 TFLOP/s: 1.36 s)."""
    from benchmark.work import convnext as convnext_work

    cfg, pipeline, params = _sample4geo((3, 3, 27, 3))
    _, records = _recorded(lambda: pipeline.embed_step(params, _batch(cfg)))
    per_batch = len(records)
    assert per_batch == 4 + 2 * 2 * 36
    d, m = sample4geo_experiment("cvusa").data, sample4geo_experiment("cvusa").model
    pairs, batch, window_s = 8884, 64, 30.0
    flops = sum(2 * convnext_work.multiply_adds(h, w, m.depths, m.dims)
                for h, w in ((d.surface_height, d.surface_width_max),
                             (d.overhead_size, d.overhead_size)))
    least_eval_s = pairs * flops / 989e12
    assert 1.3 < least_eval_s < 1.4
    evals = int(window_s / least_eval_s) + 2  # the last eval runs to its end
    per_eval = -(-pairs // batch) * per_batch + 64  # and the rank and recall spans
    assert evals * per_eval <= profiling.SPAN_CAPACITY


def test_embed_step_tree_of_the_baseline_preprocess():
    """The baseline family's own preprocess (a rotation draw, CVUSA rows
    repeated to 384 x 384) and towers."""
    cfg = baseline_experiment("cvusa")
    pipeline = make_pipeline(cfg, "cpu")
    params = pipeline.init(torch.Generator().manual_seed(0))
    batch = {"surface": torch.zeros(1, 192, 384, 3), "overhead": torch.zeros(1, 384, 384, 3)}
    _, records = _recorded(lambda: pipeline.embed_step(params, batch, torch.Generator()))
    assert _tree(records) == EMBED_TREE[:2] + [("draw", "preprocess", "embed")] \
        + EMBED_TREE[2:]


def test_gallery_ranks_tree():
    g = torch.Generator().manual_seed(1)
    o = torch.randn(6, 2, 16, 4, generator=g)
    s = o[:, :, 2:10] + 0.3 * torch.randn(6, 2, 8, 4, generator=g)
    evaluator = FovGalleryEvaluator(query_block=4, gallery_chunk=4, use_fused=True, device="cpu")
    want = evaluator.ranks(o, s)
    got, records = _recorded(lambda: evaluator.ranks(o, s))
    np.testing.assert_array_equal(got, want)
    assert _tree(records) == [("rank", None, "rank"), ("rank.true", "rank", "rank"),
                              ("rank.block", "rank", "rank"), ("rank.block", "rank", "rank"),
                              ("rank.fetch", "rank", "rank")]


def test_euclidean_ranks_tree():
    g = torch.Generator().manual_seed(2)
    gal = torch.nn.functional.normalize(torch.randn(5, 8, generator=g), dim=1)
    q = gal + 0.2 * torch.randn(5, 8, generator=g)
    want = euclidean_ranks(gal, q, block=3, device="cpu")
    got, records = _recorded(lambda: euclidean_ranks(gal, q, block=3, device="cpu"))
    np.testing.assert_array_equal(got, want)
    block = [("rank.block", "rank", "rank"), ("rank.true", "rank.block", "rank")]
    assert _tree(records) == [("rank", None, "rank")] + block + block + [
        ("rank.fetch", "rank", "rank")]


def test_test_ranks_tree():
    """``test_ranks`` is the root; ``embed_all``'s ``eval`` and each batch's
    ``embed`` sit under it, then the sweep and the recall."""
    cfg = _cfg(fov_experiment)
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, query_block=4, gallery_chunk=4))
    pipeline = make_pipeline(cfg, "cpu")
    params = pipeline.init(torch.Generator().manual_seed(0))
    loader = [{k: v.numpy() for k, v in _batch(cfg, seed=i).items()} for i in range(2)]
    (metrics, _), records = _recorded(
        lambda: loop.test_ranks(cfg, pipeline, loader, params, verbose=False))
    assert metrics["locations"] == 4
    tree = _tree(records)
    assert all(root == "eval" for _, _, root in tree)
    assert [(n, p) for n, p, _ in tree if n in ("eval", "embed", "rank", "recall")] == [
        ("eval", None), ("eval", "eval"), ("embed", "eval"), ("embed", "eval"),
        ("rank", "eval"), ("recall", "eval")]


def test_train_step_tree():
    cfg = _cfg(fov_experiment, dropout=0.2)
    pipeline = make_pipeline(cfg, "cpu")
    state = pipeline.init_state(torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    _, records = _recorded(lambda: pipeline.train_step(state, batch, torch.Generator()))
    tree = _tree(records)
    assert all(root == "train.step" for _, _, root in tree)
    masks = [("draw", "tower.surface")] * 3 + [("tower.overhead", "train.forward")] \
        + [("draw", "tower.overhead")] * 3
    assert [(n, p) for n, p, _ in tree] == [
        ("train.step", None), ("train.forward", "train.step"), ("preprocess", "train.forward"),
        ("draw", "preprocess"), ("tower.surface", "train.forward")] + masks + [
        ("train.backward", "train.step"), ("train.optimizer", "train.step")]
    assert state.step == 1
