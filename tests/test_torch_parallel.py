"""The port's single-process mesh (witw_tpu_torch.parallel) and its sharded
paths against the port's single-device calls and witw_tpu's sharded calls,
on the CPU.

The port runs on meshes of 2, 3 and 8 entries of ``torch.device("cpu")``;
witw_tpu on the conftest's 8 virtual CPU devices (``make_mesh(n_data=8)``,
as tests/test_parallel.py and tests/test_eval.py do). Data is planted
(each query a noisy window of its own gallery item, so that no rank sits on
a roundoff tie) or, for the Euclidean paths, on an integer lattice, whose
products are exact. Tolerances: ranks, top-k indices and orientations equal;
distances within rtol 1e-5, atol 1e-6. Gallery sizes (41, 53, 45, 67) do not
divide the meshes, so every sharded path meets padded rows.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from witw_tpu.evaluation.gallery import FovGalleryEvaluator as JaxEvaluator
from witw_tpu.evaluation.gallery import euclidean_ranks as jax_euclidean_ranks
from witw_tpu.evaluation.index import GalleryIndex as JaxIndex
from witw_tpu.evaluation.vector_index import VectorIndex as JaxVectorIndex
from witw_tpu.parallel import make_mesh as jax_make_mesh
from witw_tpu_torch.configs import baseline_experiment, fov_experiment, safa_experiment
from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator, euclidean_ranks
from witw_tpu_torch.evaluation.index import GalleryIndex
from witw_tpu_torch.evaluation.vector_index import VectorIndex
from witw_tpu_torch.parallel import mesh as pmesh
from witw_tpu_torch.parallel import make_mesh
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.pipeline import make_pipeline

CPU = torch.device("cpu")
MESH_SIZES = (2, 3, 8)
H, W, SW, C = 2, 16, 8, 3


def cpu_mesh(n):
    return make_mesh(devices=[CPU] * n)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(n_data=8)


def _planted_maps(rng, n_gal, n_q, noise=2.0):
    """Gallery maps [n_gal, H, W, C] and queries [n_q, H, SW, C], query i a
    window of gallery item i at a random offset under noise that spreads
    the ranks."""
    o = rng.standard_normal((n_gal, H, W, C)).astype(np.float32)
    shifts = rng.integers(0, W, n_q)
    s = np.stack([o[i][:, (shifts[i] + np.arange(SW)) % W] for i in range(n_q)])
    s = s + noise * rng.standard_normal(s.shape)
    return o, s.astype(np.float32)


def _maps_cases(rng):
    """(gallery, queries, true_match): paired (41 of each), and an
    asymmetric 53-item gallery whose true matches are permuted."""
    o, s = _planted_maps(rng, 41, 41)
    extra, s2 = _planted_maps(rng, 53, 30)
    perm = rng.permutation(53)
    return {"paired": (o, s, None), "true_match": (extra[perm], s2, np.argsort(perm)[:30])}


@pytest.fixture(scope="module")
def maps():
    return _maps_cases(np.random.default_rng(16))


@pytest.fixture(scope="module")
def jax_ranks(maps, jax_mesh):
    """witw_tpu's sharded ranks per (case, shard_gallery, fast_matmul)."""
    out = {}
    for case, (o, s, tm) in maps.items():
        for shard_gallery in (False, True):
            for fast in (False, True):
                ev = JaxEvaluator(mesh=jax_mesh, query_block=16, gallery_chunk=8,
                                  shard_gallery=shard_gallery, fast_matmul=fast)
                out[case, shard_gallery, fast] = np.asarray(ev.ranks(o, s, tm))
    return out


def test_make_mesh_needs_a_card_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = make_mesh()  # names the cards without touching them
    assert cards.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert cards.shape == {"data": 2, "gallery": 1}


def test_mesh_grid_counts_positions_not_devices():
    mesh = make_mesh(n_data=4, n_gallery=2, devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.shape == {pmesh.DATA_AXIS: 4, pmesh.GALLERY_AXIS: 2}
    assert mesh.devices == (CPU,) * 8 and len(mesh.local_data_devices) == 4
    assert make_mesh(devices=["cpu"] * 3) == cpu_mesh(3) != cpu_mesh(2)
    assert hash(cpu_mesh(3)) == hash(make_mesh(devices=[CPU] * 3))
    assert make_mesh(n_gallery=2, devices=["cpu"] * 5).shape == {"data": 2, "gallery": 2}
    with pytest.raises(ValueError):
        make_mesh(n_data=3, devices=["cpu"] * 2)


def test_gallery_shards_replicate_and_shard_batch(rng):
    x = rng.standard_normal((11, 2, 3)).astype(np.float32)
    mesh = cpu_mesh(3)
    shards = pmesh.gallery_shards(x, mesh)
    assert pmesh.placement(shards) == [
        {"device": CPU, "start": 0, "rows": 4, "valid": 4},
        {"device": CPU, "start": 4, "rows": 4, "valid": 4},
        {"device": CPU, "start": 8, "rows": 4, "valid": 3}]
    np.testing.assert_array_equal(torch.cat([s.data for s in shards])[:11].numpy(), x)
    assert not shards[2].data[3].any() and shards[2].mask.tolist() == [True] * 3 + [False]
    wide = pmesh.gallery_shards(torch.from_numpy(x), mesh, rows=8)  # the last shard all padding
    assert [s.valid for s in wide] == [8, 3, 0] and not wide[2].mask.any()
    with pytest.raises(ValueError):
        pmesh.gallery_shards(x, mesh, rows=3)
    copies = pmesh.replicate(x, mesh)
    assert len(copies) == 3 and copies[0] is copies[2]  # one copy per distinct device
    np.testing.assert_array_equal(copies[1].numpy(), x)
    batch = {"surface": x[:6], "valid": np.ones(6, bool)}
    parts = pmesh.shard_batch(batch, cpu_mesh(2))
    assert [len(p["surface"]) for p in parts] == [3, 3]
    np.testing.assert_array_equal(parts[1]["surface"].numpy(), x[3:6])
    with pytest.raises(ValueError, match="split"):
        pmesh.shard_batch(batch, cpu_mesh(4))


@pytest.mark.parametrize("n_dev", MESH_SIZES)
@pytest.mark.parametrize("shard_gallery", [False, True], ids=["query_axis", "gallery_resident"])
@pytest.mark.parametrize("path", ["fused", "fft", "fft_fast"])
def test_fov_ranks_sharded_match_single_and_jax(maps, jax_ranks, path, shard_gallery, n_dev):
    """Both sweeps, with the fused match's plain version and with the FFT
    (exact and fast_matmul): ranks equal the port's single-device sweep and
    witw_tpu's sharded one (witw_tpu's gallery-resident sweep is FFT only;
    the fused match computes the same distances)."""
    kw = dict(query_block=16, gallery_chunk=8, use_fused=path == "fused",
              fast_matmul=path == "fft_fast")
    for case, (o, s, tm) in maps.items():
        single = FovGalleryEvaluator(device=CPU, **kw).ranks(o, s, tm)
        ev = FovGalleryEvaluator(mesh=cpu_mesh(n_dev), shard_gallery=shard_gallery, **kw)
        got = ev.ranks(o, s, tm)
        assert got.dtype == np.int32 and len(set(got.tolist())) > 3, (case, got)
        np.testing.assert_array_equal(got, single, err_msg=case)
        np.testing.assert_array_equal(got, jax_ranks[case, shard_gallery, path == "fft_fast"],
                                      err_msg=case)
        if shard_gallery:  # witw_tpu's chunk arithmetic: min(8, ceil(n / n_dev)) a chunk
            n = len(o)
            chunk = min(8, -(-n // n_dev))
            rows = -(-n // (n_dev * chunk)) * chunk
            assert [(p["device"], p["start"], p["rows"]) for p in ev.last_gallery_placement] == [
                (CPU, d * rows, rows) for d in range(n_dev)]
            assert sum(p["valid"] for p in ev.last_gallery_placement) == n
        else:
            assert ev.last_gallery_placement is None


def test_fov_evaluator_shard_gallery_needs_a_mesh():
    with pytest.raises(ValueError, match="requires a mesh"):
        FovGalleryEvaluator(shard_gallery=True)


def _lattice(rng, n_gal, n_q, dim):
    """Integer-lattice gallery and queries (exact f32 products): queries
    near their true matches, ties included, ranks spread."""
    g = rng.integers(-3, 4, (n_gal, dim)).astype(np.float32)
    q = g[:n_q] + rng.integers(-3, 4, (n_q, dim)).astype(np.float32)
    g[n_q] = g[1]  # a duplicate of a true match: an exact tie that counts
    return g, q


@pytest.mark.parametrize("n_dev", MESH_SIZES)
def test_euclidean_ranks_sharded_match_single_and_jax(n_dev, jax_mesh):
    rng = np.random.default_rng(17)
    g, q = _lattice(rng, 67, 40, 8)
    perm = rng.permutation(67)
    for tm, gal in ((None, g[:40]), (np.argsort(perm)[:40], g[perm])):
        single = euclidean_ranks(gal, q, block=7, true_match=tm, device=CPU)
        got = euclidean_ranks(gal, q, block=7, true_match=tm, mesh=cpu_mesh(n_dev))
        want = np.asarray(jax_euclidean_ranks(gal, q, block=7, true_match=tm, mesh=jax_mesh))
        assert len(set(got.tolist())) > 3
        np.testing.assert_array_equal(got, single)
        np.testing.assert_array_equal(got, want)


def _planted_index_queries(rng, n=45, k_planted=6):
    """A 45-tile gallery [n, H, W, C] and queries of widths SW and W, each a
    noisy window of a planted tile."""
    o = rng.standard_normal((n, H, W, 4)).astype(np.float32)
    planted = rng.choice(n, k_planted, replace=False)
    starts = rng.integers(0, W, k_planted)
    queries = {}
    for sw in (SW, W):
        cols = (starts[:, None] + np.arange(sw)[None]) % W
        qq = np.stack([o[g][:, c] for g, c in zip(planted, cols)])
        queries[sw] = (qq + 0.3 * rng.standard_normal(qq.shape)).astype(np.float32)
    return o, queries, planted


@pytest.mark.parametrize("n_dev", MESH_SIZES)
def test_gallery_index_sharded_match_single_and_jax(n_dev, jax_mesh):
    """place_sharded / search_sharded / score_all_sharded against search /
    score_all and witw_tpu's sharded methods; the chunk is at least max_k;
    k over max_k and an unplaced index raise."""
    rng = np.random.default_rng(18)
    o, queries, planted = _planted_index_queries(rng)
    index = GalleryIndex(o, device=CPU)
    jindex = JaxIndex(o)
    jindex.place_sharded(jax_mesh, gallery_chunk=4, max_k=8)
    with pytest.raises(ValueError, match="place_sharded"):
        index.search_sharded(queries[SW], k=5)
    mesh = cpu_mesh(n_dev)
    index.place_sharded(mesh, gallery_chunk=4, max_k=8)
    n_local = -(-45 // n_dev)
    assert index._sharded["chunk"] == max(min(4, n_local), min(8, n_local))
    assert [p["device"] for p in index.last_gallery_placement] == [CPU] * n_dev
    assert sum(p["valid"] for p in index.last_gallery_placement) == 45
    for sw, q in queries.items():
        i1, d1, o1 = index.search(q, k=7)
        i2, d2, o2 = index.search_sharded(q, k=7)
        ij, dj, oj = jindex.search_sharded(q, k=7)
        assert np.array_equal(i2[:, 0], planted)
        for want_i, want_d, want_o in ((i1, d1, o1), (ij, dj, oj)):
            np.testing.assert_array_equal(i2, want_i)
            np.testing.assert_array_equal(o2, want_o)
            np.testing.assert_allclose(d2, want_d, rtol=1e-5, atol=1e-6)
        assert (i2.dtype, d2.dtype, o2.dtype) == (np.int64, np.float32, np.int32)
        d_all, o_all = index.score_all_sharded(q)
        for want_d, want_o in (index.score_all(q), jindex.score_all_sharded(q)):
            np.testing.assert_array_equal(o_all, want_o)
            np.testing.assert_allclose(d_all, want_d, rtol=1e-5, atol=1e-6)
        assert d_all.shape == (45, len(q))
    with pytest.raises(ValueError, match="max_k"):
        index.search_sharded(queries[SW], k=9)
    other = cpu_mesh(3 if n_dev == 2 else 2)
    fast = index.search_sharded(queries[SW], k=3, mesh=other, fast=True)  # re-placed
    assert index._sharded["mesh"] == other and index._sharded["max_k"] == 128
    np.testing.assert_array_equal(fast[0], index.search(queries[SW], k=3, fast=True)[0])


@pytest.mark.parametrize("n_dev", MESH_SIZES)
def test_vector_index_sharded_match_single_and_jax(n_dev, jax_mesh):
    """VectorIndex's sharded methods on lattice vectors, against search /
    score_all and witw_tpu's; exact ties across shards keep ascending global
    index, as search() orders them."""
    rng = np.random.default_rng(19)
    g, q = _lattice(rng, 67, 9, 10)
    g[[20, 50, 66]] = g[3]  # copies of row 3 in other shards: equal distances
    q[0] = g[3] + 1.0
    index = VectorIndex(g, device=CPU)
    jindex = JaxVectorIndex(g)
    jindex.place_sharded(jax_mesh, gallery_chunk=4, max_k=8)
    index.place_sharded(cpu_mesh(n_dev), gallery_chunk=4, max_k=8)
    i1, d1 = index.search(q, k=8)
    i2, d2 = index.search_sharded(q, k=8)
    ij, dj = jindex.search_sharded(q, k=8)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-6)
    assert i2[0, :4].tolist() == [3, 20, 50, 66]
    # witw_tpu's host merge leaves the order of equal distances open
    np.testing.assert_allclose(d2, dj, rtol=1e-5, atol=1e-6)
    for r in range(len(q)):
        for v in np.unique(d2[r])[:-1]:  # the last group may be cut at k
            assert set(i2[r][d2[r] == v]) == set(ij[r][dj[r] == v])
    d_all = index.score_all_sharded(q)
    np.testing.assert_allclose(d_all, index.score_all(q), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_all, jindex.score_all_sharded(q), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="max_k"):
        index.search_sharded(q, k=9)
    with pytest.raises(ValueError, match="place_sharded"):
        VectorIndex(g, device=CPU).score_all_sharded(q)


# --- embed_all(mesh=) and loop.test(mesh=), every family -------------------

def _family_cfg(family):
    """Small presets whose eval draws matter: FOV 90 and SAFA with a random
    crop heading, the baseline's synced rotation (WITW: no row repeat)."""
    if family == "fov":
        cfg = fov_experiment("cvusa", 90)
        geometry = dict(surface_height=32, surface_width_max=64, overhead_size=32,
                        random_orientation=True)
    elif family == "safa":
        cfg = safa_experiment("cvusa", 90)
        geometry = dict(surface_height=32, surface_width_max=128, overhead_size=32,
                        random_orientation=True)
    else:
        cfg = baseline_experiment("witw")
        geometry = {}
    return cfg.replace(data=dataclasses.replace(cfg.data, **geometry),
                       model=dataclasses.replace(cfg.model, compute_dtype="float32"))


def _batches(rng, cfg, sizes):
    d = cfg.data
    if cfg.model.kind == "baseline":
        s_hw, o_hw = (384, 384), (384, 384)  # seven 4 x 4 stride-2 convs need 384
    else:
        s_hw, o_hw = (d.surface_height, d.surface_width_max), (d.overhead_size, d.overhead_size)
    out = []
    for b in sizes:
        over = rng.uniform(0, 255, (b, 4, 4, 3))
        over = np.repeat(np.repeat(over, o_hw[0] // 4, axis=1), o_hw[1] // 4, axis=2)
        surf = rng.uniform(0, 255, (b, *s_hw, 3))
        out.append({"surface": surf.astype(np.float32), "overhead": over.astype(np.float32)})
    return out


@pytest.mark.parametrize("family", ["fov", "safa", "baseline"])
def test_embed_all_and_test_on_a_mesh_equal_one_device(family):
    """Batches of 4, 4 and a straggler of 3 on meshes of 2 and 3 (the
    straggler zero-padded, its padded rows dropped): the embeddings equal
    one device's within f32 (the draws do not depend on the mesh), and
    loop.test_ranks gives the same ranks and metrics, the FOV family's
    through both sweeps."""
    cfg = _family_cfg(family)
    pipeline = make_pipeline(cfg, CPU)
    params = pipeline.init(torch.Generator().manual_seed(3))
    batches = _batches(np.random.default_rng(20), cfg, (4, 4, 3))
    gen = lambda: torch.Generator().manual_seed(cfg.train.seed + 1)  # noqa: E731
    s_one, o_one = loop.embed_all(pipeline, params, batches, gen())
    metrics, ranks = loop.test_ranks(cfg, pipeline, batches, params, verbose=False)
    assert len(set(ranks.tolist())) > 1
    for n_dev in (2, 3):
        mesh = cpu_mesh(n_dev)
        s_m, o_m = loop.embed_all(pipeline, params, batches, gen(), mesh=mesh)
        assert s_m.shape == s_one.shape and o_m.shape == o_one.shape
        for got, want in ((s_m, s_one), (o_m, o_one)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
        for shard_gallery in ((False, True) if family == "fov" else (False,)):
            c = cfg.replace(eval=dataclasses.replace(cfg.eval, shard_gallery=shard_gallery))
            got_metrics, got = loop.test_ranks(c, pipeline, batches, params, verbose=False,
                                               mesh=mesh)
            np.testing.assert_array_equal(got, ranks)
            assert got_metrics == metrics
    assert loop.test(cfg, pipeline, batches, params, verbose=False, mesh=cpu_mesh(2)) == metrics


def test_device_prefetch_pads_the_straggler_over_the_data_axis(rng):
    cfg = _family_cfg("fov")
    batches = _batches(rng, cfg, (4, 3))
    mesh = make_mesh(n_data=2, n_gallery=2, devices=["cpu"] * 4)
    out = list(loop.device_prefetch(batches, None, mesh=mesh))
    assert [n for _, n in out] == [4, 3]
    shards, _ = out[1]
    assert len(shards) == 2 and [len(s["surface"]) for s in shards] == [2, 2]
    assert shards[1]["valid"].tolist() == [True, False]
    assert not shards[1]["surface"][1].any()
    np.testing.assert_array_equal(shards[1]["overhead"][0].numpy(), batches[1]["overhead"][2])


def test_shard_gallery_without_a_mesh_warns_and_sweeps_one_device():
    cfg = _family_cfg("fov")
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, shard_gallery=True))
    pipeline = make_pipeline(cfg, CPU)
    params = pipeline.init(torch.Generator().manual_seed(3))
    batches = _batches(np.random.default_rng(21), cfg, (3, 2))
    with pytest.warns(UserWarning, match="shard_gallery requested"):
        _, ranks = loop.test_ranks(cfg, pipeline, batches, params, verbose=False)
    plain = cfg.replace(eval=dataclasses.replace(cfg.eval, shard_gallery=False))
    np.testing.assert_array_equal(ranks, loop.test_ranks(plain, pipeline, batches, params,
                                                         verbose=False)[1])


def test_auto_mesh_and_run_train_on_several_cards(monkeypatch, tmp_path):
    """cli.common._auto_mesh: a data mesh over every card when there are
    several and the batch divides over them, else None; run_train trains
    data-parallel on it (witw_tpu/cli/common.py:90), and on one device when
    a device is given."""
    from witw_tpu_torch.cli import common

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert common._auto_mesh(64) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = common._auto_mesh(64)
    assert mesh.shape == {"data": 2, "gallery": 1} and mesh.size == 2
    assert common._auto_mesh(63) is None
    cfg = fov_experiment("cvusa", 360)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp_path / "ck"),
                                                tensorboard_dir=str(tmp_path / "tb")))
    seen = []
    monkeypatch.setattr(common, "read_pair_paths", lambda *args: [("s", "o")] * 8)
    monkeypatch.setattr(common, "make_pipeline", lambda *args: None)
    monkeypatch.setattr(common.loop, "train", lambda *args, mesh=None, **kw: seen.append(mesh))
    monkeypatch.setattr(common, "_auto_mesh", lambda b: ("every card", b))
    common.run_train(cfg, "tag")
    common.run_train(cfg, "tag", device="cpu")
    assert seen == [("every card", cfg.train.batch_size), None]


def test_tools_take_shard_gallery(monkeypatch, tmp_path):
    """--shard-gallery on tools.serve and tools.heatmap builds make_mesh()'s
    mesh over every card and hands it to the service / the sweep; without
    the flag they get none."""
    from witw_tpu_torch.tools import heatmap, serve

    seen = {}

    class Stop(Exception):
        pass

    def service(*args, mesh=None, **kwargs):
        seen["serve"] = mesh
        raise Stop

    def sweep(*args, mesh=None, **kwargs):
        seen["heatmap"] = mesh
        return {}

    for mod in (serve, heatmap):
        monkeypatch.setattr(mod, "make_mesh", lambda: "every card")
    monkeypatch.setattr(serve.GalleryIndex, "load", staticmethod(
        lambda path: GalleryIndex(np.zeros((2, 1, 8, 4), np.float32), device=CPU)))
    monkeypatch.setattr(serve, "load_params", lambda *args: {"surface": {}, "overhead": {}})
    monkeypatch.setattr(serve, "GeolocateService", service)
    monkeypatch.setattr(heatmap, "sweep", sweep)
    for flags, want in (([], None), (["--shard-gallery"], "every card")):
        with pytest.raises(Stop):
            serve.main(["--index", str(tmp_path / "tiles.npz")] + flags)
        heatmap.main(["-s", str(tmp_path)] + flags)
        assert seen == {"serve": want, "heatmap": want}
