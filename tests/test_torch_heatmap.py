"""The port's heatmap sweep (witw_tpu_torch.tools.heatmap) against
witw_tpu.tools.heatmap on the CPU, mirroring tests/test_pipeline_e2e.py's
sweep tests (:121-339) at tests/test_torch_serve.py's narrow geometry.

A 1200^2 synthetic UTM strip at 0.3 m per pixel and 4 tiles; photos and
strip from numpy ``default_rng``; towers a flax init moved into the port
with ``convert_jax``. Tolerances: f32 towers as
tests/test_torch_models.py (rtol 1e-3, atol 1e-4) with orientations equal;
bf16 towers as test_torch_serve.py:219 (rtol 5e-2, atol 5e-3); the int8
sweep, given witw_tpu's calibrated scales, within 1e-5.
"""

import csv
import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from witw_tpu.configs import fov_experiment as jax_fov_experiment
from witw_tpu.evaluation.index import GalleryIndex as JaxIndex
from witw_tpu.models import quantize as jq
from witw_tpu.tools import geotiff as jgt
from witw_tpu.tools import heatmap as jheat
from witw_tpu.train.pipeline import make_pipeline
from witw_tpu_torch.configs import fov_experiment
from witw_tpu_torch.evaluation.index import GalleryIndex
from witw_tpu_torch.models import quantize as tq
from witw_tpu_torch.models.convert_jax import jax_params_to_state_dict
from witw_tpu_torch.tools import geotiff as tgt
from witw_tpu_torch.tools import heatmap as theat

GEOMETRY = dict(surface_height=64, surface_width_max=128, overhead_size=32)
E0, N0 = 447600.0, 5411900.0
BOUNDS = (E0 + 30, N0 - 250, E0 + 250, N0 - 30)  # 2 x 2 tiles of 225 m at 112.5 m
GRID = dict(edge=225.0, offset=112.5, fov=70, verbose=False)
COLUMNS = ["x", "y", "orientation", "dissimilarity", "score"]


def _cfgs(compute_dtype="bfloat16", **geometry):
    cfgs = []
    for make in (jax_fov_experiment, fov_experiment):
        cfg = make("witw", 70)
        cfgs.append(cfg.replace(
            data=dataclasses.replace(cfg.data, **(geometry or GEOMETRY)),
            model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype)))
    return cfgs


@pytest.fixture(scope="module")
def states():
    """witw_tpu states of two seeds and the same weights in the port's
    layout."""
    jcfg, _ = _cfgs()
    init = jax.jit(make_pipeline(jcfg).init)
    out = []
    for seed in (0, 1):
        state = init(jax.random.PRNGKey(seed))
        out.append((state, jax_params_to_state_dict(jax.tree.map(np.asarray, state.params))))
    return out


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 1200^2 uint8 strip (EPSG 32631, 0.3 m pixels) and two photos."""
    root = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(21)
    sat = str(root / "03_paris.tif")
    jgt.write_geotiff_u8(sat, rng.integers(1, 255, (1200, 1200, 3), dtype=np.uint8),
                         np.array([E0, 0.3, 0, N0, 0, -0.3]), 32631)
    photos = []
    for k in range(2):
        photos.append(str(root / f"img{k}.jpg"))
        Image.fromarray(rng.integers(0, 255, (100, 200, 3), dtype=np.uint8)).save(photos[-1])
    return root, sat, photos


def _jax_sweep(scene, state, name, cfg, **kw):
    root, sat, photos = scene
    frame = jheat.sweep(sat, kw.pop("photos", photos[0]), str(root / f"{name}.csv"), BOUNDS,
                        state=state, cfg=cfg, **GRID, **kw)
    return frame, str(root / f"{name}.csv")


def _port_sweep(scene, params, name, cfg, **kw):
    root, sat, photos = scene
    path = str(root / f"{name}.csv")
    cols = theat.sweep(kw.pop("sat", sat), kw.pop("photos", photos[0]), path, BOUNDS,
                       state=params, cfg=cfg, device="cpu", **GRID, **kw)
    return cols, path


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def f32_sweeps(scene, states):
    """witw_tpu's and the port's sweeps with f32 towers; witw_tpu's writes
    an index cache."""
    (state, params), _ = states
    jcfg, tcfg = _cfgs("float32")
    root = scene[0]
    want, want_csv = _jax_sweep(scene, state, "j32", jcfg, index_cache=str(root / "jax_cache.npz"))
    got, got_csv = _port_sweep(scene, params, "t32", tcfg, index_cache=str(root / "port_cache"))
    return want, want_csv, got, got_csv


def test_f32_sweep_matches_jax(f32_sweeps):
    want, want_csv, got, got_csv = f32_sweeps
    assert list(got) == list(want.columns) == COLUMNS
    assert _rows(got_csv)[0] == _rows(want_csv)[0] == COLUMNS
    assert len(got["x"]) == 4
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_array_equal(got["orientation"], want["orientation"])
    for key in ("dissimilarity", "score"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["score"], np.exp(10 * (1 - got["dissimilarity"])), rtol=1e-6)
    # the CSV holds the returned columns, x and y as witw_tpu writes them
    rows = _rows(got_csv)[1:]
    for j, key in enumerate(COLUMNS):  # each value's shortest repr in its own dtype
        np.testing.assert_array_equal(np.asarray([r[j] for r in rows], got[key].dtype), got[key])
    assert [r[:2] for r in rows] == [r[:2] for r in _rows(want_csv)[1:]]


def test_bf16_sweep_matches_jax(scene, states):
    (state, params), _ = states
    jcfg, tcfg = _cfgs("bfloat16")
    want, _ = _jax_sweep(scene, state, "j16", jcfg)
    got, _ = _port_sweep(scene, params, "t16", tcfg)
    np.testing.assert_allclose(got["dissimilarity"], want["dissimilarity"], rtol=5e-2, atol=5e-3)
    np.testing.assert_allclose(got["score"], np.exp(10 * (1 - got["dissimilarity"])), rtol=1e-6)


def test_serial_equals_prefetch(scene, states, f32_sweeps):
    """The producer thread only reorders when batches are read: serial and
    prefetched sweeps are equal."""
    _, params = states[0]
    _, tcfg = _cfgs("float32")
    got = f32_sweeps[2]
    serial, _ = _port_sweep(scene, params, "t32_serial", tcfg, prefetch_tiles=0, batch_size=3)
    for key in COLUMNS:
        np.testing.assert_array_equal(serial[key], got[key], err_msg=key)


def test_several_photos(scene, states, f32_sweeps):
    """Three photos (the first repeated) against one gallery: a leading
    photo column, equal rows for equal photos, each photo's rows those of
    its own sweep."""
    _, params = states[0]
    _, tcfg = _cfgs("float32")
    photos = scene[2]
    got = f32_sweeps[2]
    multi, path = _port_sweep(scene, params, "t32_multi", tcfg, photos=[photos[0], photos[0],
                                                                        photos[1]])
    assert list(multi) == ["photo"] + COLUMNS
    assert _rows(path)[0] == ["photo"] + COLUMNS
    assert list(multi["photo"]) == [photos[0]] * 8 + [photos[1]] * 4
    for key in COLUMNS:
        np.testing.assert_array_equal(multi[key][:4], multi[key][4:8], err_msg=key)
        np.testing.assert_allclose(multi[key][:4], got[key], rtol=1e-5, atol=1e-6, err_msg=key)
    single, _ = _port_sweep(scene, params, "t32_p1", tcfg, photos=photos[1])
    np.testing.assert_allclose(multi["dissimilarity"][8:], single["dissimilarity"], rtol=1e-5,
                               atol=1e-6)


def test_index_cache(scene, states, f32_sweeps):
    """A cache hit reproduces the CSV without reading the strip; witw_tpu's
    cache of the same weights and grid is a hit for the port; new weights
    rebuild the cache."""
    (_, params), (_, params2) = states
    _, tcfg = _cfgs("float32")
    root = scene[0]
    _, want_csv, got, got_csv = f32_sweeps
    missing = str(root / "no_such_strip.tif")
    hit, hit_csv = _port_sweep(scene, params, "t32_hit", tcfg, sat=missing,
                               index_cache=str(root / "port_cache.npz"))
    assert _rows(hit_csv) == _rows(got_csv)
    meta = GalleryIndex.load(str(root / "port_cache.npz"), "cpu").meta
    assert (str(meta["precision"]), str(meta["tile_dtype"]), str(meta["family"])) == (
        "f32", "float32", "fov")
    assert str(meta["params_sha"]) == str(JaxIndex.load(str(root / "jax_cache.npz"))
                                          .meta["params_sha"])
    from_jax, _ = _port_sweep(scene, params, "t32_jaxcache", tcfg, sat=missing,
                              index_cache=str(root / "jax_cache.npz"))
    np.testing.assert_array_equal(from_jax["orientation"], got["orientation"])
    np.testing.assert_allclose(from_jax["dissimilarity"], got["dissimilarity"], rtol=1e-3,
                               atol=1e-4)
    with pytest.raises(IOError):  # other weights: stale, so the strip is read
        _port_sweep(scene, params2, "t32_stale", tcfg, sat=missing,
                    index_cache=str(root / "port_cache.npz"))
    _port_sweep(scene, params2, "t32_rebuilt", tcfg, index_cache=str(root / "port_cache.npz"))
    rebuilt = GalleryIndex.load(str(root / "port_cache.npz"), "cpu").meta
    assert str(rebuilt["params_sha"]) != str(meta["params_sha"])


def test_cache_is_stale_predicate():
    """tests/test_tools.py:471's cases on the port's predicate."""
    emb = np.zeros((4, 1, 2, 8), np.float32)
    xs = np.arange(4.0)
    idx = GalleryIndex(emb, meta={"x": xs, "precision": "f32", "params_sha": "abc"},
                       device="cpu")
    stale = theat._cache_is_stale
    assert not stale(idx, 4, xs, "f32")
    assert not stale(idx, 4, xs, "f32", "abc")
    assert stale(idx, 5, np.arange(5.0), "f32")
    assert stale(idx, 4, xs + 1.0, "f32")
    assert stale(idx, 4, xs, "int8")
    assert stale(idx, 4, xs, "f32", "OTHER")
    assert stale(idx, 4, xs, "f32", tile_dtype="uint8")
    assert stale(idx, 4, xs, "f32", family="safa")
    assert not stale(idx, 4, xs, "f32", family="fov")
    bare = GalleryIndex(emb, device="cpu")
    assert stale(bare, 4, xs, "f32")
    assert stale(bare, 4, xs, "f32", "abc")


def test_uint8_tiles(scene, states, f32_sweeps):
    """tile_dtype="uint8" against f32 tiles (test_pipeline_e2e.py:285): the
    scores within the resample's rounding, the cache records the dtype and
    an f32 sweep against a uint8 cache rebuilds it."""
    _, params = states[0]
    _, tcfg = _cfgs("float32")
    root = scene[0]
    got = f32_sweeps[2]
    cache = str(root / "u8_cache.npz")
    u8, _ = _port_sweep(scene, params, "t32_u8", tcfg, index_cache=cache, tile_dtype="uint8")
    assert str(GalleryIndex.load(cache, "cpu").meta["tile_dtype"]) == "uint8"
    np.testing.assert_allclose(u8["dissimilarity"], got["dissimilarity"], rtol=0.05, atol=0.02)
    assert np.argmin(u8["dissimilarity"]) == np.argmin(got["dissimilarity"])
    _port_sweep(scene, params, "t32_u8_f32", tcfg, index_cache=cache)
    assert str(GalleryIndex.load(cache, "cpu").meta["tile_dtype"]) == "float32"
    with pytest.raises(ValueError, match="tile_dtype"):
        _port_sweep(scene, params, "t32_bad", tcfg, tile_dtype="float16")


def test_layer_matches_jax(scene):
    root, sat, _ = scene
    jheat.layer(sat, BOUNDS, str(root / "j_layer.tif"))
    theat.layer(sat, BOUNDS, str(root / "t_layer.tif"))
    with jgt.GeoTiff(str(root / "j_layer.tif")) as want, tgt.GeoTiff(str(root / "t_layer.tif")) as got:
        np.testing.assert_array_equal(got.read(), want.read())
        np.testing.assert_array_equal(got.geotransform, want.geotransform)
        assert got.epsg == want.epsg == 32631
        assert abs(got.width - round((BOUNDS[2] - BOUNDS[0]) / 0.3)) <= 1


def test_int8_sweep_matches_jax_given_its_scales(scene, states, monkeypatch):
    """--int8 at the smallest geometry: with witw_tpu's calibrated scales
    (surface tower on the photo, overhead tower on the grid-spanning
    sample) the port's static tables give witw_tpu's sweep, and the cache
    records the precision and the clip fraction."""
    (state, params), _ = states
    geometry = dict(surface_height=32, surface_width_max=64, overhead_size=32)
    jcfg, tcfg = _cfgs("bfloat16", **geometry)
    root = scene[0]
    scales = []
    real_scales = jq.calibrate_fov_activation_scales

    def record(*args, **kwargs):
        scales.append(real_scales(*args, **kwargs))
        return scales[-1]

    monkeypatch.setattr(jq, "calibrate_fov_activation_scales", record)
    want, _ = _jax_sweep(scene, state, "j8", jcfg, int8=True, batch_size=4)
    replay = iter(scales)
    monkeypatch.setattr(tq, "calibrate_fov_activation_scales", lambda *a, **k: next(replay))
    cache = str(root / "int8_cache.npz")
    got, _ = _port_sweep(scene, params, "t8", tcfg, int8=True, batch_size=4, index_cache=cache)
    assert len(scales) == 2 and next(replay, None) is None
    np.testing.assert_array_equal(got["orientation"], want["orientation"])
    np.testing.assert_allclose(got["dissimilarity"], want["dissimilarity"], rtol=0, atol=1e-5)
    meta = GalleryIndex.load(cache, "cpu").meta
    assert str(meta["precision"]) == "int8"
    assert 0.0 <= float(meta["int8_saturation"]) < theat.SATURATION_WARN_FRACTION


def test_safa_sweep_matches_jax(scene, states):
    """--family safa, f32 towers (the fixture's VGG weights, a seeded SAFA
    head): no orientation column, dissimilarity within the f32 towers'
    rtol 1e-3 / atol 1e-4 of witw_tpu's, score exp(10 (1 - d)); the cache
    is a VectorIndex stamped "safa" that a warm sweep reuses."""
    from types import SimpleNamespace

    from witw_tpu.configs import safa_experiment as jax_safa_experiment
    from witw_tpu_torch.configs import safa_experiment
    from witw_tpu_torch.evaluation.vector_index import VectorIndex
    from witw_tpu_torch.models.convert_jax import state_dict_to_jax_params

    (_, fov_params), _ = states
    jcfg, tcfg = (make("witw", 70) for make in (jax_safa_experiment, safa_experiment))
    jcfg, tcfg = (c.replace(data=dataclasses.replace(c.data, **GEOMETRY),
                            model=dataclasses.replace(c.model, compute_dtype="float32"))
                  for c in (jcfg, tcfg))
    rng = np.random.default_rng(12)
    params = {}
    for tower, hw in (("surface", 24), ("overhead", 128)):
        sd = {k: v for k, v in fov_params[tower].items() if k.startswith("vgg.")}
        for name, shape in (("fc1", (hw, hw // 2, 8)), ("fc1_bias", (hw // 2, 8)),
                            ("fc2", (hw // 2, hw, 8)), ("fc2_bias", (hw, 8))):
            scale = 0.005 if name in ("fc1", "fc2") else 0.1
            sd[f"safa.{name}"] = torch.from_numpy(
                (scale * rng.standard_normal(shape)).astype(np.float32))
        params[tower] = sd
    state = SimpleNamespace(params=state_dict_to_jax_params(params), batch_stats={})
    cache = str(scene[0] / "safa_cache.npz")
    want, want_csv = _jax_sweep(scene, state, "jsafa", jcfg, family="safa")
    got, got_csv = _port_sweep(scene, params, "tsafa", tcfg, family="safa", index_cache=cache)
    columns = ["x", "y", "dissimilarity", "score"]
    assert list(got) == list(want.columns) == columns
    assert _rows(got_csv)[0] == _rows(want_csv)[0] == columns
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_allclose(got["dissimilarity"], want["dissimilarity"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["score"], np.exp(10 * (1 - got["dissimilarity"])), rtol=1e-6)
    index = VectorIndex.load(cache, "cpu")
    assert index.embeds.shape == (4, 4096) and str(index.meta["family"]) == "safa"
    warm, _ = _port_sweep(scene, params, "tsafa_warm", tcfg, family="safa", index_cache=cache,
                          sat=str(scene[0] / "missing.tif"))  # a cache hit reads no strip
    np.testing.assert_array_equal(warm["dissimilarity"], got["dissimilarity"])


def test_baseline_sweep_matches_jax(scene, monkeypatch):
    """--family baseline, f32 towers (witw_tpu's convs at "highest") from a
    seeded port init with running statistics off 0 / 1: the two photos
    resized to 500 x 500 raw pixels, the tiles resampled to a raw 750²; no
    orientation column (batches of 4 tiles, the grid's), dissimilarity
    within rtol 1e-4, atol 1e-4 of
    witw_tpu's, score exp(-d); the cache is a VectorIndex stamped
    "baseline" that a warm sweep reuses; --int8 calibrates the surface tower
    on the raw photos (its vectors at cosine > 0.99 to the f32 ones)."""
    from types import SimpleNamespace

    from witw_tpu.configs import baseline_experiment as jax_baseline_experiment
    from witw_tpu_torch.configs import baseline_experiment
    from witw_tpu_torch.evaluation.vector_index import VectorIndex
    from witw_tpu_torch.models.convert_jax import state_dict_to_jax_variables
    from witw_tpu_torch.train.pipeline import BaselinePipeline

    jcfg, tcfg = (make("witw") for make in (jax_baseline_experiment, baseline_experiment))
    jcfg, tcfg = (c.replace(model=dataclasses.replace(c.model, compute_dtype="float32",
                                                      conv_precision="highest"))
                  for c in (jcfg, tcfg))
    gen = torch.Generator().manual_seed(6)
    params = BaselinePipeline(tcfg, "cpu").init(gen)
    for sd in params.values():
        for k in sd:
            if k.endswith("running_mean"):
                sd[k] = 0.1 * torch.randn(sd[k].shape, generator=gen)
            elif k.endswith("running_var"):
                sd[k] = torch.rand(sd[k].shape, generator=gen) + 0.5
    jparams, jstats = state_dict_to_jax_variables(params)
    state = SimpleNamespace(params=jparams, batch_stats=jstats)
    photos = scene[2]
    cache = str(scene[0] / "baseline_cache.npz")
    want, want_csv = _jax_sweep(scene, state, "jbase", jcfg, family="baseline", batch_size=4, photos=photos)
    got, got_csv = _port_sweep(scene, params, "tbase", tcfg, family="baseline", batch_size=4,
                               index_cache=cache, photos=photos)
    columns = ["photo", "x", "y", "dissimilarity", "score"]
    assert list(got) == list(want.columns) == columns
    assert _rows(got_csv)[0] == _rows(want_csv)[0] == columns
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_allclose(got["dissimilarity"], want["dissimilarity"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["score"], np.exp(-got["dissimilarity"]), rtol=1e-6)
    index = VectorIndex.load(cache, "cpu")
    assert index.embeds.shape == (4, 1536) and str(index.meta["family"]) == "baseline"
    warm, _ = _port_sweep(scene, params, "tbase_warm", tcfg, family="baseline", batch_size=4, index_cache=cache,
                          photos=photos, sat=str(scene[0] / "missing.tif"))
    np.testing.assert_array_equal(warm["dissimilarity"], got["dissimilarity"])

    calibrated = []
    real_fold = tq.quantize_baseline_tower_static

    def record_fold(sd, batches, *args, **kwargs):
        calibrated.append(tuple(batches[0].shape))
        return real_fold(sd, batches, *args, **kwargs)

    monkeypatch.setattr(tq, "quantize_baseline_tower_static", record_fold)
    seen = {}
    real_score = VectorIndex.score_all

    def record_score(index, query, *args, **kwargs):
        seen.setdefault("s_emb", []).append(np.array(query))
        return real_score(index, query, *args, **kwargs)

    monkeypatch.setattr(VectorIndex, "score_all", record_score)
    _port_sweep(scene, params, "tbase_f32", tcfg, family="baseline", batch_size=4, photos=photos)
    int8, _ = _port_sweep(scene, params, "tbase8", tcfg, family="baseline", batch_size=4, int8=True,
                          photos=photos)
    assert calibrated == [(2, 500, 500, 3), (4, 750, 750, 3)]  # the photos, then the tiles
    f32_q, int8_q = seen["s_emb"]
    cos = np.sum(f32_q * int8_q, 1) / (np.linalg.norm(f32_q, axis=1) * np.linalg.norm(int8_q, axis=1))
    assert np.all(cos > 0.99), cos
    assert np.all(np.isfinite(int8["dissimilarity"]))


@pytest.mark.parametrize("family", ["fov", "safa"])
def test_sharded_sweep_writes_the_same_csv(scene, states, f32_sweeps, family, monkeypatch):
    """sweep(mesh=) on a mesh of 3 CPU entries (4 tiles: shards of 2, 2 and
    none) scores the gallery through score_all_sharded and writes the CSV
    of sweep(): the same columns, x and y, orientations equal, distances
    within rtol 1e-5, atol 1e-6. FOV beside the f32 sweep of the fixture;
    SAFA with the fixture's VGG weights and a seeded head."""
    from witw_tpu_torch.configs import safa_experiment
    from witw_tpu_torch.evaluation.vector_index import VectorIndex
    from witw_tpu_torch.parallel import make_mesh

    (_, params), _ = states
    mesh = make_mesh(devices=["cpu"] * 3)
    calls = []
    for cls in (GalleryIndex, VectorIndex):
        real = cls.score_all_sharded

        def record(index, *args, real=real, **kwargs):
            calls.append(type(index).__name__)
            return real(index, *args, **kwargs)

        monkeypatch.setattr(cls, "score_all_sharded", record)
    if family == "fov":
        _, tcfg = _cfgs("float32")
        want, want_csv = f32_sweeps[2:]
        got, got_csv = _port_sweep(scene, params, "t32_mesh", tcfg, mesh=mesh)
    else:
        tcfg = safa_experiment("witw", 70)
        tcfg = tcfg.replace(data=dataclasses.replace(tcfg.data, **GEOMETRY),
                            model=dataclasses.replace(tcfg.model, compute_dtype="float32"))
        rng = np.random.default_rng(12)
        safa = {}
        for tower, hw in (("surface", 24), ("overhead", 128)):
            sd = {k: v for k, v in params[tower].items() if k.startswith("vgg.")}
            for name, shape in (("fc1", (hw, hw // 2, 8)), ("fc1_bias", (hw // 2, 8)),
                                ("fc2", (hw // 2, hw, 8)), ("fc2_bias", (hw, 8))):
                scale = 0.005 if name in ("fc1", "fc2") else 0.1
                sd[f"safa.{name}"] = torch.from_numpy(
                    (scale * rng.standard_normal(shape)).astype(np.float32))
            safa[tower] = sd
        want, want_csv = _port_sweep(scene, safa, "tsafa_one", tcfg, family="safa")
        got, got_csv = _port_sweep(scene, safa, "tsafa_mesh", tcfg, family="safa", mesh=mesh)
    assert calls == (["GalleryIndex"] if family == "fov" else ["VectorIndex"])
    assert list(got) == list(want) and _rows(got_csv)[0] == _rows(want_csv)[0]
    assert [r[:2] for r in _rows(got_csv)[1:]] == [r[:2] for r in _rows(want_csv)[1:]]
    if family == "fov":
        np.testing.assert_array_equal(got["orientation"], want["orientation"])
    for key in ("dissimilarity", "score"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)

