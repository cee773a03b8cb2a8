"""The port's build_index and serving daemon (witw_tpu_torch.tools) against
witw_tpu's on the CPU, mirroring tests/test_tools.py:551,691 and
tests/test_pipeline_e2e.py's daemon tests at a narrow geometry.

Towers are a flax init moved into the port with ``convert_jax``; photos,
tiles and planted galleries come from numpy ``default_rng`` and the
synthetic dataset writer. Tolerances: bf16 embeddings as
tests/test_torch_models.py:test_bf16_fov_dsm_matches_jax_bf16 (rtol 2e-2,
atol 2e-2 max|y|); int8 embeddings within atol 1e-6 given witw_tpu's
tables and the same input (as tests/test_torch_quantize.py); served tiles
and orientations equal on planted galleries.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from witw_tpu.configs import fov_experiment as jax_fov_experiment
from witw_tpu.data import write_synthetic_dataset
from witw_tpu.evaluation.index import GalleryIndex as JaxIndex
from witw_tpu.models import quantize as jq
from witw_tpu.tools.build_index import build_index as jax_build_index
from witw_tpu.tools.serve import GeolocateService as JaxService
from witw_tpu.train.pipeline import make_pipeline
from witw_tpu.utils.hashing import params_fingerprint as jax_fingerprint
from witw_tpu_torch.configs import fov_experiment
from witw_tpu_torch.data.csv_registry import read_pair_paths
from witw_tpu_torch.evaluation.index import GalleryIndex
from witw_tpu_torch.models import quantize as tq
from witw_tpu_torch.models.convert_jax import jax_params_to_state_dict
from witw_tpu_torch.tools import build_index as tbuild
from witw_tpu_torch.tools.serve import GeolocateService, serve
from witw_tpu_torch.utils.profiling import reset, spans

GEOMETRY = dict(surface_height=64, surface_width_max=128, overhead_size=32)


def _cfgs():
    cfgs = []
    for make in (jax_fov_experiment, fov_experiment):
        cfg = make("witw", 70)
        cfgs.append(cfg.replace(data=dataclasses.replace(cfg.data, **GEOMETRY)))
    return cfgs


@pytest.fixture(scope="module")
def towers():
    """(witw_tpu config and state, port config and params) on the same
    weights; bf16 compute, the configs' default."""
    jcfg, tcfg = _cfgs()
    state = make_pipeline(jcfg).init(jax.random.PRNGKey(0))
    params = jax_params_to_state_dict(jax.tree.map(np.asarray, state.params))
    return jcfg, state, tcfg, params


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("data")), n=5, schema="witw",
                                   surface_hw=(32, 64), overhead_hw=(40, 40))


def _bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))


def test_build_index_matches_jax(towers, dataset, tmp_path):
    """tools/build_index in bf16: the meta (precision, family, weights
    fingerprint, paths, renamed CSV columns) equal, the embeddings at the
    bf16 towers' tolerance, and the saved index loads in witw_tpu."""
    jcfg, state, tcfg, params = towers
    cols = ["overhead_path", "col0:x"]
    want = jax_build_index(dataset, str(tmp_path / "j.npz"), batch_size=2, meta_cols=cols,
                           state=state, cfg=jcfg, verbose=False)
    got = tbuild.build_index(dataset, str(tmp_path / "t.npz"), batch_size=2, meta_cols=cols,
                             state=params, cfg=tcfg, verbose=False, device="cpu")
    assert got.embeds.shape == want.embeds.shape == (5, 2, 16, 16)
    _bf16_close(got.embeds, want.embeds)
    assert sorted(got.meta) == sorted(want.meta)
    for key in ("precision", "family", "params_sha", "path", "overhead_path"):
        np.testing.assert_array_equal(got.meta[key], want.meta[key], err_msg=key)
    np.testing.assert_array_equal(got.meta["x"], want.meta["x"])  # empty column: NaN floats
    assert got.meta["x"].dtype == np.float64 and np.isnan(got.meta["x"]).all()
    assert str(got.meta["params_sha"]) == jax_fingerprint(state.params["overhead"])
    loaded = JaxIndex.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(loaded.embeds, got.embeds)
    with pytest.raises(ValueError, match="not in CSV"):
        tbuild.build_index(dataset, None, batch_size=2, meta_cols=["nope"], state=params, cfg=tcfg,
                           verbose=False, device="cpu")


def test_build_index_mixed_grayscale_gallery_matches_jax(towers, tmp_path):
    """Grayscale tiles, the first of the gallery and one inside a later
    batch, fill every channel of the batch buffer as in witw_tpu's
    build_index; the embeddings agree at the bf16 towers' tolerance."""
    jcfg, state, tcfg, params = towers
    csv_path = write_synthetic_dataset(str(tmp_path), n=5, schema="witw", surface_hw=(32, 64),
                                       overhead_hw=(40, 40), seed=3)
    overhead = [o for _, o in read_pair_paths(tcfg.data.dataset, csv_path)]
    for i in (0, 3):
        with Image.open(overhead[i]) as im:
            im.convert("L").save(overhead[i])
    want = jax_build_index(csv_path, None, batch_size=2, state=state, cfg=jcfg, verbose=False)
    got = tbuild.build_index(csv_path, None, batch_size=2, state=params, cfg=tcfg,
                             verbose=False, device="cpu")
    assert got.embeds.shape == want.embeds.shape == (5, 2, 16, 16)
    _bf16_close(got.embeds, want.embeds)


def test_build_index_headerless_integer_meta_cols(towers, tmp_path):
    """test_tools.py:691: headerless (CVUSA) CSVs address extra columns by
    position; a name fails with the positional hint."""
    _, _, tcfg, params = towers
    csv_path = write_synthetic_dataset(str(tmp_path), n=4, schema="cvusa", surface_hw=(32, 64),
                                       overhead_hw=(32, 32))
    with open(csv_path) as f:
        lines = f.read().splitlines()
    with open(csv_path, "w") as f:
        f.writelines(f"{line},{100.0 + i},tile{i}\n" for i, line in enumerate(lines))
    cfg = tcfg.replace(data=dataclasses.replace(
        tcfg.data, dataset=fov_experiment("cvusa", 70).data.dataset))
    index = tbuild.build_index(csv_path, None, batch_size=3, meta_cols=["2:x", "3"], state=params,
                               cfg=cfg, verbose=False, device="cpu")
    np.testing.assert_allclose(index.meta["x"], 100.0 + np.arange(4))
    np.testing.assert_array_equal(index.meta["3"], [f"tile{i}" for i in range(4)])
    with pytest.raises(ValueError, match="integer positions"):
        tbuild.build_index(csv_path, None, batch_size=3, meta_cols=["lon:x"], state=params,
                           cfg=cfg, verbose=False, device="cpu")


def test_build_index_int8_matches_jax_given_its_tables(towers, dataset, tmp_path, monkeypatch):
    """--int8: with witw_tpu's calibrated scales the port folds equal
    tables, and on the inputs it builds its tower gives witw_tpu's static
    forward (within atol 1e-6); the gallery-spanning calibration samples
    the same tiles."""
    jcfg, state, tcfg, params = towers
    seen = {}
    real_span = jq.calibrate_overhead_span
    real_scales = jq.calibrate_fov_activation_scales

    def record_scales(*args, **kwargs):
        seen["scales"] = real_scales(*args, **kwargs)
        return seen["scales"]

    def record_span(*args, **kwargs):
        seen["sq"], items = real_span(*args, **kwargs)
        seen["items"] = sorted(items)
        return seen["sq"], items

    monkeypatch.setattr(jq, "calibrate_fov_activation_scales", record_scales)
    monkeypatch.setattr(jq, "calibrate_overhead_span", record_span)
    want = jax_build_index(dataset, None, batch_size=2, int8=True, state=state, cfg=jcfg,
                           verbose=False)

    inputs = []
    real_forward = tq.quantized_fov_forward_static
    real_tspan = tq.calibrate_overhead_span

    def record_forward(sq, x, *args, **kwargs):
        out = real_forward(sq, x, *args, **kwargs)
        if kwargs.get("saturation_out") is None:
            inputs.append((x.numpy().copy(), out.numpy()))
        return out

    def record_tspan(*args, **kwargs):
        sq, items = real_tspan(*args, **kwargs)
        seen["port_items"] = sorted(items)
        seen["port_sq"] = sq
        return sq, items

    monkeypatch.setattr(tq, "calibrate_fov_activation_scales", lambda *a, **k: seen["scales"])
    monkeypatch.setattr(tq, "quantized_fov_forward_static", record_forward)
    monkeypatch.setattr(tq, "calibrate_overhead_span", record_tspan)
    got = tbuild.build_index(dataset, None, batch_size=2, int8=True, state=params, cfg=tcfg,
                             verbose=False, device="cpu")

    assert seen["port_items"] == seen["items"] == [0, 4]  # linspace(0, 4, 2)
    for name in ("conv_0", "conv_10", "conv_21"):
        for key in ("kernel_q", "bias_q", "requant_m", "dequant"):
            np.testing.assert_array_equal(seen["port_sq"]["vgg"][name][key].numpy(),
                                          np.asarray(seen["sq"]["vgg"][name][key]))
    forward = jax.jit(lambda sq, x: jq.quantized_fov_forward_static(sq, x, True))
    for x, out in inputs:
        np.testing.assert_allclose(out, np.asarray(forward(seen["sq"], jnp.asarray(x))),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.embeds, np.concatenate([o for _, o in inputs])[:5])
    assert str(got.meta["precision"]) == "int8"
    assert 0.0 <= float(got.meta["int8_saturation"]) < 0.05
    # the inputs differ from witw_tpu's by f32 roundoff of the polar
    # transform, so the whole build is compared at the int8 step's size
    np.testing.assert_allclose(got.embeds, want.embeds, rtol=0,
                               atol=0.05 * float(np.abs(want.embeds).max()))


def _photo(rng, hw=(70, 90)):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, hw + (3,), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _planted_index(service, photo, rng, n=12, w=16, noise=(0.02, 0.1, 0.2, 0.3, 0.4)):
    """A gallery where tiles 2, 4, 6, 8, 10 hold the photo's embedding (as
    ``service`` embeds it) at column offsets 1, 4, 7, 10, 13 with rising
    noise, and the others noise: the exact top-5 is those tiles in that
    order, each with a clear orientation."""
    emb = service._embed(service._decode(photo)[None])[0]  # [h, sw, c]
    h, sw, c = emb.shape
    gal = rng.standard_normal((n, h, w, c)).astype(np.float32) * float(np.abs(emb).mean())
    for j, eps in enumerate(noise):
        tile, start = 2 + 2 * j, 1 + 3 * j
        cols = [(start + k) % w for k in range(sw)]
        gal[tile][:, cols] = emb + eps * float(np.abs(emb).mean()) * rng.standard_normal(emb.shape)
    return gal


def test_geolocate_matches_jax_on_planted_data(towers, rng):
    jcfg, state, tcfg, params = towers
    photo = _photo(rng)
    probe = GeolocateService(GalleryIndex(np.zeros((1, 2, 16, 16), np.float32), device="cpu"),
                             tcfg, params)
    gal = _planted_index(probe, photo, rng)
    meta = {"x": np.arange(12.0) * 10, "y": np.arange(12.0) * -5}
    port = GeolocateService(GalleryIndex(gal, meta=meta, device="cpu"), tcfg, params)
    ref = JaxService(JaxIndex(gal, meta=meta), jcfg, state)
    want = ref.geolocate(photo, k=5)
    got = port.geolocate(photo, k=5)
    assert [r["tile"] for r in got] == [r["tile"] for r in want] == [2, 4, 6, 8, 10]
    assert [r["orientation_deg"] for r in got] == [r["orientation_deg"] for r in want]
    assert [r["x"] for r in got] == [20.0, 40.0, 60.0, 80.0, 100.0]
    np.testing.assert_allclose([r["distance"] for r in got], [r["distance"] for r in want],
                               rtol=5e-2, atol=5e-3)  # bf16 towers: embeddings within 2%
    for r in got:
        assert r["score"] == pytest.approx(np.exp(10.0 * (1.0 - r["distance"])), rel=1e-6)
    approx = port.geolocate(photo, k=3, candidates=6)
    assert [r["tile"] for r in approx] == [2, 4, 6]
    assert port.stats == {"requests": 2, "dispatches": 2, "errors": 0, "exact_searches": 1,
                          "approx_searches": 1}
    # Under a profiler: the decode, and one dispatch whose spans share its root.
    reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        port.geolocate(photo, k=5)
    records = spans()
    assert [(r.name, r.parent, r.root) for r in records] == [
        ("serve.decode", None, 0), ("serve.dispatch", None, 1), ("serve.embed", 1, 1),
        ("serve.search", 1, 1)]


def test_serving_refuses_mismatched_index(towers, rng):
    """test_pipeline_e2e.py:666, with witw_tpu's fingerprint: an index
    stamped by witw_tpu passes the port's check of the same weights."""
    _, state, tcfg, params = towers
    embeds = rng.standard_normal((4, 2, 16, 16)).astype(np.float32)
    sha = jax_fingerprint(state.params["overhead"])

    def index(**meta):
        return GalleryIndex(embeds, meta=meta, device="cpu")

    with pytest.raises(ValueError, match="precision"):
        GeolocateService(index(precision="int8", params_sha=sha), tcfg, params, int8=False)
    with pytest.raises(ValueError, match="precision"):
        GeolocateService(index(precision="f32", params_sha=sha), tcfg, params, int8=True)
    with pytest.raises(ValueError, match="checkpoint"):
        GeolocateService(index(precision="f32", params_sha="0" * 64), tcfg, params)
    GeolocateService(index(precision="f32", params_sha=sha), tcfg, params).close()
    GeolocateService(index(), tcfg, params).close()
    GeolocateService(index(precision="f32", params_sha="0" * 64), tcfg, params,
                     allow_mismatch=True).close()


def test_warmup_restores_stats_and_int8_calibrates_on_the_first_photo(towers, rng):
    """test_pipeline_e2e.py:738 (max_batch 3 pads to 4), and --int8's lazy
    calibration: not on the warm-up, on the first real photo."""
    _, _, tcfg, params = towers
    embeds = rng.standard_normal((8, 2, 16, 16)).astype(np.float32)
    for int8 in (False, True):
        service = GeolocateService(GalleryIndex(embeds, device="cpu"), tcfg, params, int8=int8,
                                   max_batch=3)
        try:
            service.warmup(ks=(2,))
            assert service.stats["requests"] == service.stats["dispatches"] == 0
            assert service._sq is None
            photo = _photo(rng)
            first = service.geolocate(photo, k=2)
            assert len(first) == 2 and service.stats["requests"] == 1
            assert (service._sq is not None) == int8
            assert service.geolocate(photo, k=2) == first
        finally:
            service.close()
            assert service._workers == []
            service.close()


def test_http_round_trip_with_batching(towers, rng):
    """One server on port 0 with max_batch 4: a burst of concurrent requests
    is answered as the unbatched service answers each, /healthz and /stats
    report, and bad requests get 400 / 404. f32 towers, so that the batch of
    4 and the batches of 1 differ only by f32 reduction order (rtol 1e-4,
    atol 1e-5, as test_pipeline_e2e.py's micro-batching test); in bf16 the
    CPU convs round differently per batch layout."""
    _, _, tcfg, params = towers
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, compute_dtype="float32"))
    embeds = rng.standard_normal((12, 2, 16, 16)).astype(np.float32)
    plain = GeolocateService(GalleryIndex(embeds, device="cpu"), tcfg, params)
    batched = GeolocateService(GalleryIndex(embeds, device="cpu"), tcfg, params, max_batch=4,
                               batch_window_ms=2000.0)
    server = serve(batched, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    try:
        photos = [_photo(rng) for _ in range(4)]
        queries = ["k=3", "k=1", "k=5", "k=2&candidates=8"]
        want = [plain.geolocate(p, k=int(q.split("&")[0][2:]),
                                candidates=8 if "candidates" in q else 0)
                for p, q in zip(photos, queries)]
        got = [None] * 4

        def post(i):
            req = urllib.request.Request(f"{url}/geolocate?{queries[i]}", data=photos[i],
                                         method="POST")
            with urllib.request.urlopen(req) as r:
                got[i] = json.loads(r.read())["results"]

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for g, w in zip(got, want):
            assert [r["tile"] for r in g] == [r["tile"] for r in w]
            assert [r["orientation_deg"] for r in g] == [r["orientation_deg"] for r in w]
            np.testing.assert_allclose([r["distance"] for r in g], [r["distance"] for r in w],
                                       rtol=1e-4, atol=1e-5)
        with urllib.request.urlopen(f"{url}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["gallery_size"] == 12 and health["max_batch"] == 4
        with urllib.request.urlopen(f"{url}/stats") as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 4 and stats["dispatches"] <= 2
        assert stats["exact_searches"] == 3 and stats["approx_searches"] == 1
        assert stats["mean_batch"] >= 2.0
        for path, body, code in (("/geolocate", b"not an image", 400),
                                 ("/geolocate?k=0", photos[0], 400),
                                 ("/geolocate?candidates=-1", photos[0], 400),
                                 ("/nowhere", photos[0], 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(urllib.request.Request(url + path, data=body, method="POST"))
            assert err.value.code == code
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{url}/nowhere")
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        batched.close()
        plain.close()


# --- the SAFA family: build_index --family safa and the daemon on a VectorIndex


@pytest.fixture(scope="module")
def safa_towers(towers):
    """SAFA towers on the FOV fixture's VGG weights and seeded head arrays
    (surface h·w 8 x 3 at the 64 x 24 photo crop, overhead 8 x 16): (witw_tpu
    config and a state with those params, port config and params)."""
    from types import SimpleNamespace

    from witw_tpu.configs import safa_experiment as jax_safa_experiment
    from witw_tpu_torch.configs import safa_experiment
    from witw_tpu_torch.models.convert_jax import state_dict_to_jax_params

    _, _, _, fov_params = towers
    cfgs = []
    for make in (jax_safa_experiment, safa_experiment):
        cfg = make("witw", 70)
        cfgs.append(cfg.replace(data=dataclasses.replace(cfg.data, **GEOMETRY)))
    rng = np.random.default_rng(11)
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
    return cfgs[0], state, cfgs[1], params


def test_build_index_safa_matches_jax(safa_towers, dataset, tmp_path):
    """--family safa in bf16: a VectorIndex of [5, 4096] unit vectors at the
    bf16 towers' tolerance, meta equal (family "safa"), and witw_tpu's
    VectorIndex loads the saved file."""
    from witw_tpu.evaluation.vector_index import VectorIndex as JaxVectorIndex
    from witw_tpu_torch.evaluation.vector_index import VectorIndex

    jcfg, state, tcfg, params = safa_towers
    want = jax_build_index(dataset, None, batch_size=2, state=state, cfg=jcfg, verbose=False,
                           family="safa")
    got = tbuild.build_index(dataset, str(tmp_path / "t.npz"), batch_size=2, state=params,
                             cfg=tcfg, verbose=False, device="cpu", family="safa")
    assert isinstance(got, VectorIndex)
    assert got.embeds.shape == want.embeds.shape == (5, 4096)
    _bf16_close(got.embeds, want.embeds)
    assert sorted(got.meta) == sorted(want.meta)
    for key in ("precision", "family", "params_sha", "path"):
        np.testing.assert_array_equal(got.meta[key], want.meta[key], err_msg=key)
    assert str(got.meta["family"]) == "safa"
    np.testing.assert_array_equal(JaxVectorIndex.load(str(tmp_path / "t.npz")).embeds, got.embeds)
    with pytest.raises(ValueError, match="does not fit"):
        tbuild.build_index(dataset, None, state=params, cfg=tcfg, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tbuild.build_index(dataset, None, state=params, cfg=tcfg, verbose=False, device="cpu",
                           family="baseline")


def test_build_index_safa_int8_matches_jax_given_its_tables(safa_towers, dataset, monkeypatch):
    """--family safa --int8: with witw_tpu's calibrated trunk scales the
    port's SAFA int8 tower gives witw_tpu's static forward on the inputs it
    builds (within atol 1e-6); the calibration samples the same tiles."""
    jcfg, state, tcfg, params = safa_towers
    seen = {}
    real_scales = jq.calibrate_fov_activation_scales
    real_span = jq.calibrate_overhead_span

    def record_scales(*args, **kwargs):
        seen["scales"] = real_scales(*args, **kwargs)
        return seen["scales"]

    def record_span(*args, **kwargs):
        seen["sq"], items = real_span(*args, **kwargs)
        seen["items"] = sorted(items)
        return seen["sq"], items

    monkeypatch.setattr(jq, "calibrate_fov_activation_scales", record_scales)
    monkeypatch.setattr(jq, "calibrate_overhead_span", record_span)
    want = jax_build_index(dataset, None, batch_size=2, int8=True, state=state, cfg=jcfg,
                           verbose=False, family="safa")

    inputs = []
    real_forward = tq.quantized_safa_forward_static
    real_tspan = tq.calibrate_overhead_span

    def record_forward(sq, head, x, *args, **kwargs):
        out = real_forward(sq, head, x, *args, **kwargs)
        if kwargs.get("saturation_out") is None:
            inputs.append((x.numpy().copy(), out.numpy()))
        return out

    def record_tspan(*args, **kwargs):
        sq, items = real_tspan(*args, **kwargs)
        seen["port_items"] = sorted(items)
        return sq, items

    monkeypatch.setattr(tq, "calibrate_fov_activation_scales", lambda *a, **k: seen["scales"])
    monkeypatch.setattr(tq, "quantized_safa_forward_static", record_forward)
    monkeypatch.setattr(tq, "calibrate_overhead_span", record_tspan)
    got = tbuild.build_index(dataset, None, batch_size=2, int8=True, state=params, cfg=tcfg,
                             verbose=False, device="cpu", family="safa")

    assert seen["port_items"] == seen["items"] == [0, 4]
    assert set(seen["scales"]) == {"input"} | set(tq.TRUNK_ORDER)
    forward = jax.jit(lambda sq, head, x: jq.quantized_safa_forward_static(sq, head, x, True))
    for x, out in inputs:
        np.testing.assert_allclose(out, np.asarray(forward(*seen["sq"], jnp.asarray(x))),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.embeds, np.concatenate([o for _, o in inputs])[:5])
    assert str(got.meta["precision"]) == "int8" and str(got.meta["family"]) == "safa"
    assert 0.0 <= float(got.meta["int8_saturation"]) < 0.05
    np.testing.assert_allclose(got.embeds, want.embeds, rtol=0,
                               atol=0.05 * float(np.abs(want.embeds).max()))


def _planted_vectors(service, photo, rng, n=12, noise=(0.02, 0.1, 0.2, 0.3, 0.4)):
    """Unit vectors where tiles 2, 4, 6, 8, 10 are the photo's embedding (as
    ``service`` embeds it) under rising noise and the others are noise: the
    exact top-5 is those tiles in that order."""
    emb = service._embed(service._decode(photo)[None])[0]
    gal = rng.standard_normal((n, emb.size)).astype(np.float32)
    for j, eps in enumerate(noise):
        gal[2 + 2 * j] = emb / np.linalg.norm(emb) * np.sqrt(emb.size) + eps * gal[2 + 2 * j]
    return (gal / np.linalg.norm(gal, axis=1, keepdims=True)).astype(np.float32)


def test_geolocate_safa_matches_jax_on_planted_data(safa_towers, rng):
    """GeolocateService(family="safa") against witw_tpu's on a planted
    VectorIndex: the same tiles, no orientation, the distances at the bf16
    towers' tolerance, score exp(10 (1 - d)); a candidates request is
    searched exactly."""
    from witw_tpu.evaluation.vector_index import VectorIndex as JaxVectorIndex
    from witw_tpu_torch.evaluation.vector_index import VectorIndex

    jcfg, state, tcfg, params = safa_towers
    photo = _photo(rng)
    probe = GeolocateService(VectorIndex(np.zeros((1, 4096), np.float32), device="cpu"), tcfg,
                             params, family="safa")
    gal = _planted_vectors(probe, photo, rng)
    meta = {"x": np.arange(12.0) * 10, "y": np.arange(12.0) * -5, "family": "safa"}
    port = GeolocateService(VectorIndex(gal, meta=meta, device="cpu"), tcfg, params,
                            family="safa")
    ref = JaxService(JaxVectorIndex(gal, meta=meta), jcfg, state, family="safa")
    want = ref.geolocate(photo, k=5)
    got = port.geolocate(photo, k=5)
    assert [r["tile"] for r in got] == [r["tile"] for r in want] == [2, 4, 6, 8, 10]
    assert [r["orientation_deg"] for r in got] == [None] * 5
    assert [r["x"] for r in got] == [20.0, 40.0, 60.0, 80.0, 100.0]
    np.testing.assert_allclose([r["distance"] for r in got], [r["distance"] for r in want],
                               rtol=5e-2, atol=5e-3)
    for r in got:
        assert r["score"] == pytest.approx(np.exp(10.0 * (1.0 - r["distance"])), rel=1e-6)
    exact = port.geolocate(photo, k=3, candidates=6)
    assert [r["tile"] for r in exact] == [2, 4, 6]
    assert port.stats == {"requests": 2, "dispatches": 2, "errors": 0, "exact_searches": 2,
                          "approx_searches": 0}


def test_safa_serving_checks_family_and_calibrates_int8_on_the_first_photo(safa_towers, towers,
                                                                            rng):
    """The family must fit the index type, the config and the index's
    recorded family; --fast-eval warns and runs exact; --int8 calibrates the
    SAFA trunk on the first real photo, not on the warm-up."""
    from witw_tpu_torch.evaluation.vector_index import VectorIndex

    _, _, tcfg, params = safa_towers
    _, _, fov_cfg, fov_params = towers
    vectors = rng.standard_normal((8, 4096)).astype(np.float32)
    maps = rng.standard_normal((4, 2, 16, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="needs a VectorIndex"):
        GeolocateService(GalleryIndex(maps, device="cpu"), tcfg, params, family="safa")
    with pytest.raises(ValueError, match="needs a GalleryIndex"):
        GeolocateService(VectorIndex(vectors, device="cpu"), fov_cfg, fov_params)
    with pytest.raises(ValueError, match="does not fit"):
        GeolocateService(VectorIndex(vectors, device="cpu"), fov_cfg, fov_params, family="safa")
    with pytest.raises(ValueError, match="--family safa"):
        GeolocateService(VectorIndex(vectors, {"family": "fov"}, device="cpu"), tcfg, params,
                         family="safa")
    with pytest.warns(UserWarning, match="no effect"):
        GeolocateService(VectorIndex(vectors, device="cpu"), tcfg, params, fast=True,
                         family="safa").close()
    service = GeolocateService(VectorIndex(vectors, device="cpu"), tcfg, params, int8=True,
                               max_batch=2, family="safa")
    try:
        service.warmup(ks=(2,))
        assert service._sq is None and service.stats["requests"] == 0
        first = service.geolocate(_photo(rng), k=2)
        assert len(first) == 2 and first[0]["orientation_deg"] is None
        sq, head = service._sq
        assert set(sq["vgg"]) == set(tq.TRUNK_ORDER) and set(head) == {
            "fc1", "fc1_bias", "fc2", "fc2_bias"}
    finally:
        service.close()


# --- the baseline family: build_index --family baseline and the daemon --------


@pytest.fixture(scope="module")
def baseline_towers():
    """The baseline preset's towers in f32 (witw_tpu's convs at "highest")
    from a seeded port init with running statistics off 0 / 1: (witw_tpu
    config and a state with those params and batch_stats, port config and
    params)."""
    from types import SimpleNamespace

    from witw_tpu.configs import baseline_experiment as jax_baseline_experiment
    from witw_tpu_torch.configs import baseline_experiment
    from witw_tpu_torch.models.convert_jax import state_dict_to_jax_variables
    from witw_tpu_torch.train.pipeline import BaselinePipeline

    cfgs = []
    for make in (jax_baseline_experiment, baseline_experiment):
        cfg = make("witw")
        cfgs.append(cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                                          conv_precision="highest")))
    gen = torch.Generator().manual_seed(4)
    params = BaselinePipeline(cfgs[1], "cpu").init(gen)
    for sd in params.values():
        for k in sd:
            if k.endswith("running_mean"):
                sd[k] = 0.1 * torch.randn(sd[k].shape, generator=gen)
            elif k.endswith("running_var"):
                sd[k] = torch.rand(sd[k].shape, generator=gen) + 0.5
    jparams, jstats = state_dict_to_jax_variables(params)
    return cfgs[0], SimpleNamespace(params=jparams, batch_stats=jstats), cfgs[1], params


def test_build_index_baseline_matches_jax(baseline_towers, dataset, tmp_path, monkeypatch):
    """--family baseline: raw 750² tiles (no normalization, no polar), a
    VectorIndex [5, 1536] within rtol 1e-4, atol 1e-4 of witw_tpu's f32
    build (its own test's tolerance), meta equal (family "baseline", the
    fingerprint of the overhead params alone), witw_tpu's VectorIndex loads
    the file. With --int8 the port calibrates on the same sampled tiles as
    witw_tpu (0 and 4): its scales within rtol 1e-3 of witw_tpu's
    calibrate_baseline_scales on them, and given those scales witw_tpu's
    tables; the int8 vectors hold witw_tpu's contract against the f32 ones
    (cosine > 0.99, pseudo-norm within rtol 0.05). witw_tpu's own int8 build
    is not run: XLA:CPU's int8 convs take 20 s per 750² pair, and the
    forward's parity is tests/test_torch_quantize.py's."""
    from witw_tpu.evaluation.vector_index import VectorIndex as JaxVectorIndex
    from witw_tpu_torch.evaluation.vector_index import VectorIndex

    jcfg, state, tcfg, params = baseline_towers
    want = jax_build_index(dataset, None, batch_size=2, state=state, cfg=jcfg, verbose=False,
                           family="baseline")
    got = tbuild.build_index(dataset, str(tmp_path / "t.npz"), batch_size=2, state=params,
                             cfg=tcfg, verbose=False, device="cpu", family="baseline")
    assert isinstance(got, VectorIndex)
    assert got.embeds.shape == want.embeds.shape == (5, 1536)
    np.testing.assert_allclose(got.embeds, want.embeds, rtol=1e-4, atol=1e-4)
    assert sorted(got.meta) == sorted(want.meta)
    for key in ("precision", "family", "params_sha", "path"):
        np.testing.assert_array_equal(got.meta[key], want.meta[key], err_msg=key)
    assert str(got.meta["family"]) == "baseline"
    np.testing.assert_array_equal(JaxVectorIndex.load(str(tmp_path / "t.npz")).embeds, got.embeds)

    seen = {}
    real_scales, real_span = tq.calibrate_baseline_scales, tq.calibrate_overhead_span

    def record_scales(sd, batches, *args, **kwargs):
        seen["port"] = real_scales(sd, batches, *args, **kwargs)
        seen["jax"] = jq.calibrate_baseline_scales(
            state.params["overhead"], state.batch_stats["overhead"],
            [b.numpy() for b in batches])
        return seen["jax"]

    def record_span(*args, **kwargs):
        seen["sq"], items = real_span(*args, **kwargs)
        seen["items"] = sorted(items)
        return seen["sq"], items

    monkeypatch.setattr(tq, "calibrate_baseline_scales", record_scales)
    monkeypatch.setattr(tq, "calibrate_overhead_span", record_span)
    got8 = tbuild.build_index(dataset, None, batch_size=2, int8=True, state=params, cfg=tcfg,
                              verbose=False, device="cpu", family="baseline")
    assert seen["items"] == [0, 4]
    for k, v in seen["jax"].items():
        np.testing.assert_allclose(seen["port"][k], v, rtol=1e-3, err_msg=str(k))
    monkeypatch.setattr(jq, "calibrate_baseline_scales", lambda *a, **k: seen["jax"])
    tables = jq.quantize_baseline_tower_static(
        {"params": state.params["overhead"], "batch_stats": state.batch_stats["overhead"]}, [])
    for entry, entry_j in zip(seen["sq"]["layers"], tables["layers"]):
        for key, value in entry_j.items():
            np.testing.assert_array_equal(entry[key].numpy(), np.asarray(value), err_msg=key)
    assert str(got8.meta["precision"]) == "int8" and str(got8.meta["family"]) == "baseline"
    assert 0.0 <= float(got8.meta["int8_saturation"]) < 0.01
    cos = np.sum(got8.embeds * got.embeds, 1) / (np.linalg.norm(got8.embeds, axis=1)
                                                 * np.linalg.norm(got.embeds, axis=1))
    assert np.all(cos > 0.99), cos
    np.testing.assert_allclose(np.linalg.norm(got8.embeds, axis=1),
                               np.linalg.norm(got.embeds, axis=1), rtol=0.05)


def test_geolocate_baseline_matches_jax_on_planted_data(baseline_towers, rng):
    """GeolocateService(family="baseline") against witw_tpu's on a planted
    VectorIndex of non-unit vectors, WITW photos decoded to 500 x 500 raw
    pixels: the same tiles, no orientation, distances within rtol 1e-4,
    atol 1e-4 (f32 towers), score exp(-d)."""
    from witw_tpu.evaluation.vector_index import VectorIndex as JaxVectorIndex
    from witw_tpu_torch.evaluation.vector_index import VectorIndex

    jcfg, state, tcfg, params = baseline_towers
    photo = _photo(rng)
    probe = GeolocateService(VectorIndex(np.zeros((1, 1536), np.float32), device="cpu"), tcfg,
                             params, family="baseline")
    assert probe._decode(photo).shape == (500, 500, 3)
    emb = probe._embed(probe._decode(photo)[None])[0]
    scale = float(np.linalg.norm(emb))
    gal = (rng.standard_normal((12, 1536)) * scale / np.sqrt(1536)).astype(np.float32)
    for j, eps in enumerate((0.02, 0.1, 0.2, 0.3, 0.4)):
        gal[2 + 2 * j] = emb + eps * gal[2 + 2 * j]
    meta = {"x": np.arange(12.0) * 10, "y": np.arange(12.0) * -5, "family": "baseline"}
    port = GeolocateService(VectorIndex(gal, meta=meta, device="cpu"), tcfg, params,
                            family="baseline")
    ref = JaxService(JaxVectorIndex(gal, meta=meta), jcfg, state, family="baseline")
    want = ref.geolocate(photo, k=5)
    got = port.geolocate(photo, k=5)
    assert [r["tile"] for r in got] == [r["tile"] for r in want] == [2, 4, 6, 8, 10]
    assert [r["orientation_deg"] for r in got] == [None] * 5
    np.testing.assert_allclose([r["distance"] for r in got], [r["distance"] for r in want],
                               rtol=1e-4, atol=1e-4)
    for r, w in zip(got, want):
        assert r["score"] == pytest.approx(np.exp(-r["distance"]), rel=1e-6)
        assert r["score"] == pytest.approx(w["score"], rel=1e-3)


def test_baseline_serving_checks_family_and_calibrates_int8_on_the_first_photo(
        baseline_towers, safa_towers, rng, monkeypatch):
    """The baseline family must fit its config and the index's recorded
    family; on CVUSA the daemon repeats the photo's rows on the device and
    calibrates the int8 towers on the row-repeated photo (witw_tpu calibrates
    on the raw one, which leaves conv6 a single row at 224 rows: the port
    follows witw_tpu's sweep), not on the warm-up's zeros."""
    from witw_tpu_torch.configs import baseline_experiment
    from witw_tpu_torch.evaluation.vector_index import VectorIndex
    from witw_tpu_torch.tools import serve as tserve

    _, _, tcfg, params = baseline_towers
    _, _, safa_cfg, safa_params = safa_towers
    vectors = rng.standard_normal((8, 1536)).astype(np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        GeolocateService(VectorIndex(vectors, device="cpu"), safa_cfg, safa_params,
                         family="baseline")
    with pytest.raises(ValueError, match="--family baseline"):
        GeolocateService(VectorIndex(vectors, {"family": "safa"}, device="cpu"), tcfg, params,
                         family="baseline")
    with pytest.raises(ValueError, match="--family safa"):
        GeolocateService(VectorIndex(rng.standard_normal((8, 4096)).astype(np.float32),
                                     {"family": "baseline"}, device="cpu"),
                         safa_cfg, safa_params, family="safa")
    # CVUSA at a cut geometry: 192 x 384 photos, rows repeated to 384 x 384
    monkeypatch.setattr(tserve, "host_geometry", lambda cfg: ((192, 384), (750, 750)))
    cvusa = baseline_experiment("cvusa").replace(model=tcfg.model)
    calibrated = []
    real_fold = tq.quantize_baseline_tower_static

    def record_fold(sd, batches, *args, **kwargs):
        calibrated.extend(tuple(b.shape) for b in batches)
        return real_fold(sd, batches, *args, **kwargs)

    monkeypatch.setattr(tq, "quantize_baseline_tower_static", record_fold)
    service = GeolocateService(VectorIndex(vectors, device="cpu"), cvusa, params, int8=True,
                               max_batch=2, family="baseline")
    try:
        service.warmup(ks=(2,))
        assert service._sq is None and service.stats["requests"] == 0
        first = service.geolocate(_photo(rng), k=2)
        assert len(first) == 2 and first[0]["orientation_deg"] is None
        assert calibrated == [(1, 384, 384, 3)] and len(service._sq["layers"]) == 7
        assert first[0]["score"] == pytest.approx(np.exp(-first[0]["distance"]), rel=1e-6)
    finally:
        service.close()


# --- the sharded daemon (GeolocateService(mesh=)) ------------------------------


VECTOR_NOISE = (0.2, 0.3, 0.4, 0.5, 0.6)


def _planted_for(family, service, photo, rng):
    """The family's planted gallery. The vector families' planted rows sit
    at least 0.2 noise away: a distance near 0 from the expansion q² + g² −
    2 q·g keeps only ~eps |q|² / d² of relative precision, so two GEMMs
    blocked differently (a shard's and the whole gallery's) would disagree
    there by more than the f32 tolerance without either being wrong."""
    if family == "fov":
        return _planted_index(service, photo, rng)
    if family == "safa":
        return _planted_vectors(service, photo, rng, noise=VECTOR_NOISE)
    emb = service._embed(service._decode(photo)[None])[0]  # baseline: non-unit vectors
    gal = (rng.standard_normal((12, emb.size)) * float(np.linalg.norm(emb)) / np.sqrt(emb.size))
    for j, eps in enumerate(VECTOR_NOISE):
        gal[2 + 2 * j] = emb + eps * gal[2 + 2 * j]
    return gal.astype(np.float32)


@pytest.mark.parametrize("family", ["fov", "safa", "baseline"])
def test_sharded_service_answers_as_the_unsharded(family, request, rng):
    """test_pipeline_e2e.py:616 and :705 in each family: a service on a mesh
    of 3 CPU entries places the gallery in 3 shards and answers exact
    requests as the unsharded service does (tiles and orientations equal,
    distances within rtol 1e-5, atol 1e-6); /healthz's sharded_devices is
    the mesh's size (1 for a one-entry mesh, which counts as none); k is
    clamped to the placed width on the sharded path, while an FOV request
    with candidates keeps its k on the one-device two-stage search."""
    from witw_tpu_torch.evaluation.vector_index import VectorIndex
    from witw_tpu_torch.parallel import make_mesh

    fixture = {"fov": "towers", "safa": "safa_towers", "baseline": "baseline_towers"}[family]
    _, _, tcfg, params = request.getfixturevalue(fixture)
    index_cls = GalleryIndex if family == "fov" else VectorIndex
    photo = _photo(rng)
    probe_embeds = (np.zeros((1, 2, 16, 16), np.float32) if family == "fov"
                    else np.zeros((1, 4096 if family == "safa" else 1536), np.float32))
    probe = GeolocateService(index_cls(probe_embeds, device="cpu"), tcfg, params, family=family)
    gal = _planted_for(family, probe, photo, rng)
    meta = {"x": np.arange(12.0) * 10, "y": np.arange(12.0) * -5}
    plain = GeolocateService(index_cls(gal, meta=meta, device="cpu"), tcfg, params,
                             family=family)
    mesh = make_mesh(devices=["cpu"] * 3)
    sharded = GeolocateService(index_cls(gal, meta=meta, device="cpu"), tcfg, params,
                               family=family, mesh=mesh)
    assert sharded.health()["sharded_devices"] == 3 and plain.health()["sharded_devices"] == 1
    assert [p["valid"] for p in sharded.index.last_gallery_placement] == [4, 4, 4]
    want = plain.geolocate(photo, k=5)
    got = sharded.geolocate(photo, k=5)
    assert [r["tile"] for r in got] == [r["tile"] for r in want] == [2, 4, 6, 8, 10]
    assert [r["orientation_deg"] for r in got] == [r["orientation_deg"] for r in want]
    np.testing.assert_allclose([r["distance"] for r in got], [r["distance"] for r in want],
                               rtol=1e-5, atol=1e-6)
    assert [r["x"] for r in got] == [r["x"] for r in want]
    sharded.index._sharded["max_k"] = 2  # a narrow placed width makes the clamp visible
    assert [r["tile"] for r in sharded.geolocate(photo, k=6)] == [2, 4]
    approx = sharded.geolocate(photo, k=6, candidates=8)
    assert len(approx) == (6 if family == "fov" else 2)  # the vector families search exactly
    assert sharded.stats["exact_searches"] == (2 if family == "fov" else 3)
    one = GeolocateService(index_cls(gal, device="cpu"), tcfg, params, family=family,
                           mesh=make_mesh(devices=["cpu"]))
    assert one._mesh is None and one.health()["sharded_devices"] == 1
    assert one.index.last_gallery_placement is None
