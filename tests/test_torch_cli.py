"""The port's training-side host pieces and CLIs against witw_tpu's on the
CPU: PairLoader, split_train_val, SyntheticPairs, MetricWriter,
device_prefetch, dump_val_embeddings with the two paired_chord_distance
forms, FovGalleryEvaluator(fast_matmul=), the CLI parser and overrides,
and cvig_fov's train and test modes (tests/test_cli.py:33) with run_test's
ranks equal to witw_tpu's on the same checkpoint.

Data come from write_synthetic_dataset and numpy ``default_rng``; towers
from a flax init moved into the port with ``convert_jax``. Tolerances:
batches equal (float batches within 1e-3 of witw_tpu's cv2 resize, as
tests/test_torch_data.py); f32 towers rtol 1e-3, atol 1e-4
(tests/test_torch_models.py); paired distances rtol 1e-5, atol 1e-6 with
orientations equal; ranks equal on planted data.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from witw_tpu.cli import common as jcommon
from witw_tpu.configs import fov_experiment as jax_fov_experiment
from witw_tpu.data import loader as jloader
from witw_tpu.data import synthetic as jsynthetic
from witw_tpu.data.csv_registry import read_pair_paths as jax_read_pair_paths
from witw_tpu.evaluation.gallery import FovGalleryEvaluator as JaxEvaluator
from witw_tpu.match import distance as jdistance
from witw_tpu.ops.polar import polar_transform as jax_polar
from witw_tpu.tools import geotiff as jgt
from witw_tpu.train import loop as jloop
from witw_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from witw_tpu.train.metrics import MetricWriter as JaxWriter
from witw_tpu.train.pipeline import make_pipeline
from witw_tpu_torch.cli import common, cvig_fov, cvig_semantic
from witw_tpu_torch.configs import fov_experiment, semantic_experiment
from witw_tpu_torch.configs.base import DatasetConfig
from witw_tpu_torch.data import loader, synthetic
from witw_tpu_torch.data.csv_registry import read_pair_paths
from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator
from witw_tpu_torch.match import distance
from witw_tpu_torch.models.convert_jax import jax_params_to_state_dict
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.metrics import MetricWriter
from witw_tpu_torch.train.pipeline import FovPipeline

GEOMETRY = dict(surface_height=32, surface_width_max=64, overhead_size=32,
                random_orientation=False, num_workers=2)


def _cfgs(dataset="cvusa", fov=360):
    """witw_tpu's and the port's fov presets at a narrow geometry, f32."""
    cfgs = []
    for make in (jax_fov_experiment, fov_experiment):
        cfg = make(dataset, fov)
        cfgs.append(cfg.replace(data=dataclasses.replace(cfg.data, **GEOMETRY),
                                model=dataclasses.replace(cfg.model, compute_dtype="float32")))
    return cfgs


@pytest.fixture(scope="module")
def jax_state():
    """One flax init for every test here (the towers' params do not depend
    on the geometry, the dataset or the fov)."""
    return jax.jit(make_pipeline(_cfgs()[0]).init)(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return jsynthetic.write_synthetic_dataset(
        str(tmp_path_factory.mktemp("data")), n=7, schema="witw", surface_hw=(32, 64),
        overhead_hw=(40, 40))


@pytest.fixture(scope="module")
def semantic_dataset(tmp_path_factory):
    """4-channel TIFFs (zero-padded to 5 by the loaders) behind a WITW CSV
    listing .jpg paths, as tests/test_semantic_e2e.py builds them."""
    root = tmp_path_factory.mktemp("semantic")
    rng = np.random.default_rng(5)
    for sub in ("surface", "overhead"):
        (root / sub).mkdir()
    rows = []
    for i in range(5):
        jgt.write_geotiff_u8(str(root / "surface" / f"{i}.tif"),
                             rng.integers(0, 255, (32, 64, 4), dtype=np.uint8))
        jgt.write_geotiff_u8(str(root / "overhead" / f"{i}.tif"),
                             rng.integers(0, 255, (40, 40, 4), dtype=np.uint8))
        rows.append(",".join([""] * 15 + [f"surface/{i}.jpg", f"overhead/{i}.jpg"]))
    path = root / "pairs.csv"
    path.write_text(",".join([f"c{i}" for i in range(15)] + ["s", "o"]) + "\n"
                    + "\n".join(rows) + "\n")
    return str(path)


def _batches(it):
    return [{k: np.asarray(v) for k, v in b.items()} for b in it]


@pytest.mark.parametrize("shuffle,drop_last,mode,dtype", [
    (False, False, "thread", np.uint8),
    (True, True, "process", np.uint8),
    (True, False, "thread", np.float32),
], ids=["ordered", "shuffled-drop-last-spawned", "shuffled-f32"])
def test_pair_loader_matches_jax(dataset, shuffle, drop_last, mode, dtype):
    """Two epochs of batches: uint8 batches equal (no resize of the
    surfaces; the tiles' resize rounds to the same integers), f32 batches
    within 1e-3."""
    ds = fov_experiment("witw", 70).data.dataset
    pairs = read_pair_paths(ds, dataset)
    assert pairs == jax_read_pair_paths(ds, dataset)
    kw = dict(batch_size=3, surface_hw=(32, 64), overhead_hw=(32, 32), shuffle=shuffle,
              drop_last=drop_last, num_workers=2, seed=4, dtype=dtype)
    got_loader = loader.PairLoader(pairs, worker_mode=mode, **kw)
    want_loader = jloader.PairLoader(pairs, worker_mode="thread", **kw)
    try:
        assert len(got_loader) == len(want_loader) == (2 if drop_last else 3)
        for _ in range(2):
            got, want = _batches(got_loader), _batches(want_loader)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w) == ["idx", "overhead", "surface"]
                np.testing.assert_array_equal(g["idx"], w["idx"])
                for key in ("surface", "overhead"):
                    assert g[key].dtype == w[key].dtype == dtype
                    np.testing.assert_allclose(g[key], w[key], rtol=0,
                                               atol=0 if dtype == np.uint8 else 1e-3)
    finally:
        got_loader.close()
        want_loader.close()


def test_pair_loader_semantic_and_split(semantic_dataset):
    """A 5-channel semantic CSV (the .tif siblings, 4 channels padded to
    5), and the seeded train/val split."""
    ds = semantic_experiment("witw").data.dataset
    pairs = read_pair_paths(ds, semantic_dataset)
    assert all(p.endswith(".tif") for pair in pairs for p in pair)
    kw = dict(batch_size=2, surface_hw=(32, 64), overhead_hw=(40, 40), channels=5,
              shuffle=True, num_workers=2, worker_mode="thread", seed=1)
    got = _batches(loader.PairLoader(pairs, **kw))
    want = _batches(jloader.PairLoader(pairs, **kw))
    assert got[0]["surface"].shape == (2, 32, 64, 5)
    for g, w in zip(got, want):
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])
    assert not got[0]["overhead"][..., 4].any()
    for n_val, seed in ((2, 0), (0, 3), (5, 7)):
        assert loader.split_train_val(pairs, n_val, seed) == jloader.split_train_val(
            pairs, n_val, seed)
    img = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for channels in (1, 3, 4, 6):
        np.testing.assert_array_equal(loader._fix_channels(img, channels),
                                      jloader._fix_channels(img, channels))
    with pytest.raises(FileNotFoundError):
        next(iter(loader.PairLoader([("no.png", "such.png")], **kw)))
    zeros = next(iter(loader.PairLoader([("no.png", "such.png")], skip_errors=True, **kw)))
    assert zeros["surface"].shape == (1, 32, 64, 5) and not zeros["surface"].any()


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True)])
def test_synthetic_pairs_match_jax(shuffle, drop_last):
    kw = dict(n=5, batch_size=2, surface_hw=(8, 16), overhead_hw=(12, 12), seed=3,
              shuffle=shuffle, drop_last=drop_last)
    got, want = synthetic.SyntheticPairs(**kw), jsynthetic.SyntheticPairs(**kw)
    assert len(got) == len(want)
    for _ in range(2):
        for g, w in zip(got, want, strict=True):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])


def test_metric_writer_jsonl_matches_jax(tmp_path):
    records = {}
    for name, cls in (("port", MetricWriter), ("jax", JaxWriter)):
        writer = cls(str(tmp_path / name))
        writer.scalar("train loss", np.float32(0.25), 3)
        writer.text("top_1", "top_1: 12.5", 0)
        writer.embedding("val_embedding", np.ones((4, 6), np.float32),
                         np.zeros((4, 5, 5, 3), np.float32), step=1)
        writer.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            records[name] = [json.loads(line) for line in f]
        assert os.listdir(tmp_path / name) != ["metrics.jsonl"]  # TensorBoard events too
    for got, want in zip(records["port"], records["jax"], strict=True):
        assert list(got) == list(want)
        got.pop("t"), want.pop("t")
        assert got == want


def test_device_prefetch_keeps_order_and_values(rng):
    batches = [{"surface": rng.integers(0, 255, (3, 4, 8, 3), dtype=np.uint8),
                "overhead": rng.integers(0, 255, (3, 6, 6, 3), dtype=np.uint8),
                "idx": np.arange(3), "valid": np.array([True, i != 2, True])}
               for i in range(5)]
    for depth in (1, 2, 4):
        out = list(loop.device_prefetch(iter(batches), "cpu", depth=depth))
        assert [n for _, n in out] == [3, 3, 2, 3, 3]
        for (data, _), batch in zip(out, batches, strict=True):
            assert sorted(data) == ["overhead", "surface", "valid"]
            for key, t in data.items():
                assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
                np.testing.assert_array_equal(t.numpy(), batch[key])


def test_paired_chord_distance_forms_match_jax(rng):
    o = rng.standard_normal((5, 2, 16, 4)).astype(np.float32)
    for sw in (16, 5, 1):
        s = rng.standard_normal((5, 2, sw, 4)).astype(np.float32)
        for got_fn, want_fn in ((distance.paired_chord_distance, jdistance.paired_chord_distance),
                                (distance.paired_chord_distance_fft,
                                 jdistance.paired_chord_distance_fft)):
            d, orient = got_fn(torch.from_numpy(o), torch.from_numpy(s))
            d_w, orient_w = want_fn(jnp.asarray(o), jnp.asarray(s))
            np.testing.assert_array_equal(orient.numpy(), np.asarray(orient_w))
            np.testing.assert_allclose(d.numpy(), np.asarray(d_w), rtol=1e-5, atol=1e-6)


class _Recorder:
    def __init__(self):
        self.calls = []

    def embedding(self, tag, vectors, label_imgs=None, step=0):
        self.calls.append((tag, np.asarray(vectors), np.asarray(label_imgs), step))


def test_dump_val_embeddings_matches_jax(dataset, jax_state):
    jcfg, tcfg = _cfgs("witw", 70)
    state = jax_state
    params = jax_params_to_state_dict(jax.tree.map(np.asarray, state.params))
    pairs = read_pair_paths(tcfg.data.dataset, dataset)
    kw = dict(batch_size=4, surface_hw=(32, 64), overhead_hw=(32, 32), num_workers=1,
              worker_mode="thread")
    got, want = _Recorder(), _Recorder()
    loop.dump_val_embeddings(FovPipeline(tcfg, "cpu"), params, loader.PairLoader(pairs, **kw),
                             got, 2, torch.Generator().manual_seed(0))
    jloop.dump_val_embeddings(make_pipeline(jcfg), state, jloader.PairLoader(pairs, **kw), want,
                              2, jax.random.PRNGKey(0))
    (tag, vec, imgs, step), (tag_w, vec_w, imgs_w, step_w) = got.calls[0], want.calls[0]
    assert (tag, step) == (tag_w, step_w) == ("val_embedding", 3)
    assert vec.shape == vec_w.shape and len(vec) == 8  # 4 surfaces, 4 aligned crops
    np.testing.assert_allclose(vec, vec_w, rtol=1e-3, atol=1e-4)
    assert imgs.shape == imgs_w.shape and imgs.shape[1] == imgs.shape[2]
    np.testing.assert_allclose(imgs, imgs_w, rtol=0, atol=1e-5)


def _planted(rng, n, h, w, c, sw):
    """Queries that are noisy windows of their own gallery maps."""
    gal = rng.standard_normal((n, h, w, c)).astype(np.float32)
    starts = rng.integers(0, w, n)
    cols = (starts[:, None] + np.arange(sw)[None]) % w
    q = np.stack([gal[i][:, cols[i]] for i in range(n)])
    noise = np.linspace(0.05, 3.0, n)[:, None, None, None]
    return gal, (q + noise * rng.standard_normal(q.shape)).astype(np.float32)


def test_fast_matmul_ranks_match_jax(rng):
    gal, q = _planted(rng, 40, 2, 16, 8, 6)
    want = JaxEvaluator(query_block=16, gallery_chunk=8, fast_matmul=True).ranks(gal, q)
    exact = JaxEvaluator(query_block=16, gallery_chunk=8).ranks(gal, q)
    assert len(set(np.asarray(exact).tolist())) > 2  # a spread of ranks
    got = FovGalleryEvaluator(query_block=16, gallery_chunk=8, fast_matmul=True,
                              device="cpu").ranks(gal, q)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(exact))
    with pytest.raises(ValueError, match="fast_matmul"):
        FovGalleryEvaluator(use_fused=True, fast_matmul=True)


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs)
            for a in parser._actions}


@pytest.mark.parametrize("with_fov", [True, False])
def test_base_parser_options_match_jax(with_fov):
    want = _options(jcommon.base_parser(with_fov))
    assert _options(common.base_parser(with_fov)) == want


def test_cli_overrides_plumb_through():
    """tests/test_cli.py:11."""
    parser = common.base_parser(with_fov=True)
    args = parser.parse_args(["--fov", "90", "--batch-size", "16", "--fast-eval",
                              "--train-csv", "a.csv"])
    cfg = common.apply_overrides(fov_experiment(dataset="cvusa", fov=90), args)
    assert cfg.train.batch_size == cfg.eval.batch_size == 16
    assert cfg.eval.fast_matmul is True
    assert cfg.data.dataset.train_csv == "a.csv"
    assert cfg.data.dataset.test_csv == fov_experiment("cvusa", 90).data.dataset.test_csv
    plain = common.apply_overrides(fov_experiment(dataset="cvusa", fov=90),
                                   parser.parse_args(["--fov", "90"]))
    assert plain == fov_experiment(dataset="cvusa", fov=90)
    assert plain.eval.fast_matmul is False
    assert plain.eval.shard_gallery is False
    sharded = common.apply_overrides(fov_experiment(dataset="cvusa", fov=90),
                                     parser.parse_args(["--shard-gallery"]))
    assert sharded.eval.shard_gallery is True
    assert common.host_geometry(fov_experiment("cvusa", 90)) == ((128, 512), (256, 256))
    assert common.host_geometry(fov_experiment("witw", 70)) == ((128, 99), (256, 256))


def _planted_csv(root, n):
    """A CVUSA-schema CSV of blocky tiles and surfaces that are their own
    tile's polar panorama under growing noise (PNG files)."""
    rng = np.random.default_rng(9)
    os.makedirs(root / "img", exist_ok=True)
    coarse = rng.uniform(0, 255, (n, 4, 4, 3))
    over = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2).astype(np.float32)
    pol = np.asarray(jax_polar(jnp.asarray(over), 32, 64))
    noise = np.linspace(0.0, 0.3, n)[:, None, None, None] * 128.0
    surf = np.clip(pol + noise * rng.standard_normal(pol.shape), 0, 255)
    lines = []
    for i in range(n):
        Image.fromarray(over[i].astype(np.uint8)).save(root / "img" / f"o{i}.png")
        Image.fromarray(np.rint(surf[i]).astype(np.uint8)).save(root / "img" / f"s{i}.png")
        lines.append(f"img/o{i}.png,img/s{i}.png")
    path = root / "planted.csv"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_cvig_fov_train_then_test(tmp_path, monkeypatch, jax_state):
    """cvig_fov --mode train then --mode test on a tiny CSV (the preset at
    a narrow geometry, val_quantity 2): checkpoints, the metrics JSONL and
    the test metrics; then run_test's ranks equal witw_tpu's run_test on
    one witw_tpu checkpoint."""
    csv_path = _planted_csv(tmp_path, 12)
    monkeypatch.chdir(tmp_path)
    jcfg, tcfg = _cfgs("cvusa", 360)

    def small(dataset, fov):
        cfg = fov_experiment(dataset, fov)
        return cfg.replace(data=dataclasses.replace(cfg.data, **GEOMETRY),
                           model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                           train=dataclasses.replace(cfg.train, val_quantity=2))

    monkeypatch.setattr(cvig_fov, "fov_experiment", small)
    flags = ["--dataset", "cvusa", "--fov", "360", "--train-csv", csv_path, "--test-csv",
             csv_path, "--batch-size", "2"]
    state = cvig_fov.main(["--mode", "train", "--epochs", "1"] + flags, device="cpu")
    assert state.step == 5  # 10 train pairs in batches of 2
    weights = tmp_path / "weights" / "fov_360_cvusa"
    assert (weights / "best.pt").exists() and (weights / "latest.pt").exists()
    with open(tmp_path / "runs" / "fov_360_cvusa" / "train" / "metrics.jsonl") as f:
        train_log = [json.loads(line) for line in f]
    tags = {r["tag"] for r in train_log}
    assert {"train loss", "val loss", "train pairs_per_sec", "val_embedding", "best_loss"} <= tags
    assert all(np.isfinite(r["value"]) for r in train_log if "value" in r)
    metrics = cvig_fov.main(["--mode", "test"] + flags, device="cpu")
    assert metrics["locations"] == 12
    content = (tmp_path / "runs" / "fov_360_cvusa" / "test" / "metrics.jsonl").read_text()
    assert "top_1" in content and "locations" in content
    fast = cvig_fov.main(["--mode", "test", "--fast-eval"] + flags, device="cpu")
    assert fast["locations"] == 12

    # witw_tpu's checkpoint (both towers the overhead tower's weights, so
    # the planted surfaces sit next to their tiles) restores into the port
    jstate = jax_state.replace(params={"surface": jax_state.params["overhead"],
                                    "overhead": jax_state.params["overhead"]})
    JaxCheckpointer(str(tmp_path / "shared" / "planted")).save_best(jstate, 1.0, 0)
    # decode in threads: forking a process that runs JAX can deadlock
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    ranks = {}
    for name, mod, cfg in (("port", loop, tcfg), ("jax", jloop, jcfg)):
        ds = dataclasses.replace(cfg.data.dataset, test_csv=csv_path)
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset=ds),
                          train=dataclasses.replace(cfg.train,
                                                    checkpoint_dir=str(tmp_path / "shared")),
                          eval=dataclasses.replace(cfg.eval, batch_size=5))
        def record(r, name=name, real=mod.metrics_from_ranks):
            ranks[name] = r
            return real(r)

        monkeypatch.setattr(mod, "metrics_from_ranks", record)
        if name == "port":
            common.run_test(cfg, "planted", device="cpu")
        else:
            jcommon.run_test(cfg, "planted")
    assert len(set(np.asarray(ranks["jax"]).tolist())) > 2  # a spread of ranks, not all 1
    np.testing.assert_array_equal(ranks["port"], np.asarray(ranks["jax"]))


def test_cvig_semantic_parses_and_routes(monkeypatch):
    """cvig_semantic builds the semantic preset with its tag and routes by
    --mode, as cvig_fov does."""
    seen = {}
    monkeypatch.setattr(common, "run_test", lambda cfg, tag, device=None: seen.update(
        cfg=cfg, tag=tag, device=device) or {"top_1": 0.0})
    assert cvig_semantic.main(["--mode", "test", "--dataset", "witw", "--fov", "90",
                               "--batch-size", "4"], device="cpu") == {"top_1": 0.0}
    assert seen["tag"] == "semantic_90_witw" and seen["device"] == "cpu"
    assert seen["cfg"].data.channels == 5 and seen["cfg"].eval.batch_size == 4
    assert isinstance(seen["cfg"].data.dataset, DatasetConfig)


def test_cvig_safa_train_then_test(tmp_path, monkeypatch):
    """cvig_safa --mode train then --mode test on the planted CSV (the SAFA
    preset at the narrow geometry, f32, fov 360, val_quantity 2):
    checkpoints under safa_360_cvusa, the train log without an embedding
    dump (the reference dumps only in the FOV scripts), test metrics from
    euclidean_ranks; then run_test's ranks on the trained towers equal
    witw_tpu's euclidean_ranks of witw_tpu's embeddings of the same batches
    (the surface tower given the overhead tower's weights, so the planted
    surfaces sit next to their tiles)."""
    from witw_tpu.configs import safa_experiment as jax_safa_experiment
    from witw_tpu.evaluation.gallery import euclidean_ranks as jax_ranks
    from witw_tpu.train.pipeline import TrainState as JaxTrainState
    from witw_tpu_torch.cli import cvig_safa
    from witw_tpu_torch.configs import safa_experiment
    from witw_tpu_torch.models.convert_jax import state_dict_to_jax_params
    from witw_tpu_torch.train.checkpoint import Checkpointer
    from witw_tpu_torch.train.pipeline import SafaPipeline, TrainState

    csv_path = _planted_csv(tmp_path, 12)
    monkeypatch.chdir(tmp_path)

    def small(make, dataset, fov):
        cfg = make(dataset, fov)
        return cfg.replace(data=dataclasses.replace(cfg.data, **GEOMETRY),
                           model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                           train=dataclasses.replace(cfg.train, val_quantity=2))

    monkeypatch.setattr(cvig_safa, "safa_experiment",
                        lambda dataset, fov: small(safa_experiment, dataset, fov))
    flags = ["--dataset", "cvusa", "--fov", "360", "--train-csv", csv_path, "--test-csv",
             csv_path, "--batch-size", "2"]
    state = cvig_safa.main(["--mode", "train", "--epochs", "1"] + flags, device="cpu")
    assert state.step == 5
    weights = tmp_path / "weights" / "safa_360_cvusa"
    assert (weights / "best.pt").exists() and (weights / "latest.pt").exists()
    with open(tmp_path / "runs" / "safa_360_cvusa" / "train" / "metrics.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"train loss", "val loss", "best_loss"} <= tags and "val_embedding" not in tags

    ranks = {}

    def record(r, real=loop.metrics_from_ranks):
        ranks["port"] = r
        return real(r)

    monkeypatch.setattr(loop, "metrics_from_ranks", record)
    params = Checkpointer(str(weights)).load("best")["params"]
    shared = {"surface": {k: v.clone() for k, v in params["overhead"].items()},
              "overhead": params["overhead"]}
    cfg = cvig_safa.safa_experiment("cvusa", 360)
    Checkpointer(str(tmp_path / "weights" / "shared")).save(
        "best", TrainState(0, shared, SafaPipeline(cfg, "cpu").optimizer(shared)))
    ds = dataclasses.replace(cfg.data.dataset, test_csv=csv_path)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset=ds),
                      train=dataclasses.replace(cfg.train,
                                                checkpoint_dir=str(tmp_path / "weights")),
                      eval=dataclasses.replace(cfg.eval, batch_size=5))
    metrics = common.run_test(cfg, "shared", device="cpu")
    assert metrics["locations"] == 12 and len(set(ranks["port"].tolist())) > 1

    jcfg = small(jax_safa_experiment, "cvusa", 360)
    jstate = JaxTrainState(step=0, params=state_dict_to_jax_params(shared), batch_stats={},
                           opt_state=None)
    test_loader = common.build_loader(cfg, read_pair_paths(cfg.data.dataset, csv_path),
                                      shuffle=False, drop_last=False, batch_size=5)
    try:
        embeds = [make_pipeline(jcfg).embed_step(jstate, {k: jnp.asarray(b[k]) for k in
                                                          ("surface", "overhead")},
                                                 jax.random.PRNGKey(cfg.train.seed + 1))
                  for b in test_loader]
    finally:
        test_loader.close()
    s = np.concatenate([np.asarray(e[0]) for e in embeds])
    o = np.concatenate([np.asarray(e[1]) for e in embeds])
    np.testing.assert_array_equal(ranks["port"], np.asarray(jax_ranks(o, s)))
    assert cvig_safa.main(["--mode", "test"] + flags, device="cpu")["locations"] == 12


def test_cvig_baseline_train_then_test(tmp_path, monkeypatch, dataset):
    """cvig_baseline --mode train then --mode test on the WITW CSV (the
    baseline preset in f32, batch 2, val_quantity 2; host geometry cut from
    500² photos and 750² tiles to 384² both, the least the seven VALID
    convs take): checkpoints under baseline_witw holding trained BatchNorm
    buffers, the train log without an embedding dump, the test metrics
    equal to loop.test on the restored best (euclidean_ranks, the eval-time
    rotation drawn from a generator seeded seed + 1)."""
    from witw_tpu_torch.cli import cvig_baseline
    from witw_tpu_torch.configs import baseline_experiment
    from witw_tpu_torch.train.checkpoint import Checkpointer
    from witw_tpu_torch.train.pipeline import BaselinePipeline

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(common, "host_geometry", lambda cfg: ((384, 384), (384, 384)))

    def small(dataset):
        cfg = baseline_experiment(dataset)
        return cfg.replace(data=dataclasses.replace(cfg.data, num_workers=2),
                           model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                           train=dataclasses.replace(cfg.train, val_quantity=2))

    monkeypatch.setattr(cvig_baseline, "baseline_experiment", small)
    flags = ["--dataset", "witw", "--train-csv", dataset, "--test-csv", dataset,
             "--batch-size", "2"]
    state = cvig_baseline.main(["--mode", "train", "--epochs", "1"] + flags, device="cpu")
    assert state.step == 2  # 5 train pairs in batches of 2, the last dropped
    weights = tmp_path / "weights" / "baseline_witw"
    assert (weights / "best.pt").exists() and (weights / "latest.pt").exists()
    with open(tmp_path / "runs" / "baseline_witw" / "train" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    tags = {r["tag"] for r in records}
    assert {"train loss", "val loss", "best_loss"} <= tags and "val_embedding" not in tags
    assert all(np.isfinite(r["value"]) for r in records if "value" in r)
    best = Checkpointer(str(weights)).load("best")["params"]
    assert float(best["overhead"]["bn1.running_var"].sub(1.0).abs().max()) > 0

    metrics = cvig_baseline.main(["--mode", "test"] + flags, device="cpu")
    assert metrics["locations"] == 7
    cfg = common.apply_overrides(small("witw"), common.base_parser(False).parse_args(flags))
    pipeline = BaselinePipeline(cfg, "cpu")
    params = Checkpointer(str(weights)).restore(
        "best", pipeline.init_state(torch.Generator().manual_seed(0))).params
    test_loader = common.build_loader(cfg, read_pair_paths(cfg.data.dataset, dataset),
                                      shuffle=False, drop_last=False, batch_size=2)
    try:
        assert loop.test(cfg, pipeline, test_loader, params, verbose=False) == metrics
    finally:
        test_loader.close()
