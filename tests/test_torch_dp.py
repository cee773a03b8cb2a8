"""Data-parallel training and the process layer of the PyTorch port, in one
process on the CPU.

- The data-parallel train step (``parallel.GlobalBatch`` from
  ``loop.device_prefetch(mesh=)``) on meshes of 2 and 4 CPU shards against
  one device's step on the unpadded batch, for the FOV, SAFA and baseline
  families, a full batch and a straggler: the loss (rtol 1e-5), the
  gradients before the Adam step (per tensor, the norm ratio within 1e-4
  of 1 and every element within rtol 1e-4 plus atol 1e-5 max|g|, max|g|
  over the tower's gradient; a factor of the shard count fails this), the
  params after the step (rtol 1e-3, atol 2.5 lr, tests/test_parallel.py's
  bound) and the baseline's BatchNorm buffers (rtol 1e-5 plus atol 1e-5
  max|buffer|). FOV and SAFA run at tests/mp_common.py's geometry (32 x 64
  panoramas, 32² tiles, f32) with the crop heading drawn and, for FOV,
  dropout on: the draws are made for the global batch, so they agree.
  The baseline needs inputs of at least 382² (seven VALID stride-2 convs):
  384 x 416 surfaces and 384² tiles, so its towers differ in size; its
  BatchNorm statistics combine each row's moments in f64
  (``models.baseline.batch_stats``), so both steps normalize with the same
  statistics: with statistics that follow the split (f32 sums over each
  shard, or f32 two-pass moments per shard combined), a leaky ReLU input
  near 0 took the other slope and one output channel of conv3's weight
  gradient moved by 4.8e-4 max|g|. Its elementwise atol is 3e-5 max|g|:
  conv1's bias gradient sums 191² values a row, and the f32 convs'
  summation order (which follows the thread count) moved it by 1.07e-5
  max|g| at two threads, 8e-6 at eight.
- The port's data-parallel step against witw_tpu's sharded step on its
  8-device CPU mesh (tests/test_parallel.py's), weights carried by
  ``models.convert_jax``: FOV and SAFA (full batch and straggler) and the
  baseline (straggler), dropout off, the crop fixed and the rotation off
  (the two packages' random streams differ).
- ``train(mesh=)`` against ``train`` on one device; ``global_batch_from_local``
  in one process; the Checkpointer's process-0 writes; the port's
  ``GrainPairLoader`` against its contract and witw_tpu's decoded batches.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu_torch.configs import (DataConfig, DatasetConfig, EvalConfig, ExperimentConfig,
                                    FovDsmModelConfig, OptimConfig, TrainConfig,
                                    baseline_experiment, safa_experiment)
from witw_tpu_torch.data import synthetic
from witw_tpu_torch.data.grain_loader import GrainPairLoader
from witw_tpu_torch.models.convert_jax import jax_params_to_state_dict
from witw_tpu_torch.ops import rotation
from witw_tpu_torch.parallel import (GlobalBatch, global_batch_from_local, make_mesh,
                                     process_count, process_index)
from witw_tpu_torch.train import checkpoint as ckpt_mod
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.pipeline import TrainState, make_pipeline

CPU = torch.device("cpu")
LR = 1e-4
BASELINE_HW = (384, 384)
BASELINE_SURFACE_HW = (384, 416)  # towers of different sizes at every layer


_INITS = {}


def _fresh(pipeline) -> TrainState:
    """A fresh train state of ``pipeline`` from the seed-0 init, drawn once
    per family and config, copied for each use."""
    key = (type(pipeline).__name__, repr(pipeline.cfg))
    if key not in _INITS:
        _INITS[key] = pipeline.init(torch.Generator().manual_seed(0))
    params = {t: {k: v.clone() for k, v in p.items()} for t, p in _INITS[key].items()}
    return TrainState(0, params, pipeline.optimizer(params))


def _fov_cfg(batch=8, dropout=0.2, random_orientation=True, fov=90, **train):
    ds = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True)
    return ExperimentConfig(
        data=DataConfig(dataset=ds, surface_height=32, surface_width_max=64, overhead_size=32,
                        fov=fov, random_orientation=random_orientation),
        model=FovDsmModelConfig(compute_dtype="float32", dropout_rate=dropout),
        train=TrainConfig(batch_size=batch, optim=OptimConfig(learning_rate=LR), **train),
        eval=EvalConfig(batch_size=batch, query_block=batch),
    )


def _cfg(family):
    if family == "fov":
        return _fov_cfg()
    if family == "safa":
        cfg = safa_experiment("cvusa", 90)
        return cfg.replace(
            data=dataclasses.replace(cfg.data, surface_height=32, surface_width_max=64,
                                     overhead_size=32, random_orientation=True),
            model=dataclasses.replace(cfg.model, compute_dtype="float32"),
            train=dataclasses.replace(cfg.train, optim=OptimConfig(learning_rate=LR)))
    cfg = baseline_experiment("witw")
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                       train=dataclasses.replace(cfg.train, optim=OptimConfig(learning_rate=LR)))


def _batch(rng, cfg, b):
    if cfg.model.kind == "baseline":
        s_hw, o_hw = BASELINE_SURFACE_HW, BASELINE_HW
    else:
        d = cfg.data
        s_hw, o_hw = (d.surface_height, d.surface_width_max), (d.overhead_size, d.overhead_size)
    return {"surface": rng.uniform(0, 255, (b, *s_hw, 3)).astype(np.float32),
            "overhead": rng.uniform(0, 255, (b, *o_hw, 3)).astype(np.float32)}


def _global(batch, mesh) -> GlobalBatch:
    (out, _), = list(loop.device_prefetch([batch], None, mesh=mesh))
    return out


def _cpu_mesh(n):
    return make_mesh(devices=[CPU] * n)


def _step(pipeline, batch, seed=5, state=None):
    state = state or _fresh(pipeline)
    state, metrics = pipeline.train_step(state, batch, torch.Generator().manual_seed(seed))
    return state, float(metrics["loss"])


def _grads(pipeline, state):
    return {tower: {k: p.grad.clone() for k, p in state.params[tower].items()
                    if p.grad is not None} for tower in ("surface", "overhead")}


def assert_grads_close(got, want, atol_frac):
    """Per tower: every tensor's norm ratio within 1e-4 of 1, every element
    within 1e-4 |want| + atol_frac max|want| (max over the tower)."""
    for tower in want:
        assert set(got[tower]) == set(want[tower]) and want[tower], tower
        gmax = max(float(g.abs().max()) for g in want[tower].values())
        for name, w in want[tower].items():
            g = got[tower][name]
            ratio = float(g.norm() / w.norm())
            assert abs(ratio - 1.0) <= 1e-4, (tower, name, ratio)
            excess = float(((g - w).abs() - 1e-4 * w.abs()).max())
            assert excess <= atol_frac * gmax, (tower, name, excess / gmax)


def _assert_params_close(got, want):
    for tower in want:
        for name, w in want[tower].items():
            np.testing.assert_allclose(got[tower][name].detach().numpy(), w.detach().numpy(),
                                       rtol=1e-3, atol=2.5 * LR, err_msg=f"{tower}/{name}")


# --- the data-parallel step against one device's -------------------------

CASES = [(family, n_dev, kind) for family in ("fov", "safa", "baseline")
         for n_dev in (2, 4) for kind in ("full", "straggler")]


@pytest.mark.parametrize("family,n_dev,kind", CASES,
                         ids=[f"{f}-{n}-{k}" for f, n, k in CASES])
def test_dp_step_matches_one_device(family, n_dev, kind):
    """The loss, the gradients before the step, the params after it and the
    baseline's running buffers of the data-parallel step on a mesh of
    ``n_dev`` CPU shards equal one device's step on the unpadded batch."""
    cfg = _cfg(family)
    pipeline = make_pipeline(cfg, CPU)
    full = 4 if family == "baseline" else 8
    batch = _batch(np.random.default_rng(0), cfg, full - (kind == "straggler"))
    one, loss_one = _step(pipeline, batch)
    gb = _global(batch, _cpu_mesh(n_dev))
    assert gb.rows == full and gb.count == len(batch["surface"]) and len(gb) == n_dev
    dp, loss_dp = _step(pipeline, gb)
    np.testing.assert_allclose(loss_dp, loss_one, rtol=1e-5)
    assert dp.step == one.step == 1
    assert_grads_close(_grads(pipeline, dp), _grads(pipeline, one),
                       3e-5 if family == "baseline" else 1e-5)
    trainable = {t: set(pipeline.trainable_names(one.params[t])) for t in one.params}
    _assert_params_close({t: {k: v for k, v in p.items() if k in trainable[t]}
                          for t, p in dp.params.items()},
                         {t: {k: v for k, v in p.items() if k in trainable[t]}
                          for t, p in one.params.items()})
    start = _fresh(pipeline).params
    for tower, params in one.params.items():
        for name, want in params.items():
            got = dp.params[tower][name]
            if name in trainable[tower]:
                continue
            if "running" in name:  # the baseline's BatchNorm buffers, moved alike
                assert not torch.equal(want, start[tower][name])
                excess = float(((got - want).abs() - 1e-5 * want.abs()).max())
                assert excess <= 1e-5 * float(want.abs().max()), (tower, name)
            else:  # frozen weights untouched
                assert torch.equal(got, want), (tower, name)


def test_shard_count_factor_and_local_losses_fail_the_checks():
    """What the checks above must catch: gradients scaled by the shard count
    (a mean over shards where the loss is global) fail assert_grads_close,
    and the mean of per-shard losses (plain DDP's) is another loss than the
    global batch's."""
    cfg = _cfg("fov")
    pipeline = make_pipeline(cfg, CPU)
    batch = _batch(np.random.default_rng(0), cfg, 8)
    one, loss_one = _step(pipeline, batch)
    want = _grads(pipeline, one)
    scaled = {t: {k: 2.0 * g for k, g in gs.items()} for t, gs in want.items()}
    with pytest.raises(AssertionError):
        assert_grads_close(scaled, want, 1e-5)
    halves = [_step(pipeline, {k: v[h:h + 4] for k, v in batch.items()})[1] for h in (0, 4)]
    assert abs(np.mean(halves) / loss_one - 1.0) > 1e-3


# --- against witw_tpu's sharded step --------------------------------------

def _jax_fov_cfg(batch):
    from witw_tpu.configs import (DataConfig as JData, DatasetConfig as JDataset,
                                  ExperimentConfig as JExperiment,
                                  FovDsmModelConfig as JModel, OptimConfig as JOptim,
                                  TrainConfig as JTrain)

    ds = JDataset(name="cvusa", train_csv="", test_csv="", panorama=True)
    return JExperiment(
        data=JData(dataset=ds, surface_height=32, surface_width_max=64, overhead_size=32,
                   random_orientation=False),
        model=JModel(compute_dtype="float32", dropout_rate=0.0),
        train=JTrain(batch_size=batch, optim=JOptim(learning_rate=LR)))


def _jax_sharded_step(jp, jstate, batch):
    """witw_tpu's train step on the 8-device CPU mesh, a straggler padded
    and marked by its device_prefetch; returns (state, loss)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from witw_tpu.parallel import make_mesh as jax_make_mesh
    from witw_tpu.train.loop import device_prefetch as jax_prefetch

    mesh = jax_make_mesh(n_data=8)
    jstate = jax.device_put(jstate, NamedSharding(mesh, P()))
    (data, _), = list(jax_prefetch([batch], mesh))
    jstate, metrics = jp.train_step(jstate, data, jax.random.PRNGKey(1))
    return jstate, float(metrics["loss"])


@pytest.mark.parametrize("b", [8, 7], ids=["full", "straggler"])
def test_fov_dp_step_matches_jax_sharded_step(b):
    from witw_tpu.train.pipeline import FovPipeline as JaxPipeline

    jp = JaxPipeline(_jax_fov_cfg(8))
    jstate = jp.init(jax.random.PRNGKey(0))
    params = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    batch = _batch(np.random.default_rng(1), _fov_cfg(), b)
    jstate, jloss = _jax_sharded_step(jp, jstate, batch)

    pipeline = make_pipeline(_fov_cfg(8, dropout=0.0, random_orientation=False, fov=360), CPU)
    state = TrainState(0, params, pipeline.optimizer(params))
    state, loss = _step(pipeline, _global(batch, _cpu_mesh(2)), state=state)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_params_close(state.params,
                         jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params)))


@pytest.mark.parametrize("b", [8, 7], ids=["full", "straggler"])
def test_safa_dp_step_matches_jax_sharded_step(b):
    """SAFA at tests/mp_common.py's geometry, the crop fixed: witw_tpu's
    step on its 8 devices against the port's on 2 CPU shards."""
    from witw_tpu.configs import safa_experiment as jax_safa_experiment
    from witw_tpu.train.pipeline import make_pipeline as jax_make_pipeline

    cfgs = []
    for make in (jax_safa_experiment, safa_experiment):
        cfg = make("cvusa", 90)
        cfgs.append(cfg.replace(
            data=dataclasses.replace(cfg.data, surface_height=32, surface_width_max=64,
                                     overhead_size=32, random_orientation=False),
            model=dataclasses.replace(cfg.model, compute_dtype="float32"),
            train=dataclasses.replace(cfg.train, batch_size=8, optim=dataclasses.replace(
                cfg.train.optim, learning_rate=LR))))
    jp = jax_make_pipeline(cfgs[0])
    jstate = jax.jit(jp.init)(jax.random.PRNGKey(0))
    params = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    batch = _batch(np.random.default_rng(4), cfgs[1], b)
    jstate, jloss = _jax_sharded_step(jp, jstate, batch)

    pipeline = make_pipeline(cfgs[1], CPU)
    state = TrainState(0, params, pipeline.optimizer(params))
    state, loss = _step(pipeline, _global(batch, _cpu_mesh(2)), state=state)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_params_close(state.params,
                         jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params)))


def test_baseline_dp_step_matches_jax_sharded_step(monkeypatch):
    """A straggler of 3 (witw_tpu pads it to 8 rows, the port to 4
    over 2 shards): BatchNorm's statistics over the 3 real rows in both."""
    import witw_tpu.train.pipeline as jax_pipeline_mod
    from witw_tpu.configs import baseline_experiment as jax_baseline_experiment

    for mod in (jax_pipeline_mod, rotation):
        monkeypatch.setattr(mod, "synced_rotation",
                            lambda rng, s, o, panorama, quantized=False, draw=None: (s, o))
    cfgs = []
    for make in (jax_baseline_experiment, baseline_experiment):
        cfg = make("witw")
        cfgs.append(cfg.replace(
            model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                      conv_precision="highest"),
            train=dataclasses.replace(cfg.train, optim=dataclasses.replace(
                cfg.train.optim, learning_rate=LR))))
    jp = jax_pipeline_mod.make_pipeline(cfgs[0])
    jstate = jax.jit(lambda r: jp.init(r, surface_hw=BASELINE_SURFACE_HW,
                                            overhead_hw=BASELINE_HW))(
        jax.random.PRNGKey(0))
    params = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params),
                                      jax.tree.map(np.asarray, jstate.batch_stats))
    batch = _batch(np.random.default_rng(2), cfgs[1], 3)
    jstate, jloss = _jax_sharded_step(jp, jstate, batch)

    pipeline = make_pipeline(cfgs[1], CPU)
    state = TrainState(0, params, pipeline.optimizer(params))
    state, loss = _step(pipeline, _global(batch, _cpu_mesh(2)), state=state)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params),
                                    jax.tree.map(np.asarray, jstate.batch_stats))
    _assert_params_close({t: {k: v for k, v in p.items() if "running" not in k}
                          for t, p in state.params.items()},
                         {t: {k: v for k, v in p.items() if "running" not in k}
                          for t, p in want.items()})
    for tower in want:
        for name in ("bn7.running_mean", "bn7.running_var", "bn1.running_var"):
            w = want[tower][name]
            np.testing.assert_allclose(state.params[tower][name].numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-4 * float(w.abs().max()))


# --- train(mesh=), global_batch_from_local --------------------------------

def test_train_on_a_mesh_matches_one_device(tmp_path):
    """One epoch of 2 train steps (a batch of 4 and a straggler of 3) and a
    val batch: ``best`` and ``latest`` of train(mesh=) on 2 CPU shards
    against train on one device."""
    rng = np.random.default_rng(3)
    cfg = _fov_cfg(4, num_epochs=1)
    train_batches = [_batch(rng, cfg, 4), _batch(rng, cfg, 3)]
    val_batches = [_batch(rng, cfg, 3)]
    pipeline = make_pipeline(cfg, CPU)
    runs = {}
    for name, mesh in (("one", None), ("mesh", _cpu_mesh(2))):
        ckpt = Checkpointer(str(tmp_path / name))
        state = loop.train(cfg, pipeline, train_batches, val_batches, checkpointer=ckpt,
                           verbose=False, mesh=mesh)
        assert state.step == 2
        runs[name] = ckpt
    for ck in ("best", "latest"):
        want, got = runs["one"].load(ck), runs["mesh"].load(ck)
        assert want["step"] == got["step"] == 2
        for tower in want["params"]:
            for k, w in want["params"][tower].items():
                np.testing.assert_allclose(got["params"][tower][k].numpy(), w.numpy(),
                                           rtol=1e-3, atol=2 * 2.5 * LR, err_msg=k)
    np.testing.assert_allclose(runs["mesh"].best_val_loss(), runs["one"].best_val_loss(),
                               rtol=1e-5)
    assert runs["mesh"].meta("latest")["epoch"] == runs["one"].meta("latest")["epoch"] == 1
    shutil.rmtree(tmp_path)  # six checkpoints of the full-width VGG16 towers, about 1 GB


def test_global_batch_from_local_single_process():
    """One process: shard_batch of the whole batch, from global row 0."""
    assert process_count() == 1 and process_index() == 0
    mesh = make_mesh(n_data=2, n_gallery=2, devices=[CPU] * 4)
    batch = {"surface": np.arange(8 * 2, dtype=np.float32).reshape(8, 2),
             "overhead": np.zeros((8, 3), np.float32),
             "valid": np.arange(8) < 7}
    gb = global_batch_from_local(batch, mesh)
    assert isinstance(gb, GlobalBatch) and len(gb) == 2
    assert (gb.start, gb.rows, gb.count) == (0, 8, 7)
    assert gb.valid.tolist() == [True] * 7 + [False]
    np.testing.assert_array_equal(gb[1]["surface"].numpy(), batch["surface"][4:])
    assert gb[1]["valid"].tolist() == [True, True, True, False]
    with pytest.raises(ValueError, match="does not split"):
        global_batch_from_local({"surface": np.zeros((3, 2))}, mesh)
    assert global_batch_from_local(None, mesh) is None  # the loader has ended


def test_mesh_positions_and_initialize_distributed_arguments(monkeypatch):
    mesh = make_mesh(n_data=2, n_gallery=2, devices=[CPU] * 4)
    assert mesh.processes == 1 and list(mesh.local_positions) == [0, 1, 2, 3]
    assert mesh.home == CPU and len(mesh.local_data_devices) == 2
    from witw_tpu_torch.parallel import initialize_distributed

    with pytest.raises(ValueError, match="backend"):
        initialize_distributed("127.0.0.1:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed("127.0.0.1:1", backend="gloo")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(ValueError, match="NCCL needs LOCAL_RANK"):
        initialize_distributed("127.0.0.1:1", 2, 1, backend="nccl")
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(ValueError, match="NCCL needs a GPU of its own"):
        initialize_distributed("127.0.0.1:1", 2, 1, backend="nccl")


def test_collectives_stage_where_the_backend_takes_tensors(monkeypatch):
    """Gloo's collectives run on host copies; NCCL's on the current CUDA
    device, a host tensor's too (NCCL takes no CPU tensor)."""
    from witw_tpu_torch.parallel import collectives

    monkeypatch.setattr(collectives.dist, "get_backend", lambda: "gloo")
    assert collectives.stage_device() == CPU
    monkeypatch.setattr(collectives.dist, "get_backend", lambda: "nccl")
    monkeypatch.setattr(collectives.torch.cuda, "current_device", lambda: 3)
    assert collectives.stage_device() == torch.device("cuda", 3)
    monkeypatch.setattr(collectives, "stage_device", lambda: torch.device("meta"))
    for t in (torch.ones(3, dtype=torch.int64), torch.ones(2, 4, dtype=torch.bfloat16)):
        staged = collectives._staged(t)
        assert staged.device.type == "meta" and staged.shape == t.shape
        assert staged.dtype == (torch.float32 if t.dtype == torch.bfloat16 else t.dtype)


# --- Checkpointer across processes -----------------------------------------

def test_checkpointer_writes_on_process_zero_only(tmp_path, monkeypatch):
    """A non-zero process creates and writes nothing; every process
    restores what process 0 wrote (cf. tests/test_train.py:362)."""
    pipeline = make_pipeline(_fov_cfg(), CPU)
    state = pipeline.init_state(torch.Generator().manual_seed(0))
    monkeypatch.setattr(ckpt_mod, "process_index", lambda: 1)
    ck1 = Checkpointer(str(tmp_path / "mh"))
    assert ck1.save("latest", state, {"step": 0}) is None
    ck1.save_step(state, 1)
    ck1.save_best(state, 0.5, 1)
    assert not (tmp_path / "mh").exists()

    monkeypatch.setattr(ckpt_mod, "process_index", lambda: 0)
    ck0 = Checkpointer(str(tmp_path / "mh"), async_saves=True)
    state.step = 3
    ck0.save_step(state, 3, {"epoch": 2})
    ck0.close()
    assert (tmp_path / "mh" / "latest.pt").exists()

    monkeypatch.setattr(ckpt_mod, "process_index", lambda: 1)
    fresh = pipeline.init_state(torch.Generator().manual_seed(9))
    restored = Checkpointer(str(tmp_path / "mh")).restore_latest(fresh)
    assert restored is not None and restored.step == 3
    for tower in state.params:
        for k, v in state.params[tower].items():
            assert torch.equal(restored.params[tower][k], v)
    shutil.rmtree(tmp_path)


# --- GrainPairLoader ---------------------------------------------------------

@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    from witw_tpu_torch.data.csv_registry import read_pair_paths
    from witw_tpu_torch.configs import dataset_config

    root = tmp_path_factory.mktemp("grain")
    csv = synthetic.write_synthetic_dataset(str(root), n=10, surface_hw=(16, 32),
                                            overhead_hw=(16, 16))
    ds = dataclasses.replace(dataset_config("cvusa"), train_csv=csv)
    return read_pair_paths(ds, csv)


def _grain(pairs, **kw):
    return GrainPairLoader(pairs, batch_size=3, surface_hw=(16, 32), overhead_hw=(16, 16),
                           **kw)


def test_grain_loader_order_is_seeded_reshuffled_and_partitioned(pairs):
    a, b = _grain(pairs, shuffle=True, seed=7), _grain(pairs, shuffle=True, seed=7)
    e1 = [x["idx"] for x in a]
    assert [x.tolist() for x in e1] == [x["idx"].tolist() for x in b]
    assert sorted(np.concatenate(e1).tolist()) == list(range(10))
    e2 = np.concatenate([x["idx"] for x in a])
    assert e2.tolist() != np.concatenate(e1).tolist()  # reshuffled
    assert np.array_equal(a.order(5), b.order(5)) and not np.array_equal(a.order(5), a.order(6))
    seen = []
    for shard in range(3):
        loader = _grain(pairs, shuffle=True, seed=3, shard_index=shard, shard_count=3,
                        num_workers=2)
        seen.append(np.concatenate([x["idx"] for x in loader]))
        loader.close()
    assert sum(len(s) for s in seen) == 10
    assert set(np.concatenate(seen).tolist()) == set(range(10))
    with pytest.raises(ValueError):
        _grain(pairs, shard_index=2, shard_count=2)


@pytest.mark.parametrize("n,batch,count,drop_last", [
    (10, 3, 1, False), (10, 3, 3, False), (10, 3, 3, True), (10, 4, 4, True), (7, 2, 2, False),
    (9, 4, 2, True)])
def test_grain_loader_len_is_witw_tpus(pairs, n, batch, count, drop_last):
    from witw_tpu.data.grain_loader import GrainPairLoader as JaxGrain

    for shard in range(count):
        kw = dict(batch_size=batch, surface_hw=(16, 32), overhead_hw=(16, 16),
                  drop_last=drop_last, shard_index=shard, shard_count=count)
        port = GrainPairLoader(pairs[:n], **kw)
        assert len(port) == len(JaxGrain(pairs[:n], **kw)) == len(list(port)), (shard, kw)


def test_grain_loader_decodes_as_witw_tpu(pairs):
    """Unshuffled, both packages read the same pairs in the same order;
    the decoded batches are equal."""
    pytest.importorskip("grain")
    from witw_tpu.data.grain_loader import GrainPairLoader as JaxGrain

    kw = dict(batch_size=4, surface_hw=(16, 32), overhead_hw=(16, 16), shard_index=1,
              shard_count=2)
    got, want = list(GrainPairLoader(pairs, **kw)), list(JaxGrain(pairs, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"surface", "overhead", "idx"}
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
