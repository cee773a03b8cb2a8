"""The SAFA family in the PyTorch port against witw_tpu, on the CPU.

Towers, pipeline and ranks run at a narrow geometry (32 x 128 panoramas,
fov 90, 32^2 tiles; surface head h·w 16, overhead 64) on one flax init moved
into the port with ``models/convert_jax``, inputs from a numpy seed, TF32 off.
Tolerances as the FOV tests': f32 towers rtol 1e-3, atol 1e-4 (XLA:CPU conv
precision, tests/test_torch_models.py); bf16 towers rtol 2e-2, atol 2e-2
max|y|; two Adam steps as tests/test_torch_train.py holds four; ranks equal
on planted and exactly tied data.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.configs import safa_experiment as jax_safa_experiment
from witw_tpu.evaluation.gallery import euclidean_ranks as jax_ranks
from witw_tpu.match.losses import pairwise_sq_distances as jax_sq_distances
from witw_tpu.models.safa import safa_trainable_mask as jax_mask
from witw_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from witw_tpu.train.pipeline import make_pipeline as jax_make_pipeline
from witw_tpu_torch.configs import fov_experiment, safa_experiment
from witw_tpu_torch.configs.base import BaselineModelConfig
from witw_tpu_torch.evaluation.gallery import euclidean_ranks
from witw_tpu_torch.match.losses import pairwise_sq_distances
from witw_tpu_torch.models.convert_jax import (jax_params_to_state_dict,
                                               state_dict_to_jax_params)
from witw_tpu_torch.models.safa import VggSafa, safa_trainable_mask
from witw_tpu_torch.parallel import make_mesh
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.pipeline import (BaselinePipeline, FovPipeline, SafaPipeline,
                                           TrainState, make_pipeline)

GEOMETRY = dict(surface_height=32, surface_width_max=128, overhead_size=32,
                random_orientation=False)
LR = 1e-5
N_STEPS = 2


def _cfgs(compute_dtype="float32", **model):
    """witw_tpu's and the port's SAFA preset at the narrow geometry."""
    cfgs = []
    for make in (jax_safa_experiment, safa_experiment):
        cfg = make("cvusa", 90)
        cfgs.append(cfg.replace(
            data=dataclasses.replace(cfg.data, **GEOMETRY),
            model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype, **model),
            train=dataclasses.replace(cfg.train, batch_size=4)))
    return cfgs


@pytest.fixture(scope="module")
def jax_state():
    """One flax SAFA init for the file (its head shapes depend on the
    geometry, not on the compute dtype)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return jax.jit(jax_make_pipeline(_cfgs()[0]).init)(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params0(jax_state):
    return jax.tree.map(np.asarray, jax_state.params)


def _batch(rng, b=4):
    return {"surface": rng.uniform(0, 255, (b, 32, 128, 3)).astype(np.float32),
            "overhead": rng.uniform(0, 255, (b, 32, 32, 3)).astype(np.float32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_bridge_carries_safa_towers_both_ways(params0):
    """witw_tpu's SafaPipeline.init tree -> the port's state dicts -> back,
    array_equal; the state dicts fit the port's towers, the head's four
    arrays unchanged under safa.*."""
    sd = jax_params_to_state_dict(params0)
    back = state_dict_to_jax_params(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params0)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params0)):
        np.testing.assert_array_equal(a, b)
    tcfg = _cfgs()[1]
    for tower, circ, width in (("surface", False, 32), ("overhead", True, 128)):
        model = VggSafa(tcfg.model, (32, width), circ)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert shapes == {k: tuple(v.shape) for k, v in sd[tower].items()}
        np.testing.assert_array_equal(sd[tower]["safa.fc2"].numpy(),
                                      params0[tower]["safa"]["fc2"])
    assert sd["surface"]["safa.fc1"].shape == (16, 8, 8)
    assert sd["overhead"]["safa.fc1"].shape == (64, 32, 8)


def test_flax_safa_checkpoint_restores(jax_state, tmp_path):
    """A witw_tpu SAFA checkpoint (.msgpack) restores into the port's
    SafaPipeline state through Checkpointer.restore."""
    JaxCheckpointer(str(tmp_path)).save("best", jax_state)
    tp = SafaPipeline(_cfgs()[1], "cpu")
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jax_state.params))
    zeros = {t: {k: torch.zeros_like(v) for k, v in sd.items()} for t, sd in want.items()}
    state = Checkpointer(str(tmp_path)).restore(
        "best", TrainState(step=0, params=zeros, optimizer=tp.optimizer(zeros)))
    assert state.step == int(jax_state.step)
    for tower in ("surface", "overhead"):
        for k, v in want[tower].items():
            assert torch.equal(state.params[tower][k].detach(), v), (tower, k)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_towers_match_jax(rng, jax_state, params0, compute_dtype):
    """embed_step on one raw batch: unit vectors [B, 8 x 512] from both
    towers, at the dtype's tolerance."""
    jcfg, tcfg = _cfgs(compute_dtype)
    batch = _batch(rng, 3)
    js, jo = jax_make_pipeline(jcfg).embed_step(jax_state, _jnp(batch))
    ts, to = make_pipeline(tcfg, "cpu").embed_step(jax_params_to_state_dict(params0), batch)
    for got, want in ((ts, js), (to, jo)):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape == (3, 4096) and got.dtype == torch.float32
        if compute_dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-2,
                                       atol=2e-2 * float(np.abs(want).max()))
        np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, rtol=1e-5)


def test_tower_rejects_another_geometry(params0):
    model = VggSafa(_cfgs()[1].model, (32, 32))
    with pytest.raises(ValueError, match="built for"):
        model(torch.zeros(1, 32, 64, 3))


def test_train_steps_match_jax(rng, jax_state, params0):
    """Two train steps from the same flax init and batch, crop starts
    explicit (random_orientation off): losses within rtol 1e-3, atol 1e-5;
    the trainable params (conv4_x and the heads) moved as witw_tpu moved
    them, within tests/test_torch_train.py's Adam-noise gates; the frozen
    ones bit-unchanged."""
    jcfg, tcfg = _cfgs()
    batch = _batch(rng)
    jp = jax_make_pipeline(jcfg)
    jstate = jax.tree.map(jnp.array, jax_state)  # train_step donates its state
    jax_losses = []
    for step in range(N_STEPS):
        jstate, metrics = jp.train_step(jstate, _jnp(batch), jax.random.PRNGKey(step))
        jax_losses.append(float(metrics["loss"]))
    params_j = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))

    tp = SafaPipeline(tcfg, "cpu")
    params = jax_params_to_state_dict(params0)
    state = TrainState(step=0, params=params, optimizer=tp.optimizer(params))
    torch_losses = []
    for _ in range(N_STEPS):
        state, metrics = tp.train_step(state, batch, torch.Generator().manual_seed(0))
        torch_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(torch_losses, jax_losses, rtol=1e-3, atol=1e-5)

    start = jax_params_to_state_dict(params0)
    for tower in ("surface", "overhead"):
        trainable = set(tp.trainable_names(start[tower]))
        assert len(trainable) == 6 + 4  # conv_17/19/21 and the head's four arrays
        for name, p0 in start[tower].items():
            got = state.params[tower][name].detach()
            if name not in trainable:
                assert torch.equal(got, p0) and torch.equal(params_j[tower][name], p0), name
                continue
            dt = (got - p0).numpy()
            dj = (params_j[tower][name] - p0).numpy()
            assert np.abs(dj).max() > 0 and np.abs(dt).max() > 0, (tower, name)
            close = np.abs(dj - dt) <= 0.05 * np.abs(dt) + 0.2 * LR
            assert np.mean(close) > 0.98, (tower, name, float(np.mean(close)))
            cos = float(np.sum(dj * dt) / max(np.linalg.norm(dj) * np.linalg.norm(dt), 1e-30))
            assert cos > 0.999, (tower, name, cos)
            assert np.max(np.abs(dj - dt)) <= 2 * LR * N_STEPS + 1e-9, (tower, name)


@pytest.mark.parametrize("freeze", [True, False])
def test_trainable_mask_matches_jax(params0, freeze):
    cfg = dataclasses.replace(_cfgs()[1].model, freeze_backbone=freeze)
    sd = jax_params_to_state_dict(params0)["overhead"]
    mask = jax_mask(params0["overhead"], cfg)
    want = [n for n in sd if _lookup(mask, n)]
    assert safa_trainable_mask(list(sd), cfg) == want
    assert len(want) == (10 if freeze else 24)


def _lookup(tree, name):
    *path, leaf = name.split(".")
    node = tree
    for key in path:
        node = node[key]
    return node["kernel" if leaf == "weight" else leaf]


def test_pairwise_sq_distances_matches_jax(rng):
    a = rng.standard_normal((5, 64)).astype(np.float32)
    b = rng.standard_normal((7, 64)).astype(np.float32)
    b[3] = a[1]  # an exact pair: its distance clamps at 0, not -eps
    want = np.asarray(jax_sq_distances(jnp.asarray(a), jnp.asarray(b)))
    got = pairwise_sq_distances(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert got.min() >= 0.0


def _planted(rng, n, d=16):
    """Queries near their own gallery row under growing noise: a spread of
    ranks."""
    g = rng.standard_normal((n, d)).astype(np.float32)
    noise = np.linspace(0.0, 4.0, n, dtype=np.float32)[:, None]
    q = g + noise * rng.standard_normal((n, d)).astype(np.float32)
    return g, q


@pytest.mark.parametrize("case", ["planted", "ties", "true_match"])
def test_euclidean_ranks_match_jax(rng, case):
    """Equal ranks, in blocks of 7 queries: planted data; exact ties (three
    gallery rows each duplicated, a query equal to its match); and an
    asymmetric gallery with explicit true matches."""
    g, q = _planted(rng, 40)
    tm = None
    if case == "ties":
        g[[5, 17, 30]] = g[[4, 16, 29]]  # duplicates of the true matches 4, 16, 29
        q[[4, 16, 29]] = g[[4, 16, 29]]
        q[9] = g[9]  # a query on its match, at distance 0
    if case == "true_match":
        g = np.concatenate([g, rng.standard_normal((13, 16)).astype(np.float32)])
        perm = rng.permutation(len(g))
        g = g[perm]
        tm = np.argsort(perm)[:40]
    want = np.asarray(jax_ranks(g, q, block=7, true_match=tm))
    got = euclidean_ranks(g, q, block=7, true_match=tm, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 3
    if case == "ties":
        assert got[4] == got[16] == got[29] == 2  # the duplicate ties the match and counts
        assert got[9] == 1
    for n_dev in (2, 3):  # the gallery resident in shards: the same ranks
        mesh = make_mesh(devices=["cpu"] * n_dev)
        np.testing.assert_array_equal(
            euclidean_ranks(g, q, block=7, true_match=tm, mesh=mesh), got)


def test_make_pipeline_and_the_loop_take_safa(rng, params0):
    """make_pipeline picks the family (a baseline config gives a
    BaselinePipeline);
    loop.test_ranks ranks SAFA vectors by euclidean_ranks (device default:
    the card, here a RuntimeError) and dump_val_embeddings writes nothing for
    them."""
    jcfg, tcfg = _cfgs()
    assert isinstance(make_pipeline(tcfg, "cpu"), SafaPipeline)
    assert isinstance(make_pipeline(fov_experiment("cvusa", 360), "cpu"), FovPipeline)
    assert isinstance(make_pipeline(tcfg.replace(model=BaselineModelConfig()), "cpu"),
                      BaselinePipeline)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SafaPipeline(tcfg)
    tp = SafaPipeline(tcfg, "cpu")
    params = jax_params_to_state_dict(params0)
    batches = [_batch(rng, 3), _batch(rng, 2)]
    metrics, ranks = loop.test_ranks(tcfg, tp, batches, params, verbose=False)
    s, o = loop.embed_all(tp, params, batches)
    assert s.shape == o.shape == (5, 4096)
    np.testing.assert_array_equal(ranks, euclidean_ranks(o, s))
    assert metrics == loop.metrics_from_ranks(ranks)

    class Writer:
        def embedding(self, *args, **kwargs):
            raise AssertionError("no embedding dump for SAFA")

    loop.dump_val_embeddings(tp, params, batches, Writer(), 0)
