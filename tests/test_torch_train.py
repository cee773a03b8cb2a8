"""FOV-DSM training in the PyTorch port against witw_tpu, on the CPU.

- Four train steps of the port's ``FovPipeline.train_step`` against
  witw_tpu's, as tests/test_train_parity.py runs them: f32 towers, dropout
  0, ``random_orientation=False``, the same numpy inputs and flax init
  through ``models/convert_jax``. Losses within rtol 1e-3, atol 1e-5 (the
  f32 towers' cross-framework bound, carried through four Adam steps);
  trainable params moved as witw_tpu moved them, within the Adam-noise
  tolerance of tests/test_train_parity.py (``_assert_delta_close``); frozen
  params bit-unchanged.
- ``dsm_triplet_loss`` with and without the valid mask against witw_tpu's.
- The trainable mask, the frozen prefix's gradient stop, the device default.
- Checkpoints: two epochs straight equal, bit for bit, one epoch, a stop and
  a resume; ``best`` follows the val loss.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.configs import (
    DataConfig,
    DatasetConfig,
    ExperimentConfig,
    FovDsmModelConfig,
    OptimConfig,
    TrainConfig,
)
from witw_tpu.match.losses import dsm_triplet_loss as jax_loss
from witw_tpu.models.fov_dsm import fov_dsm_trainable_mask as jax_mask
from witw_tpu.train.pipeline import FovPipeline as JaxPipeline
from witw_tpu_torch.match.losses import dsm_triplet_loss
from witw_tpu_torch.models.convert_jax import jax_params_to_state_dict
from witw_tpu_torch.models.fov_dsm import FovDsm, fov_dsm_trainable_mask
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.pipeline import FovPipeline, TrainState

LR = 1e-5
N_STEPS = 4


def _cfg(dropout=0.0, random_orientation=False, **train):
    ds = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True)
    return ExperimentConfig(
        data=DataConfig(dataset=ds, surface_height=32, surface_width_max=64, overhead_size=32,
                        fov=360, random_orientation=random_orientation),
        model=FovDsmModelConfig(compute_dtype="float32", dropout_rate=dropout),
        train=TrainConfig(batch_size=4, optim=OptimConfig(learning_rate=LR), **train),
    )


def _batch(rng, b=4):
    return {"surface": rng.uniform(0, 255, (b, 32, 64, 3)).astype(np.float32),
            "overhead": rng.uniform(0, 255, (b, 32, 32, 3)).astype(np.float32)}


def _assert_delta_close(dj, dt, name, min_frac, min_cos):
    """As tests/test_train_parity.py: a share ``min_frac`` of elements within
    5% rel + 0.2 lr abs (Adam's sign flips on ~0 gradients), a direction
    cosine above ``min_cos``, and every element within the Adam step-size
    ceiling."""
    close = np.abs(dj - dt) <= 0.05 * np.abs(dt) + 0.2 * LR
    assert np.mean(close) > min_frac, (name, float(np.mean(close)))
    cos = float(np.sum(dj * dt) / max(np.linalg.norm(dj) * np.linalg.norm(dt), 1e-30))
    assert cos > min_cos, (name, cos)
    assert np.max(np.abs(dj - dt)) <= 2 * LR * N_STEPS + 1e-9, name


@pytest.mark.parametrize("inputs,min_frac,min_cos", [
    ("raw", 0.98, 0.999),
    ("preprocessed", 0.995, 0.9995),
])
def test_train_steps_match_jax(rng, monkeypatch, inputs, min_frac, min_cos):
    """``raw``: the whole step from the same raw batch. The port's polar
    transform agrees with witw_tpu's to ~1e-5 (tests/test_torch_ops.py), and
    that difference reaches the overhead tower's Adam steps: measured worst
    98.4% of a 64-element bias within the element bound and cosine 0.99947,
    hence gates of 98% and 0.999. ``preprocessed``: both towers take
    witw_tpu's preprocessed inputs, as tests/test_train_parity.py feeds its
    transcription, and the gates are that test's (99.5%, 0.9995)."""
    cfg = _cfg()
    jp = JaxPipeline(cfg)
    jstate = jp.init(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, jstate.params)
    batch = _batch(rng)
    if inputs == "preprocessed":
        pre = jp._preprocess({k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0), train=True)
        pre = tuple(torch.from_numpy(np.array(t)) for t in pre)
        monkeypatch.setattr(FovPipeline, "preprocess", lambda self, b, g=None: pre)

    jax_losses = []
    for step in range(N_STEPS):
        jstate, metrics = jp.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                        jax.random.PRNGKey(step))
        jax_losses.append(float(metrics["loss"]))
    params_j = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))

    tp = FovPipeline(cfg, "cpu")
    params = jax_params_to_state_dict(params0)
    state = TrainState(step=0, params=params, optimizer=tp.optimizer(params))
    torch_losses = []
    for _ in range(N_STEPS):
        state, metrics = tp.train_step(state, batch, torch.Generator().manual_seed(0))
        torch_losses.append(float(metrics["loss"]))
    assert state.step == N_STEPS
    np.testing.assert_allclose(torch_losses, jax_losses, rtol=1e-3, atol=1e-5)

    start = jax_params_to_state_dict(params0)
    for tower in ("surface", "overhead"):
        trainable = set(tp.trainable_names(start[tower]))
        assert len(trainable) == 2 * 6  # conv_17/19/21 and the three head convs
        for name, p0 in start[tower].items():
            got = state.params[tower][name].detach()
            if name not in trainable:
                assert torch.equal(got, p0), (tower, name)
                assert torch.equal(params_j[tower][name], p0), (tower, name)
                continue
            dt = (got - p0).numpy()
            dj = (params_j[tower][name] - p0).numpy()
            assert np.abs(dj).max() > 0 and np.abs(dt).max() > 0, (tower, name)
            _assert_delta_close(dj, dt, f"{tower}/{name}", min_frac, min_cos)


@pytest.mark.parametrize("masked", [False, True])
def test_dsm_triplet_loss_matches_jax(rng, masked):
    d = rng.uniform(0.0, 2.0, (6, 6)).astype(np.float32)
    valid = np.array([True, True, False, True, True, False]) if masked else None
    want = float(jax_loss(jnp.asarray(d), alpha=10.0,
                          valid=None if valid is None else jnp.asarray(valid)))
    got = float(dsm_triplet_loss(torch.from_numpy(d), alpha=10.0,
                                 valid=None if valid is None else torch.from_numpy(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if masked:  # exactly the unpadded batch's loss
        keep = np.flatnonzero(valid)
        sub = float(dsm_triplet_loss(torch.from_numpy(d[np.ix_(keep, keep)]), alpha=10.0))
        np.testing.assert_allclose(got, sub, rtol=1e-6)


@pytest.mark.parametrize("freeze,first", [(True, False), (True, True), (False, False)])
def test_trainable_mask_matches_jax(freeze, first):
    cfg = FovDsmModelConfig(freeze_backbone=freeze, train_first_conv=first)
    names = list(FovDsm(cfg).state_dict())
    tree = {}
    for name in names:  # the flax tree of the same tower
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node["kernel" if leaf == "weight" else "bias"] = np.zeros(1)
    mask = jax_mask(tree, cfg)

    def lookup(name):
        *path, leaf = name.split(".")
        node = mask
        for key in path:
            node = node[key]
        return node["kernel" if leaf == "weight" else "bias"]

    got = fov_dsm_trainable_mask(names, cfg)
    assert got == [n for n in names if lookup(n)]
    assert len(got) == {(True, False): 12, (True, True): 14, (False, False): 26}[freeze, first]


def test_frozen_prefix_stops_the_gradient_at_block_4(rng):
    x = torch.from_numpy(rng.standard_normal((1, 32, 64, 3)).astype(np.float32))
    for first, reaching in ((False, {"vgg.conv_17", "vgg.conv_19", "vgg.conv_21"}),
                            (True, {f"vgg.conv_{i}" for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)})):
        cfg = FovDsmModelConfig(compute_dtype="float32", train_first_conv=first)
        model = FovDsm(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        assert model.vgg.frozen_prefix == (not first)
        model(x, train=True, generator=torch.Generator().manual_seed(1)).sum().backward()
        got = {n.rsplit(".", 1)[0] for n, p in model.named_parameters()
               if n.startswith("vgg.") and p.grad is not None}
        assert got == reaching


def test_pipeline_defaults_to_the_card():
    """Without a device the pipeline and the evaluator's numpy inputs go to
    the card: here, with no GPU, they raise instead of running on the CPU."""
    from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        FovPipeline(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        FovGalleryEvaluator().ranks(np.zeros((2, 1, 4, 2)), np.zeros((2, 1, 4, 2)))
    assert FovPipeline(_cfg(), "cpu").device.type == "cpu"


def _loaders(seed):
    rng = np.random.default_rng(seed)
    train = [_batch(rng, 3) for _ in range(2)]
    val = [_batch(rng, 3)]
    return train, val


def _params_of(state):
    return {t: {k: v.detach().clone() for k, v in p.items()} for t, p in state.params.items()}


def test_resume_is_bitwise_and_best_follows_val_loss(tmp_path):
    """Dropout on and random crops on, so every generator matters."""
    cfg = _cfg(dropout=0.2, random_orientation=True, seed=3)
    train_loader, val_loader = _loaders(0)

    straight = Checkpointer(str(tmp_path / "straight"))
    s2 = loop.train(cfg, FovPipeline(cfg, "cpu"), train_loader, val_loader, num_epochs=2,
                    checkpointer=straight, verbose=False)

    resumed_dir = Checkpointer(str(tmp_path / "resumed"), keep=1)
    s1 = loop.train(cfg, FovPipeline(cfg, "cpu"), train_loader, val_loader, num_epochs=1,
                    checkpointer=resumed_dir, verbose=False)
    assert s1.step == 2 and resumed_dir.meta("latest") == {"epoch": 1, "step": 2}
    r2 = loop.train(cfg, FovPipeline(cfg, "cpu"), train_loader, val_loader, num_epochs=2,
                    checkpointer=Checkpointer(str(tmp_path / "resumed"), keep=1), verbose=False)
    assert s2.step == r2.step == 4
    for tower, p in _params_of(s2).items():
        for k, v in p.items():
            assert torch.equal(v, r2.params[tower][k]), (tower, k)
    assert s2.optimizer.state_dict()["state"].keys() == r2.optimizer.state_dict()["state"].keys()
    for i, st in s2.optimizer.state_dict()["state"].items():
        other = r2.optimizer.state_dict()["state"][i]
        assert all(torch.equal(st[k], other[k]) for k in st)
    assert sorted(f.name for f in (tmp_path / "resumed").glob("step_*")) == \
        ["step_4.json", "step_4.pt"]  # keep=1

    # best: the lower of the two epochs' val losses, and its params
    val_losses = []
    for epoch in range(2):
        state = FovPipeline(cfg, "cpu").init_state(torch.Generator().manual_seed(0))
        straight.restore(f"step_{2 * (epoch + 1)}", state)
        _, v, _ = loop.run_phase(FovPipeline(cfg, "cpu"), state, val_loader,
                                 loop.phase_generator(cfg.train.seed, epoch, "val"),
                                 False, epoch, verbose=False)
        val_losses.append(v)
    best = straight.meta("best")
    assert best["val_loss"] == min(val_losses)
    assert best["step"] == 2 * (1 + int(np.argmin(val_losses)))


def test_checkpoint_restore_equals_saved_and_checks_shapes(tmp_path, rng):
    cfg = _cfg()
    tp = FovPipeline(cfg, "cpu")
    state = tp.init_state(torch.Generator().manual_seed(0))
    state, _ = tp.train_step(state, _batch(rng, 2), torch.Generator().manual_seed(0))
    ck = Checkpointer(str(tmp_path))
    gen = torch.Generator().manual_seed(9)
    ck.save("latest", state, {"epoch": 0}, generators={"train": gen})
    fresh = tp.init_state(torch.Generator().manual_seed(1))
    ck.restore_latest(fresh)
    assert fresh.step == 1
    for tower, p in state.params.items():
        for k, v in p.items():
            assert torch.equal(v, fresh.params[tower][k])
    assert torch.equal(ck.load("latest")["generators"]["train"], gen.get_state())
    other = FovPipeline(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, in_channels=5)), "cpu").init_state(torch.Generator().manual_seed(0))
    with pytest.raises((ValueError, RuntimeError)):
        ck.restore("latest", other)
