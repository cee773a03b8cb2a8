"""The baseline family in the PyTorch port against witw_tpu, on the CPU.

One flax ``BaselinePipeline`` init for the file (the towers' params do not
depend on the input size), its running statistics moved off 0 / 1 by one
train-mode pass, carried into the port with ``models/convert_jax``; inputs
from a numpy seed. The seven VALID stride-2 convs need at least 382 px, so
towers run at 384², batch 2. witw_tpu's convs run at
``conv_precision="highest"`` (XLA:CPU lowers f32 convs at reduced precision
otherwise, and train-mode BatchNorm amplifies that). Tolerances: f32 towers
rtol 2e-4, atol 2e-5; bf16 towers cosine >= 0.999 per row; the rotation's
right angles, quarter turns, shift and orientation maps bit-equal; generic
angles equal but at pixels within 1e-4 of a rounding tie (f32 cos / sin may
differ in the last bit); each other test states its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.configs import BaselineModelConfig as JaxBaselineModelConfig
from witw_tpu.configs import baseline_experiment as jax_baseline_experiment
from witw_tpu.match.losses import exhaustive_minibatch_triplet_loss as jax_loss
from witw_tpu.models.baseline import BaselineEncoder as JaxEncoder
from witw_tpu.models.baseline import TorchBatchNorm
from witw_tpu.ops import orientation_maps as jax_omaps
from witw_tpu.ops import rotation as jax_rotation
from witw_tpu.ops.image import repeat_rows as jax_repeat_rows
from witw_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from witw_tpu.train.pipeline import make_pipeline as jax_make_pipeline
from witw_tpu_torch.configs import baseline_experiment
from witw_tpu_torch.evaluation.gallery import euclidean_ranks
from witw_tpu_torch.match.losses import exhaustive_minibatch_triplet_loss
from witw_tpu_torch.models.baseline import BaselineEncoder, BatchNorm
from witw_tpu_torch.models.convert_jax import (jax_params_to_state_dict, state_dict_to_jax_params,
                                               state_dict_to_jax_variables)
from witw_tpu_torch.ops import orientation_maps, rotation
from witw_tpu_torch.ops.image import repeat_rows
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.pipeline import BaselinePipeline, TrainState, make_pipeline
from witw_tpu_torch.utils.hashing import params_fingerprint

SURFACE_RAW = (192, 384)  # CVUSA rows repeated x2 -> 384 x 384
TILE = 384
LR = 1e-5
STEP_KEYS = (0, 5)


def _cfgs(compute_dtype="float32", dataset="cvusa", lr=LR, **model):
    """witw_tpu's and the port's baseline preset, batch 2, at the given
    compute dtype (witw_tpu's convs at "highest")."""
    cfgs = []
    for make in (jax_baseline_experiment, baseline_experiment):
        cfg = make(dataset)
        cfgs.append(cfg.replace(
            model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype,
                                      conv_precision="highest", **model),
            train=dataclasses.replace(cfg.train, batch_size=2,
                                      optim=dataclasses.replace(cfg.train.optim,
                                                                learning_rate=lr))))
    return cfgs


def _batch(rng, b=2, surface_hw=SURFACE_RAW):
    return {"surface": rng.uniform(0, 255, (b, *surface_hw, 3)).astype(np.float32),
            "overhead": rng.uniform(0, 255, (b, TILE, TILE, 3)).astype(np.float32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_draw(key, b=2):
    """witw_tpu's continuous synced-rotation draw for ``key``."""
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(key), (b,)) * 360.0))


@pytest.fixture(scope="module")
def jax_state():
    """witw_tpu's BaselinePipeline.init, its running statistics moved by one
    train-mode pass of each tower on random 384² inputs."""
    jp = jax_make_pipeline(_cfgs()[0])
    state = jax.jit(lambda r: jp.init(r, surface_hw=SURFACE_RAW, overhead_hw=(TILE, TILE)))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    stats = {}
    for tower, model in (("surface", jp.surface_model), ("overhead", jp.overhead_model)):
        x = jnp.asarray(rng.uniform(0, 255, (2, TILE, TILE, 3)).astype(np.float32))
        _, upd = jax.jit(lambda v, x, m=model: m.apply(v, x, train=True, mutable=["batch_stats"]))(
            {"params": state.params[tower], "batch_stats": state.batch_stats[tower]}, x)
        stats[tower] = upd["batch_stats"]
    return state.replace(batch_stats=stats)


@pytest.fixture(scope="module")
def variables(jax_state):
    """(numpy params, numpy batch_stats, the port's params)."""
    params = jax.tree.map(np.asarray, jax_state.params)
    stats = jax.tree.map(np.asarray, jax_state.batch_stats)
    return params, stats, jax_params_to_state_dict(params, stats)


def test_bridge_carries_baseline_towers_both_ways(variables):
    """params and batch_stats -> the port's state dicts (BatchNorm buffers
    beside the weights, nn.BatchNorm2d's names) -> back, array_equal; the
    fingerprint leaves the buffers out, as witw_tpu's hashes params only."""
    params, stats, sd = variables
    back_params, back_stats = state_dict_to_jax_variables(sd)
    for want, got in ((params, back_params), (stats, back_stats),
                      (params, state_dict_to_jax_params(sd))):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    model = BaselineEncoder(baseline_experiment().model)
    for tower in ("surface", "overhead"):
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in sd[tower].items()}
        np.testing.assert_array_equal(sd[tower]["bn3.weight"].numpy(), params[tower]["bn3"]["scale"])
        np.testing.assert_array_equal(sd[tower]["bn3.running_var"].numpy(),
                                      stats[tower]["bn3"]["var"])
        np.testing.assert_array_equal(sd[tower]["conv2.weight"].numpy(),
                                      np.transpose(params[tower]["conv2"]["kernel"], (3, 2, 0, 1)))
    from witw_tpu.utils.hashing import params_fingerprint as jax_fingerprint

    assert params_fingerprint(sd["overhead"]) == jax_fingerprint(params["overhead"])
    moved = {k: v.clone() for k, v in sd["overhead"].items()}
    moved["bn1.running_mean"] += 1.0
    assert params_fingerprint(moved) == params_fingerprint(sd["overhead"])


def test_flax_baseline_checkpoint_restores(jax_state, variables, tmp_path):
    """A witw_tpu baseline checkpoint (.msgpack) restores into the port's
    BaselinePipeline state: params and the batch_stats as the BatchNorm
    buffers."""
    JaxCheckpointer(str(tmp_path)).save("best", jax_state)
    tp = BaselinePipeline(_cfgs()[1], "cpu")
    want = variables[2]
    zeros = {t: {k: torch.zeros_like(v) for k, v in sd.items()} for t, sd in want.items()}
    state = Checkpointer(str(tmp_path)).restore(
        "best", TrainState(step=0, params=zeros, optimizer=tp.optimizer(zeros)))
    assert state.step == int(jax_state.step)
    for tower in ("surface", "overhead"):
        for k, v in want[tower].items():
            assert torch.equal(state.params[tower][k].detach(), v), (tower, k)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_towers_match_jax(rng, variables, compute_dtype):
    """Eval-mode towers on the running statistics, 384², batch 2: f32 within
    rtol 2e-4, atol 2e-5; bf16 cosine >= 0.999 per row."""
    params, stats, sd = variables
    x = rng.uniform(0, 255, (2, TILE, TILE, 3)).astype(np.float32)
    jcfg = JaxBaselineModelConfig(compute_dtype=compute_dtype, conv_precision="highest")
    jm = JaxEncoder(jcfg)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params["overhead"], "batch_stats": stats["overhead"]}, jnp.asarray(x)),
        np.float32)
    tm = BaselineEncoder(dataclasses.replace(baseline_experiment().model,
                                             compute_dtype=compute_dtype))
    tm.load_state_dict(sd["overhead"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1536) and got.dtype == np.float32
    if compute_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
        assert np.all(cos >= 0.999), cos
    # the buffers are read, not written, in eval mode
    assert torch.equal(tm.state_dict()["bn2.running_mean"], sd["overhead"]["bn2.running_mean"])


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_matches_jax(rng, masked):
    """Train-mode BatchNorm against TorchBatchNorm: outputs within rtol 1e-5,
    atol 1e-5, the updated running mean and variance (Bessel-corrected)
    within rtol 1e-5, atol 1e-6; with ``valid`` masking two padded rows
    (filled with large values, which must not reach the statistics)."""
    x = (rng.standard_normal((5, 6, 7, 8)) * 3.0 + 1.0).astype(np.float32)  # NHWC
    valid = np.array([True, True, False, True, False]) if masked else None
    if masked:
        x[~valid] = 1e3
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    mean0 = rng.standard_normal(8).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    bn = TorchBatchNorm(momentum=0.1)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                         mask=None if valid is None else jnp.asarray(valid)[:, None, None, None],
                         mutable=["batch_stats"])
    tb = BatchNorm(8, momentum=0.1)
    tb.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0.copy()),
                        "running_var": torch.from_numpy(var0.copy())})
    mask = None if valid is None else torch.from_numpy(valid)
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2), True, mask,
                 None if valid is None else int(valid.sum())).permute(0, 2, 3, 1)
    rows = slice(None) if valid is None else valid
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], rtol=1e-5, atol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tb, ours).numpy(),
                                   np.asarray(upd["batch_stats"][theirs]), rtol=1e-5, atol=1e-6)
    assert not np.allclose(tb.running_var.numpy(), var0)
    with torch.no_grad():  # eval mode reads the updated buffers
        ev = tb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want_ev = bn.apply({"params": variables["params"], "batch_stats": upd["batch_stats"]},
                       jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(ev.numpy(), np.asarray(want_ev), rtol=1e-5, atol=1e-5)


def test_batchnorm_batch_of_one_raises():
    """n = 1 value per channel: torch raises, witw_tpu would store inf in
    the running variance; the port raises a ValueError and leaves the
    buffers alone."""
    tb = BatchNorm(4)
    with pytest.raises(ValueError, match="more than one value"):
        tb(torch.ones(1, 4, 1, 1), train=True)
    with pytest.raises(ValueError, match="more than one value"):
        tb(torch.ones(3, 4, 1, 1), True, torch.tensor([False, True, False]), 1)
    assert torch.equal(tb.running_var, torch.ones(4))
    model = BaselineEncoder(baseline_experiment().model)
    with pytest.raises(ValueError, match="more than one value"):  # a WITW 500² photo: conv7 1 x 1
        model(torch.zeros(1, 500, 500, 3), train=True)


@pytest.mark.parametrize("factor", [0, 1, 2, 3, 5])
def test_quantized_rotation_bit_equal(rng, factor):
    img = rng.uniform(0, 255, (2, 6, 6, 3)).astype(np.float32)
    for x in (img, img[0]):
        want = np.asarray(jax_rotation.quantized_rotation(jnp.asarray(x), factor))
        np.testing.assert_array_equal(rotation.quantized_rotation(torch.from_numpy(x), factor).numpy(),
                                      want)


@pytest.mark.parametrize("hw", [(48, 48), (37, 52)])
def test_rotate_nearest_right_angles_bit_equal(rng, hw):
    """0, 90, 180 and 270 degrees, per sample and scalar, HWC and NHWC."""
    img = rng.uniform(0, 255, (4, *hw, 3)).astype(np.float32)
    deg = np.array([0.0, 90.0, 180.0, 270.0], np.float32)
    want = np.asarray(jax.jit(jax_rotation.rotate_nearest)(jnp.asarray(img), jnp.asarray(deg)))
    got = rotation.rotate_nearest(torch.from_numpy(img), torch.from_numpy(deg)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        rotation.rotate_nearest(torch.from_numpy(img[1]), 90.0).numpy(),
        np.asarray(jax_rotation.rotate_nearest(jnp.asarray(img[1]), 90.0)))


def test_rotate_nearest_generic_angles_tie_rule(rng):
    """16 angles from witw_tpu's draw on 384² tiles: every pixel that differs
    from witw_tpu's (jitted, as its pipeline runs it) samples a source
    coordinate within 1e-4 of a rounding tie, and differing pixels are rare
    (here 5 of 2.4 million; at most 1e-4 of them allowed)."""
    b, s = 16, TILE
    img = rng.uniform(1, 255, (b, s, s, 3)).astype(np.float32)
    deg = _jax_draw(3, b)
    want = np.asarray(jax.jit(jax_rotation.rotate_nearest)(jnp.asarray(img), jnp.asarray(deg.numpy())))
    got = rotation.rotate_nearest(torch.from_numpy(img), deg).numpy()
    differ = np.argwhere((got != want).any(-1))
    assert len(differ) <= 1e-4 * b * s * s, len(differ)
    theta = deg.numpy().astype(np.float64) * np.pi / 180.0
    c = (s - 1) / 2.0
    for n, i, j in differ:
        sx = np.cos(theta[n]) * (j - c) - np.sin(theta[n]) * (i - c) + c
        sy = np.sin(theta[n]) * (j - c) + np.cos(theta[n]) * (i - c) + c
        tie = min(abs(abs(sx - np.floor(sx)) - 0.5), abs(abs(sy - np.floor(sy)) - 0.5))
        assert tie < 1e-4, (n, i, j, sx, sy)
    print(f"{len(differ)} of {b * s * s} pixels differ, each at a rounding tie")


def test_horizontal_shift_and_orientation_maps_bit_equal(rng):
    """The panorama roll per sample and with a scalar angle (half to even
    at exact half-column shifts), repeat_rows, and both orientation maps,
    array_equal to witw_tpu's."""
    img = rng.uniform(0, 255, (5, 4, 40, 3)).astype(np.float32)
    deg = np.array([0.0, 4.5, 13.5, 200.0, 359.9], np.float32)  # 0.5 and 1.5 columns: ties
    want = np.asarray(jax_rotation.horizontal_shift(jnp.asarray(img), jnp.asarray(deg)))
    np.testing.assert_array_equal(
        rotation.horizontal_shift(torch.from_numpy(img), torch.from_numpy(deg)).numpy(), want)
    np.testing.assert_array_equal(
        rotation.horizontal_shift(torch.from_numpy(img[0]), 27.0).numpy(),
        np.asarray(jax_rotation.horizontal_shift(jnp.asarray(img[0]), 27.0)))
    np.testing.assert_array_equal(repeat_rows(torch.from_numpy(img), 2).numpy(),
                                  np.asarray(jax_repeat_rows(jnp.asarray(img), 2)))
    surface = rng.uniform(0, 255, (2, 12, 20, 3)).astype(np.float32)
    overhead = rng.uniform(0, 255, (2, 16, 16, 3)).astype(np.float32)
    want_s, want_o = jax_omaps.append_orientation_maps(jnp.asarray(surface), jnp.asarray(overhead))
    got_s, got_o = orientation_maps.append_orientation_maps(torch.from_numpy(surface),
                                                            torch.from_numpy(overhead))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    assert got_s.shape == (2, 12, 20, 5)


@pytest.mark.parametrize("quantized", [False, True])
def test_synced_rotation_matches_jax(rng, monkeypatch, quantized):
    """With witw_tpu's draw patched in, the synced rotation of a panorama
    batch (surface rolled, overhead rotated) equals witw_tpu's, bit for bit:
    continuous angles on 48² tiles (no tie at this draw); quarter turns
    sample by sample through the clockwise compositions of witw_tpu's
    ``quantized_rotation``. witw_tpu's own quantized ``synced_rotation``
    turns every tile by factor 3 whatever the draw (its ``lax.switch``
    branches close over the comprehension's last ``k``,
    witw_tpu/ops/rotation.py:135-142); the port turns each by its drawn
    factor, as the reference's loader would, and this test pins both."""
    b = 4
    surface = rng.uniform(0, 255, (b, 8, 64, 3)).astype(np.float32)
    overhead = rng.uniform(0, 255, (b, 48, 48, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want_s, want_o = jax_rotation.synced_rotation(key, jnp.asarray(surface), jnp.asarray(overhead),
                                                  panorama=True, quantized=quantized)
    want_o = np.asarray(want_o)
    if quantized:
        draw = torch.from_numpy(np.array(jax.random.randint(key, (b,), 0, 4))).long()
        assert sorted(set(draw.tolist())) == [0, 1, 2, 3]
        for i in range(b):  # witw_tpu's late-binding switch: factor 3 for all
            np.testing.assert_array_equal(
                want_o[i], np.asarray(jax_rotation.quantized_rotation(jnp.asarray(overhead[i]), 3)))
        want_o = np.stack([np.asarray(jax_rotation.quantized_rotation(jnp.asarray(overhead[i]), f))
                           for i, f in enumerate(draw.tolist())])
    else:
        draw = torch.from_numpy(np.array(jax.random.uniform(key, (b,)) * 360.0))
    monkeypatch.setattr(rotation, "rotation_degrees", lambda g, n, q=False: draw)
    got_s, got_o = rotation.synced_rotation(torch.Generator(), torch.from_numpy(surface),
                                            torch.from_numpy(overhead), True, quantized)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(3)
    draw = rotation.rotation_degrees(gen, 1000, quantized)
    lo, hi = (0, 3) if quantized else (0.0, 360.0)
    assert float(draw.min()) >= lo and float(draw.max()) <= hi and len(set(draw.tolist())) > 3


@pytest.mark.parametrize("soft_margin", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_exhaustive_loss_matches_jax(rng, soft_margin, masked):
    """Soft and hard margins, with and without a valid mask, rtol 1e-5; the
    soft form stays finite where log(1 + exp(x)) overflows (embeddings
    scaled to give alpha x delta past 88)."""
    e1 = rng.standard_normal((6, 32)).astype(np.float32)
    e2 = (e1 + 0.5 * rng.standard_normal((6, 32))).astype(np.float32)
    valid = np.array([True, True, True, False, True, False]) if masked else None
    for scale in (1.0, 8.0):
        kw = dict(soft_margin=soft_margin, alpha=10.0, margin=1.0)
        want = float(jax_loss(jnp.asarray(e1 * scale), jnp.asarray(e2 * scale), **kw,
                              valid=None if valid is None else jnp.asarray(valid)))
        got = float(exhaustive_minibatch_triplet_loss(
            torch.from_numpy(e1 * scale), torch.from_numpy(e2 * scale), **kw,
            valid=None if valid is None else torch.from_numpy(valid)))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    if masked:  # the mask equals dropping the rows
        got = exhaustive_minibatch_triplet_loss(torch.from_numpy(e1), torch.from_numpy(e2),
                                                soft_margin, valid=torch.from_numpy(valid))
        dropped = exhaustive_minibatch_triplet_loss(torch.from_numpy(e1[valid]),
                                                    torch.from_numpy(e2[valid]), soft_margin)
        np.testing.assert_allclose(float(got), float(dropped), rtol=1e-6)


def test_train_steps_match_jax(rng, jax_state, variables, monkeypatch):
    """Two train steps from the same flax variables and CVUSA batch (192 x
    384 panoramas, rows repeated on the device; 384² tiles), witw_tpu's
    rotation draws patched in (keys 0 and 5, whose rotations are bit-equal:
    a tie pixel turns into a 28% change of an embedding here, BatchNorm at
    conv7's 1 x 1 output normalizing 2 values). Losses within rtol 2e-3;
    the running statistics within rtol 2e-3, atol 2e-4 max|stat|; the
    params moved as witw_tpu moved them: per tower, over all trainable
    elements, cosine > 0.995 and 99% within 0.05|d| + 0.2 lr, every one
    within 2.05 lr a step (Adam's first steps move each element by about lr,
    a bias-corrected second step a little more, and elements whose gradient
    is within roundoff of 0 take either sign).
    Every weight trains and no buffer does."""
    jcfg, tcfg = _cfgs()
    batch = _batch(rng)
    jp = jax_make_pipeline(jcfg)
    jstate = jax.tree.map(jnp.array, jax_state)  # train_step donates its state
    tp = BaselinePipeline(tcfg, "cpu")
    for key in STEP_KEYS:  # the draws rotate equally in both packages
        pre_j = jax.jit(lambda b, k: jp._preprocess(b, k, True))(_jnp(batch),
                                                                  jax.random.PRNGKey(key))
        monkeypatch.setattr(rotation, "rotation_degrees", lambda g, n, q=False, k=key: _jax_draw(k))
        pre_t = tp.preprocess(batch)
        for a, b in zip(pre_t, pre_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pre_t[0].shape == (2, 384, 384, 3)

    jax_losses = []
    for key in STEP_KEYS:
        jstate, metrics = jp.train_step(jstate, _jnp(batch), jax.random.PRNGKey(key))
        jax_losses.append(float(metrics["loss"]))
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params),
                                    jax.tree.map(np.asarray, jstate.batch_stats))

    params, start = variables[2], {t: {k: v.clone() for k, v in sd.items()}
                                   for t, sd in variables[2].items()}
    params = {t: {k: v.clone() for k, v in sd.items()} for t, sd in params.items()}
    state = TrainState(step=0, params=params, optimizer=tp.optimizer(params))
    draws = iter(_jax_draw(k) for k in STEP_KEYS)
    monkeypatch.setattr(rotation, "rotation_degrees", lambda g, n, q=False: next(draws))
    torch_losses = []
    for _ in STEP_KEYS:
        state, metrics = tp.train_step(state, batch, torch.Generator().manual_seed(0))
        torch_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(torch_losses, jax_losses, rtol=2e-3)
    assert state.step == 2

    for tower in ("surface", "overhead"):
        trainable = set(tp.trainable_names(start[tower]))
        assert len(trainable) == 28 and not any("running" in n for n in trainable)
        dts, djs = [], []
        for name, p0 in start[tower].items():
            got = state.params[tower][name].detach()
            if name not in trainable:  # the running statistics, updated in place
                w = want[tower][name]
                assert not torch.equal(got, p0), name
                np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=2e-3,
                                           atol=2e-4 * float(w.abs().max()))
                continue
            dts.append((got - p0).numpy().ravel())
            djs.append((want[tower][name] - p0).numpy().ravel())
        dt, dj = np.concatenate(dts), np.concatenate(djs)
        cos = float(dt @ dj / (np.linalg.norm(dt) * np.linalg.norm(dj)))
        close = float(np.mean(np.abs(dj - dt) <= 0.05 * np.abs(dt) + 0.2 * LR))
        assert cos > 0.995 and close > 0.99, (tower, cos, close)
        assert np.abs(dj - dt).max() <= 2.05 * LR * len(STEP_KEYS), tower


def test_make_pipeline_and_the_loop_take_baseline(rng, jax_state, variables, monkeypatch):
    """make_pipeline gives a BaselinePipeline (the card by default, here a
    RuntimeError); embed_step with witw_tpu's draw (key 0, no tie) equals
    witw_tpu's embed_step (f32 rtol 2e-4, atol 2e-5; WITW: no row repeat,
    no roll);
    loop.test_ranks ranks by euclidean_ranks with the rotation drawn from a
    generator seeded seed + 1, without touching the running statistics."""
    jcfg, tcfg = _cfgs(dataset="witw")
    tp = make_pipeline(tcfg, "cpu")
    assert isinstance(tp, BaselinePipeline) and not tp.repeat_surface_rows
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_pipeline(tcfg)
    params = variables[2]
    batch = _batch(rng, 2, (TILE, TILE))
    jp = jax_make_pipeline(jcfg)
    js, jo = jp.embed_step(jax_state, _jnp(batch), jax.random.PRNGKey(STEP_KEYS[0]))
    monkeypatch.setattr(rotation, "rotation_degrees", lambda g, n, q=False: _jax_draw(STEP_KEYS[0]))
    pre_j = jax.jit(lambda b, k: jp._preprocess(b, k, False))(_jnp(batch),
                                                               jax.random.PRNGKey(STEP_KEYS[0]))
    for a, b in zip(tp.preprocess(batch), pre_j):  # no tie at this draw
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts, to = tp.embed_step(params, batch)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-5)
    monkeypatch.undo()

    before = {k: v.clone() for k, v in params["overhead"].items()}
    batches = [_batch(rng, 2, (TILE, TILE)), _batch(rng, 1, (TILE, TILE))]
    metrics, ranks = loop.test_ranks(tcfg, tp, batches, params, verbose=False)
    s_emb, o_emb = loop.embed_all(tp, params, batches,
                                  torch.Generator().manual_seed(tcfg.train.seed + 1))
    assert s_emb.shape == o_emb.shape == (3, 1536)
    np.testing.assert_array_equal(ranks, euclidean_ranks(o_emb, s_emb))
    assert metrics == loop.metrics_from_ranks(ranks)
    assert all(torch.equal(before[k], params["overhead"][k]) for k in before)
