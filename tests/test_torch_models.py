"""FOV-DSM towers of the PyTorch port against witw_tpu's flax towers on the
CPU, with shared weights through the bridge (models/convert_jax.py).

Tower tolerance: rtol 1e-3, atol 1e-4 in float32 at small geometry
(32 x 64) -- the bound of the existing torch oracle test
(tests/test_models.py), since XLA:CPU lowers f32 convs at reduced precision.
The bridge round trip must be exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.configs import FovDsmModelConfig
from witw_tpu.models import FovDsm as JaxFovDsm
from witw_tpu_torch.models.convert_jax import (
    jax_params_to_state_dict,
    state_dict_to_jax_params,
    tower_to_state_dict,
)
from witw_tpu_torch.models.fov_dsm import FovDsm

F32 = FovDsmModelConfig(compute_dtype="float32")


def _jax_tower(circ, shape, seed=0, cfg=F32):
    model = JaxFovDsm(cfg, circ_padding=circ)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros(shape))
    return model, jax.tree.map(np.asarray, v["params"])


def _jax_apply(model, params, x):
    return np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))


@pytest.fixture(scope="module")
def jax_towers():
    """Flax towers {circ: (module, numpy params)} at 32 x 64, shared here."""
    return {circ: _jax_tower(circ, (1, 32, 64, 3), seed=int(circ)) for circ in (False, True)}


def _torch_tower(params, circ, cfg=F32):
    model = FovDsm(cfg, circ_padding=circ).eval()
    model.load_state_dict(tower_to_state_dict(params))
    return model


@pytest.mark.parametrize("circ", [False, True])
def test_fov_dsm_matches_jax(rng, circ, jax_towers):
    x = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    jmodel, params = jax_towers[circ]
    want = _jax_apply(jmodel, params, x)
    with torch.no_grad():
        got = _torch_tower(params, circ)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 8, 16)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("circ", [False, True])
def test_bf16_fov_dsm_matches_jax_bf16(rng, circ):
    """The default compute_dtype (bfloat16) tower against the flax bf16
    tower on shared weights, at 32 x 64.

    Tolerance: rtol 2e-2, atol 2e-2 * max|y|. bf16 keeps 8 significant bits
    (unit roundoff 2^-8 = 0.4%), each of the 13 convs rounds its output, and
    the two frameworks sum in different orders, so roundings land on
    neighbouring bf16 values and compound: the spread measured here is under
    1% of the output scale, and outputs near zero carry that error in
    absolute terms. The bound leaves 2x room over it. To show that the port
    rounds as bf16 and does not run in f32, its error must also be smaller
    than that of the flax f32 tower against the flax bf16 one.
    """
    x = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    bf16 = FovDsmModelConfig()
    assert bf16.compute_dtype == "bfloat16"
    jmodel, params = _jax_tower(circ, (1, 32, 64, 3), seed=int(circ), cfg=bf16)
    want = _jax_apply(jmodel, params, x)
    want_f32 = _jax_apply(JaxFovDsm(F32, circ_padding=circ), params, x)
    with torch.no_grad():
        got = _torch_tower(params, circ, bf16)(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)
    assert np.abs(got - want).max() < np.abs(want_f32 - want).max()


def test_fov_dsm_five_channel_matches_jax(rng):
    cfg = FovDsmModelConfig(in_channels=5, train_first_conv=True, compute_dtype="float32")
    x = rng.standard_normal((1, 32, 64, 5)).astype(np.float32)
    jmodel, params = _jax_tower(True, x.shape, cfg=cfg)
    want = _jax_apply(jmodel, params, x)
    with torch.no_grad():
        got = _torch_tower(params, True, cfg)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_bridge_round_trip_is_exact(jax_towers):
    tree = {"surface": jax_towers[False][1], "overhead": jax_towers[True][1]}
    sd = jax_params_to_state_dict(tree)
    assert sd["surface"]["vgg.conv_0.weight"].shape == (64, 3, 3, 3)
    assert sd["overhead"]["conv_27.weight"].shape == (16, 64, 3, 3)
    back = state_dict_to_jax_params(sd)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_state_dict_names_match_the_bridge(jax_towers):
    params = jax_towers[False][1]
    names = set(FovDsm(F32).state_dict())
    assert names == set(tower_to_state_dict(params))
    assert "vgg.conv_21.weight" in names and "conv_23.bias" in names


def test_init_follows_flax_distributions():
    model = FovDsm(FovDsmModelConfig())
    model.reset_parameters(torch.Generator().manual_seed(0))
    w = model.vgg.conv_19.weight.detach()  # lecun_normal, fan_in 512*9
    std = math.sqrt(1.0 / (512 * 9))
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-7
    head = model.conv_23.weight.detach()  # xavier_uniform
    bound = math.sqrt(6.0 / (512 * 9 + 256 * 9))
    assert float(head.abs().max()) <= bound
    assert float(head.abs().max()) > 0.95 * bound
    assert all(float(p.detach().abs().max()) == 0.0 for n, p in model.named_parameters()
               if n.endswith("bias"))
    again = FovDsm(FovDsmModelConfig())
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_output_geometry_matches_torch_floor_arithmetic():
    """fov=70 surface (odd width 99): W 99 -> 49 -> 24 -> 12, H 128 -> 4,
    as tests/test_models.py pins for the flax tower."""
    model = FovDsm(F32).eval()
    with torch.no_grad():
        out = model(torch.zeros(1, 128, 99, 3))
    assert out.shape == (1, 4, 12, 16) and out.dtype == torch.float32


def test_bf16_compute_dtype_runs_convs_in_bf16(rng):
    """compute_dtype bfloat16 (the default config) runs the convs in bf16
    and returns f32 maps close to the f32 tower (bf16 keeps ~3 digits)."""
    x = torch.from_numpy(rng.standard_normal((1, 32, 64, 3)).astype(np.float32))
    f32 = FovDsm(F32).eval()
    f32.reset_parameters(torch.Generator().manual_seed(0))
    bf16 = FovDsm(FovDsmModelConfig()).eval()
    bf16.load_state_dict(f32.state_dict())
    assert bf16.vgg.conv_0.dtype == torch.bfloat16
    with torch.no_grad():
        a, b = f32(x), bf16(x)
    assert b.dtype == torch.float32
    scale = float(a.abs().max())
    assert float((a - b).abs().max()) < 0.1 * scale
