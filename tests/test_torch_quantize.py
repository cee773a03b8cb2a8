"""The port's static-int8 serving path (witw_tpu_torch.models.quantize and
the plain versions of its three kernels) against witw_tpu on the CPU.

Inputs come from numpy ``default_rng``; the towers are flax inits moved
into the port with ``convert_jax``. Each test states its tolerance. Given
the same tables, the int8 towers are exact: both sides accumulate in int32
and round the same f32 products half to even.

witw_tpu's static forward runs under ``jax.jit``, as its serving path runs
it: op-by-op dispatch on XLA:CPU compiles every op of every new shape and
takes several times as long.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.configs import (
    DataConfig, DatasetConfig, EvalConfig, ExperimentConfig, FovDsmModelConfig,
    OptimConfig, TrainConfig, dataset_config,
)
from witw_tpu.models import FovDsm as JaxFovDsm
from witw_tpu.models import quantize as jq
from witw_tpu.ops.polar import polar_grid
from witw_tpu.train.pipeline import make_pipeline
from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator
from witw_tpu_torch.models import quantize as tq
from witw_tpu_torch.models.backbones.vgg16 import wrap_pad_width
from witw_tpu_torch.models.convert_jax import tower_to_state_dict
from witw_tpu_torch.models.fov_dsm import FovDsm
from witw_tpu_torch.ops import fused_block2, int8_conv, maxpool

F32 = FovDsmModelConfig(compute_dtype="float32")


def _tower(circ, hw=(32, 64), seed=0, cin=3):
    """A flax FovDsm init: (numpy params, port state dict)."""
    model = JaxFovDsm(FovDsmModelConfig(compute_dtype="float32", in_channels=cin),
                      circ_padding=circ)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, cin)))
    params = jax.tree.map(np.asarray, variables["params"])
    return params, tower_to_state_dict(params)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def towers():
    return {circ: _tower(circ) for circ in (False, True)}


@pytest.fixture(scope="module")
def calib(towers):
    """Two calibration batches [2, 32, 64, 3] and witw_tpu's scales of each
    tower on them."""
    rng = np.random.default_rng(7)
    batches = [_normal(rng, 2, 32, 64, 3) for _ in range(2)]
    return batches, {circ: jq.calibrate_fov_activation_scales(towers[circ][0], batches, circ)
                     for circ in (False, True)}


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_forward(sq, x, circ, x_quantized):
    """witw_tpu's static forward and its saturation list [(hits, size)]."""
    sats = []
    y = jq.quantized_fov_forward_static(sq, x, circ, x_quantized=x_quantized,
                                        saturation_out=sats)
    return y, sats


@pytest.mark.parametrize("circ", [False, True])
def test_prepare_static_qparams_matches_jax(towers, calib, circ):
    """Given witw_tpu's scales, every table is array_equal to witw_tpu's,
    kernel_packed is kernel_q as [Co, 3, 3, Cin_p] with zero channels, and
    kernel_wgmma is kernel A's table of kernel_q (unpack_weights_wgmma gives
    it back)."""
    params, sd = towers[circ]
    scales = calib[1][circ]
    want = jq.prepare_static_qparams(params, scales)
    got = tq.prepare_static_qparams(sd, scales)
    assert got["input_scale"] == want["input_scale"]
    assert got["input_scale"].dtype == np.float32
    for name in tq.CONV_ORDER:
        g = got["vgg"][name] if name in tq.TRUNK_ORDER else got[name]
        w = want["vgg"][name] if name in tq.TRUNK_ORDER else want[name]
        assert set(g) == set(w) | {"kernel_packed", "kernel_wgmma"}
        for key in w:
            assert g[key].dtype == w[key].dtype, (name, key)
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name}.{key}")
        kq = w["kernel_q"]
        cin, co = kq.shape[2:]
        packed = g["kernel_packed"]
        assert packed.shape == (co, 3, 3, (cin + 3) // 4 * 4) and packed.dtype == np.int8
        np.testing.assert_array_equal(packed[..., :cin], np.transpose(kq, (3, 0, 1, 2)))
        assert not packed[..., cin:].any()
        table = g["kernel_wgmma"]
        n = int8_conv.tile_n(co)
        assert table.dtype == np.int8
        assert table.shape == (-(-co // n), 9 * int8_conv.wgmma_channels(cin) * n)
        np.testing.assert_array_equal(int8_conv.unpack_weights_wgmma(table, cin, co), kq)


@pytest.mark.parametrize("circ", [False, True])
def test_calibration_matches_jax(towers, calib, circ):
    """Scales within rtol 1e-3 of witw_tpu's (the f32 towers' bound: XLA:CPU
    convs round differently), and the last head scale * 127 equal to the
    abs-max of the port's own f32 FovDsm output at rtol 1e-6 (the guard
    against the calibration forward drifting from the tower)."""
    _, sd = towers[circ]
    batches, want = calib[0], calib[1][circ]
    got = tq.calibrate_fov_activation_scales(sd, batches, circ)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    model = FovDsm(F32, circ_padding=circ).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        out = torch.cat([model(torch.from_numpy(x)) for x in batches])
    last = tq.HEAD_CONVS[-1][0]
    np.testing.assert_allclose(got[last] * 127.0, float(out.abs().max()), rtol=1e-6)
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate_fov_activation_scales(sd, [], circ)


def _jax_tables(params, scales):
    return jax.tree.map(jnp.asarray, jq.prepare_static_qparams(params, scales))


@pytest.mark.parametrize("hw,circ,x_quantized", [
    ((32, 64), False, False),
    ((32, 64), True, False),
    ((32, 64), False, True),
    ((32, 64), True, True),
    # Odd pooled dims: block 2 meets 21 x 35 and pool 3 meets 10 x 17 (the
    # zero-padded block 2 at odd dims is test_block2_plain_matches_jax's).
    ((42, 70), True, False),
])
def test_static_forward_matches_jax(rng, monkeypatch, towers, calib, hw, circ, x_quantized):
    """Given witw_tpu's tables and the same input, embeddings within atol
    1e-6 and equal saturation counts, with block 2 fused (no saturation
    list) and unfused (with one); on CPU tensors no kernel launches."""
    for mod in (int8_conv, maxpool, fused_block2):
        monkeypatch.setattr(mod, "launches", 0)
    params, sd = towers[circ]  # conv params and scales do not depend on the geometry
    x = _normal(rng, 2, *hw, 3)
    scales = calib[1][circ]
    sq_j = _jax_tables(params, scales)
    sq_t = tq.static_qparams_to_device(tq.prepare_static_qparams(sd, scales), "cpu")
    if x_quantized:
        xin = np.asarray(jq.quantize_input(jnp.asarray(x), sq_j["input_scale"]))
    else:
        xin = x
    xin = np.array(xin)  # writable, for torch.from_numpy
    want, sats_j = _jax_forward(sq_j, jnp.asarray(xin), circ, x_quantized)
    want = np.asarray(want)
    got = tq.quantized_fov_forward_static(sq_t, torch.from_numpy(xin), circ,
                                          x_quantized=x_quantized)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    sats_t = []
    got_sat = tq.quantized_fov_forward_static(sq_t, torch.from_numpy(xin), circ,
                                              x_quantized=x_quantized, saturation_out=sats_t)
    np.testing.assert_array_equal(got_sat.numpy(), got.numpy())
    assert [(int(h), t) for h, t in sats_t] == [(int(h), int(t)) for h, t in sats_j]
    assert sum(int(h) for h, _ in sats_t) > 0  # held-out data clips somewhere
    assert int8_conv.launches == maxpool.launches == fused_block2.launches == 0


def test_check_saturation(rng, towers, calib):
    """static_int8_saturation is the clip fraction of witw_tpu's forward
    (exact, same tables; witw_tpu's static_int8_saturation divides the same
    sums); check_saturation warns above SATURATION_WARN_FRACTION."""
    params, sd = towers[True]
    batches, scales = calib[0], calib[1][True]
    sq_t = tq.static_qparams_to_device(tq.prepare_static_qparams(sd, scales), "cpu")
    hot = 3.0 * _normal(rng, 2, 32, 64, 3)
    _, sats = _jax_forward(_jax_tables(params, scales), jnp.asarray(hot), True, False)
    want = sum(int(h) for h, _ in sats) / sum(int(t) for _, t in sats)
    with pytest.warns(UserWarning, match="saturation"):
        got = tq.check_saturation(sq_t, torch.from_numpy(hot))
    assert got == want and got > tq.SATURATION_WARN_FRACTION
    assert tq.SATURATION_WARN_FRACTION == jq.SATURATION_WARN_FRACTION
    assert tq.static_int8_saturation(sq_t, torch.from_numpy(batches[0]), True) < 0.01


def _preprocess_case(rng, semantic, fov):
    if semantic:
        ds, c = dataset_config("witw", semantic=True), 5
        extra = dict(channels=5, img_mean=(0.485, 0.456, 0.406, 0.5, 0.5),
                     img_std=(0.229, 0.224, 0.225, 0.5, 0.5))
    else:
        ds, c = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True), 3
        extra = {}
    cfg = ExperimentConfig(
        data=DataConfig(dataset=ds, surface_height=32, surface_width_max=64,
                        overhead_size=64, fov=fov, random_orientation=False, **extra),
        model=FovDsmModelConfig(compute_dtype="float32", in_channels=c),
        train=TrainConfig(batch_size=4, optim=OptimConfig(learning_rate=1e-4)),
        eval=EvalConfig(query_block=4),
    )
    batch = {
        "surface": rng.uniform(0, 255, (4, 32, 64, c)).astype(np.float32),
        "overhead": rng.uniform(0, 255, (4, 64, 64, c)).astype(np.float32),
    }
    if semantic:  # mask channels arrive already in [0, 1]
        batch["surface"][..., 3:] /= 255.0
        batch["overhead"][..., 3:] /= 255.0
    return cfg, batch


@pytest.mark.parametrize("semantic,fov", [(False, 360), (False, 90), (True, 360)])
def test_preprocess_static_int8_matches_jax(rng, semantic, fov):
    """int8-first preprocessing against witw_tpu's with the same input
    scales: the surface exact; the polar within 1 LSB and equal on >= 99.9%
    of elements (the 4-corner blend sums in another order); exact zeros
    where the polar weights vanish (wsum == 0)."""
    cfg, batch = _preprocess_case(rng, semantic, fov)
    preprocess = jax.jit(make_pipeline(cfg)._preprocess, static_argnums=2)
    # The input scales quantize_pipeline_static calibrates: abs-max / 127.
    s_in, p_in = preprocess(batch, jax.random.PRNGKey(0), False)
    sq_s, sq_o = ({"input_scale": np.float32(max(float(jnp.max(jnp.abs(x))), 1e-12) / 127.0)}
                  for x in (s_in, p_in))
    want_s, want_p = jq.preprocess_static_int8(cfg.data, sq_s, sq_o, batch,
                                               jax.random.PRNGKey(0))
    scale = {t: {"input_scale": torch.tensor(sq["input_scale"])}
             for t, sq in (("s", sq_s), ("o", sq_o))}
    got_s, got_p = tq.preprocess_static_int8(cfg.data, scale["s"], scale["o"], batch)
    assert got_s.dtype == got_p.dtype == torch.int8
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    diff = np.abs(got_p.numpy().astype(np.int32) - np.asarray(want_p, np.int32))
    assert got_p.shape == want_p.shape and diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    wsum = polar_grid(32, 64, 64).wsum
    assert (wsum == 0).any() and not got_p.numpy()[:, wsum == 0].any()


def test_preprocess_static_int8_is_seeded(rng):
    """The crop origins come from the generator when random_orientation is
    on: the same seed gives the same surface, exactly. The polar transform
    takes int8 tiles only."""
    cfg, batch = _preprocess_case(rng, False, 90)
    data = dataclasses.replace(cfg.data, random_orientation=True)
    sq = {"input_scale": torch.tensor(np.float32(0.02))}
    a, _ = tq.preprocess_static_int8(data, sq, sq, batch, torch.Generator().manual_seed(5))
    b, _ = tq.preprocess_static_int8(data, sq, sq, batch, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (4, 32, 16, 3)
    with pytest.raises(ValueError):
        tq.polar_transform_static_int8(torch.zeros(1, 8, 8, 3), 4, 8)


def test_static_int8_rank_agreement(rng):
    """Retrieval ranks of the port's int8 towers agree with the port's f32
    towers on planted data: top-1 recall within one item (the contract of
    tests/test_quantize.py:124), through quantize_pipeline_static."""
    n = 12
    surf = _normal(rng, n, 32, 64, 3)
    over = surf + 0.1 * _normal(rng, n, 32, 64, 3)
    params = {"surface": _tower(False, seed=0)[1], "overhead": _tower(True, seed=1)[1]}
    f32 = {}
    for t, circ, x in (("surface", False, surf), ("overhead", True, over)):
        model = FovDsm(F32, circ_padding=circ).eval()
        model.load_state_dict(params[t])
        with torch.no_grad():
            f32[t] = model(torch.from_numpy(x))
    sq_s, sq_o = tq.quantize_pipeline_static(params, [(surf, over)])
    s_q = tq.quantized_fov_forward_static(sq_s, torch.from_numpy(surf), False)
    o_q = tq.quantized_fov_forward_static(sq_o, torch.from_numpy(over), True)
    ev = FovGalleryEvaluator(query_block=4, gallery_chunk=4)
    r_f32 = ev.ranks(f32["overhead"], f32["surface"])
    r_q = ev.ranks(o_q, s_q)
    assert abs(int(np.sum(r_f32 <= 1)) - int(np.sum(r_q <= 1))) <= 1
    for a, b in ((s_q, f32["surface"]), (o_q, f32["overhead"])):
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        assert cos > 0.99, cos


def _int8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _jax_acc(x, k, stride_h, pad_w):
    return jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride_h, 1), ((1, 1), (pad_w, pad_w)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)


@pytest.mark.parametrize("cin,stride_h,pad_w", [
    (3, 1, 1), (3, 2, 0), (5, 1, 0), (5, 2, 1), (64, 2, 1), (64, 1, 0),
])
def test_conv_plain_matches_jax(rng, cin, stride_h, pad_w):
    """conv3x3_int8's plain version against conv_general_dilated(int32) +
    bias_q + _requant (array_equal, ReLU folded and not), and the dequant
    epilogue against float(acc) * dequant + bias_f (atol 1e-6)."""
    co = 16
    x = _int8(rng, 2, 9, 11, cin)
    k = _int8(rng, 3, 3, cin, co)
    bias_q = rng.integers(-3000, 3000, co).astype(np.int32)
    m = rng.uniform(1e-4, 3e-3, co).astype(np.float32)
    bias_f = _normal(rng, co)
    acc = _jax_acc(x, k, stride_h, pad_w)
    xt, wt = torch.from_numpy(x), torch.from_numpy(int8_conv.pack_weights(k))
    for relu in (True, False):
        want = np.asarray(jq._requant(acc + jnp.asarray(bias_q), jnp.asarray(m), relu))
        got = int8_conv.conv3x3_int8(xt, wt, torch.from_numpy(bias_q), torch.from_numpy(m),
                                     stride_h, pad_w, relu)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(acc.astype(jnp.float32) * jnp.asarray(m) + jnp.asarray(bias_f))
    got = int8_conv.conv3x3_int8_dequant(xt, wt, torch.from_numpy(m), torch.from_numpy(bias_f),
                                         stride_h, pad_w)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        int8_conv.conv3x3_int8_acc_plain(xt, wt, stride_h, pad_w).numpy(), np.asarray(acc))


@pytest.mark.parametrize("dtype", [np.int8, np.float32, "bfloat16"])
def test_maxpool_plain_matches_reduce_window(rng, dtype):
    """maxpool2x2's plain version against reduce_window VALID max at odd and
    even dims (array_equal: a max rounds nothing)."""
    for h, w in [(5, 7), (6, 5), (8, 8), (1, 3)]:
        if dtype == np.int8:
            x = _int8(rng, 2, h, w, 6)
            xj, xt, init = jnp.asarray(x), torch.from_numpy(x), jnp.int8(-128)
        else:
            x = _normal(rng, 2, h, w, 6)
            xj, xt, init = jnp.asarray(x), torch.from_numpy(x), -jnp.inf
            if dtype == "bfloat16":
                xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
        want = jax.lax.reduce_window(xj, init, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
        got = maxpool.maxpool2x2(xt)
        assert got.dtype == xt.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _jax_block2(x, w1, b1, m1, w2, b2, m2, circ):
    """Block 2 as witw_tpu's static forward computes it."""
    h = jnp.asarray(x)
    if circ:
        h = jnp.pad(h, ((0, 0), (0, 0), (2, 2), (0, 0)), mode="wrap")
    pad_w = 0 if circ else 1
    for k, b, m in ((w1, b1, m1), (w2, b2, m2)):
        h = jq._requant(_jax_acc(h, k, 1, pad_w) + jnp.asarray(b), jnp.asarray(m), True)
    return np.asarray(jax.lax.reduce_window(
        h, jnp.int8(-127), jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID"))


@pytest.mark.parametrize("circ", [False, True])
@pytest.mark.parametrize("hw", [(6, 10), (7, 9)])
def test_block2_plain_matches_jax(rng, circ, hw):
    """fused_block2's plain version against block 2 of witw_tpu's forward
    (wrap halo of 2 + width-VALID convs when circular), array_equal, at even
    and odd dims."""
    x = np.abs(_int8(rng, 2, *hw, 64))
    w1, w2 = _int8(rng, 3, 3, 64, 128), _int8(rng, 3, 3, 128, 128)
    b1, b2 = (rng.integers(-20000, 20000, 128).astype(np.int32) for _ in range(2))
    m1 = np.full(128, 1.5e-4, np.float32)
    m2 = np.full(128, 2.5e-4, np.float32)
    want = _jax_block2(x, w1, b1, m1, w2, b2, m2, circ)
    t = torch.from_numpy
    got = fused_block2.fused_block2(
        t(x), t(int8_conv.pack_weights(w1)), t(b1), t(m1),
        t(int8_conv.pack_weights(w2)), t(b2), t(m2), circular=circ)
    assert got.shape == want.shape == (2, hw[0] // 2, hw[1] // 2, 128)
    assert 0 < (want > 0).mean() < 1  # the requant clips neither nothing nor everything
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrap_pad_width_matches_jnp_pad(rng):
    """The width wrap halo equal to jnp.pad mode "wrap" on NHWC (dim 2) and
    NCHW (dim -1, channels_last kept), up to a halo of the whole width; a
    wider halo raises."""
    x = _int8(rng, 2, 3, 4, 5)
    with pytest.raises(ValueError):
        wrap_pad_width(torch.from_numpy(x), 5, dim=2)
    for halo in (0, 1, 3, 4):
        want = np.pad(x, ((0, 0), (0, 0), (halo, halo), (0, 0)), mode="wrap")
        np.testing.assert_array_equal(
            wrap_pad_width(torch.from_numpy(x), halo, dim=2).numpy(), want)
        nchw = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last strides
        got = wrap_pad_width(nchw, halo)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
        assert got.is_contiguous(memory_format=torch.channels_last)


# --- the SAFA family's static-int8 towers ------------------------------------


@pytest.fixture(scope="module")
def safa_towers():
    """Port SAFA towers at 32 x 64 (head h·w 32) from a seeded init: {circ:
    (witw_tpu's flax tree, the port's state dict)}, and two calibration
    batches."""
    from witw_tpu_torch.configs.base import SafaModelConfig
    from witw_tpu_torch.models.convert_jax import state_dict_to_tower
    from witw_tpu_torch.models.safa import VggSafa

    out = {}
    for circ in (False, True):
        model = VggSafa(SafaModelConfig(compute_dtype="float32"), (32, 64), circ)
        model.reset_parameters(torch.Generator().manual_seed(3 + circ))
        sd = {k: v.detach() for k, v in model.state_dict().items()}
        out[circ] = (state_dict_to_tower(sd), sd)
    rng = np.random.default_rng(8)
    return out, [_normal(rng, 2, 32, 64, 3) for _ in range(2)]


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_safa_forward(sq, head, x, circ):
    sats = []
    y = jq.quantized_safa_forward_static(sq, head, x, circ, saturation_out=sats)
    return y, sats


@pytest.mark.parametrize("circ", [False, True])
def test_safa_calibration_and_tables_match_jax(safa_towers, monkeypatch, circ):
    """include_head=False: the trunk's scales (input and the ten convs) within
    rtol 1e-3 of witw_tpu's; given witw_tpu's scales quantize_safa_tower_static
    folds array_equal trunk tables and hands over the f32 head unchanged."""
    towers, batches = safa_towers
    tree, sd = towers[circ]
    want = jq.calibrate_fov_activation_scales(tree, batches, circ, include_head=False)
    got = tq.calibrate_fov_activation_scales(sd, batches, circ, include_head=False)
    assert set(got) == set(want) == {"input"} | set(tq.TRUNK_ORDER)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    monkeypatch.setattr(tq, "calibrate_fov_activation_scales", lambda *a, **k: want)
    sq, head = tq.quantize_safa_tower_static(sd, batches, circ)
    sq_j, head_j = jq.prepare_static_qparams(tree, want), tree["safa"]
    assert set(sq["vgg"]) == set(sq_j["vgg"]) == set(tq.TRUNK_ORDER)
    assert float(sq["input_scale"]) == float(sq_j["input_scale"])
    for name, entry in sq_j["vgg"].items():
        for key, value in entry.items():
            np.testing.assert_array_equal(sq["vgg"][name][key].numpy(), value,
                                          err_msg=f"{name}.{key}")
    for key, value in head_j.items():
        np.testing.assert_array_equal(head[key].numpy(), value)


@pytest.mark.parametrize("circ", [False, True])
def test_safa_static_forward_matches_jax(rng, monkeypatch, safa_towers, circ):
    """Given witw_tpu's tables: unit embeddings [2, 8 x 512] within atol 1e-6
    of witw_tpu's quantized_safa_forward_static (conv4_3 dequantized, the
    head in f32), block 2 fused and unfused; equal saturation counts and
    clip fraction (static_int8_saturation_safa); no kernel launches on CPU
    tensors."""
    for mod in (int8_conv, maxpool, fused_block2):
        monkeypatch.setattr(mod, "launches", 0)
    towers, batches = safa_towers
    tree, sd = towers[circ]
    scales = jq.calibrate_fov_activation_scales(tree, batches, circ, include_head=False)
    sq_j = _jax_tables(tree, scales)
    head_j = jax.tree.map(jnp.asarray, tree["safa"])
    monkeypatch.setattr(tq, "calibrate_fov_activation_scales", lambda *a, **k: scales)
    sq_head = tq.quantize_safa_tower_static(sd, batches, circ)
    x = 1.5 * _normal(rng, 2, 32, 64, 3)
    want, sats_j = _jax_safa_forward(sq_j, head_j, jnp.asarray(x), circ)
    want = np.asarray(want)
    got = tq.quantized_safa_forward_static(*sq_head, torch.from_numpy(x), circ)
    assert got.shape == want.shape == (2, 4096) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    sats_t = []
    unfused = tq.quantized_safa_forward_static(*sq_head, torch.from_numpy(x), circ,
                                               saturation_out=sats_t)
    np.testing.assert_array_equal(unfused.numpy(), got.numpy())
    assert [(int(h), t) for h, t in sats_t] == [(int(h), int(t)) for h, t in sats_j]
    assert len(sats_t) == 9  # every trunk conv but conv4_3 requantizes
    frac = tq.static_int8_saturation_safa(sq_head, torch.from_numpy(x), circ)
    assert frac == sum(int(h) for h, _ in sats_j) / sum(int(t) for _, t in sats_j)
    assert int8_conv.launches == maxpool.launches == fused_block2.launches == 0


# --- the baseline family's static-int8 towers ---------------------------------


@pytest.fixture(scope="module")
def baseline_tower():
    """A port baseline tower from a seeded init with running statistics off
    0 / 1: (witw_tpu's {"params", "batch_stats"} variables, the port's state
    dict), and two raw 384² calibration images (the seven VALID stride-2
    convs need 382 px)."""
    from witw_tpu_torch.configs.base import BaselineModelConfig
    from witw_tpu_torch.models.baseline import BaselineEncoder
    from witw_tpu_torch.models.convert_jax import (state_dict_to_tower,
                                                   state_dict_to_tower_stats)

    model = BaselineEncoder(BaselineModelConfig(compute_dtype="float32"))
    gen = torch.Generator().manual_seed(5)
    model.reset_parameters(gen)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=gen)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(sd[k].shape, generator=gen) + 0.5
    variables = {"params": state_dict_to_tower(sd), "batch_stats": state_dict_to_tower_stats(sd)}
    rng = np.random.default_rng(9)
    calib = [rng.uniform(0, 255, (1, 384, 384, 3)).astype(np.float32) for _ in range(2)]
    return variables, sd, calib


def test_baseline_calibration_and_tables_match_jax(baseline_tower, monkeypatch):
    """The input's and six BatchNorm outputs' scales within rtol 1e-3 of
    witw_tpu's calibrate_baseline_scales; given witw_tpu's scales every
    table of quantize_baseline_tower_static is array_equal to witw_tpu's
    (``kernel_mm`` is ``kernel_q`` as [Co, 16 Cin] in (kh, kw, cin) order)."""
    variables, sd, calib = baseline_tower
    want = jq.calibrate_baseline_scales(variables["params"], variables["batch_stats"], calib)
    got = tq.calibrate_baseline_scales(sd, calib)
    assert set(got) == set(want) == {"input", 1, 2, 3, 4, 5, 6}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=str(k))
    monkeypatch.setattr(tq, "calibrate_baseline_scales", lambda *a, **k: want)
    sq = tq.quantize_baseline_tower_static(sd, calib)
    monkeypatch.setattr(jq, "calibrate_baseline_scales", lambda *a, **k: want)
    sq_j = jq.quantize_baseline_tower_static(variables, calib)
    assert float(sq["input_scale"]) == float(sq_j["input_scale"])
    assert len(sq["layers"]) == len(sq_j["layers"]) == 7
    for i, (entry, entry_j) in enumerate(zip(sq["layers"], sq_j["layers"]), 1):
        assert set(entry) == set(entry_j) | {"kernel_mm"}, i
        for key, value in entry_j.items():
            np.testing.assert_array_equal(entry[key].numpy(), np.asarray(value),
                                          err_msg=f"layer {i} {key}")
        kq = np.asarray(entry_j["kernel_q"])
        np.testing.assert_array_equal(entry["kernel_mm"].numpy(),
                                      kq.reshape(-1, kq.shape[3]).T)


def test_baseline_static_forward_matches_jax(rng, baseline_tower, monkeypatch):
    """Given witw_tpu's tables: embeddings [2, 1536] within atol 1e-6 of
    witw_tpu's quantized_baseline_forward_static run op by op (int8 convs as
    im2col + torch._int_mm, conv7's rows padded to the 17 the card's GEMM
    takes), equal saturation counts over the six requants. Not under
    ``jax.jit``: XLA fuses the f32 epilogue (dequant, bias, LeakyReLU,
    BatchNorm affine, requant) with contracted multiply-adds, which moves
    requant roundings at ties and the embeddings by up to 2.3e-3 from
    witw_tpu's own op-by-op forward, which the port equals. And witw_tpu's
    contract against the f32 tower (tests/test_quantize.py:228): cosine >
    0.99 per row, the pseudo-norm within rtol 0.05, saturation < 1%."""
    from witw_tpu_torch.configs.base import BaselineModelConfig
    from witw_tpu_torch.models.baseline import BaselineEncoder

    variables, sd, calib = baseline_tower
    scales = jq.calibrate_baseline_scales(variables["params"], variables["batch_stats"], calib)
    monkeypatch.setattr(tq, "calibrate_baseline_scales", lambda *a, **k: scales)
    monkeypatch.setattr(jq, "calibrate_baseline_scales", lambda *a, **k: scales)
    sq = tq.quantize_baseline_tower_static(sd, calib)
    sq_j = jq.quantize_baseline_tower_static(variables, calib)
    x = np.concatenate([calib[0], rng.uniform(0, 255, (1, 384, 384, 3)).astype(np.float32)])
    sats_j = []
    want = np.asarray(jq.quantized_baseline_forward_static(sq_j, jnp.asarray(x),
                                                           saturation_out=sats_j))
    sats_t = []
    got = tq.quantized_baseline_forward_static(sq, torch.from_numpy(x), saturation_out=sats_t)
    assert got.shape == want.shape == (2, 1536) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert [(int(h), t) for h, t in sats_t] == [(int(h), int(t)) for h, t in sats_j]
    assert len(sats_t) == 6
    frac = tq.static_int8_saturation_baseline(sq, torch.from_numpy(x))
    assert frac == sum(int(h) for h, _ in sats_j) / sum(int(t) for _, t in sats_j) < 0.01

    model = BaselineEncoder(BaselineModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd)
    with torch.no_grad():
        f32 = model(torch.from_numpy(x)).numpy()
    q = got.numpy()
    cos = np.sum(q * f32, 1) / (np.linalg.norm(q, axis=1) * np.linalg.norm(f32, axis=1))
    assert np.all(cos > 0.99), cos
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), np.linalg.norm(f32, axis=1), rtol=0.05)


def test_baseline_int8_conv_im2col_matches_lax(rng):
    """conv4x4s2_int8_acc (strided-view im2col + torch._int_mm) equals
    lax.conv_general_dilated's int32 accumulator, at Cin 3 and 5 (the
    orientation maps' K = 80), odd sizes, and a 1 x 1 output (M = 1,
    padded to 17 rows); a kernel that does not fit raises."""
    for b, h, w, cin, co in ((2, 11, 9, 3, 16), (1, 8, 13, 5, 8), (1, 4, 4, 64, 64)):
        x = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
        k = rng.integers(-127, 128, (4, 4, cin, co), dtype=np.int8)
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), (2, 2), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
        kmm = torch.from_numpy(np.ascontiguousarray(k.reshape(-1, co).T))
        got = tq.conv4x4s2_int8_acc(torch.from_numpy(x), kmm)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="does not fit"):
        tq.conv4x4s2_int8_acc(torch.zeros(1, 8, 8, 3, dtype=torch.int8),
                              torch.zeros(16, 40, dtype=torch.int8))
