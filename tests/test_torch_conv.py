"""The bf16 conv + bias + ReLU of the PyTorch port (witw_tpu_torch/ops/conv3x3)
against the Pallas TPU kernels it replaces, on the CPU.

The plain version (what the wrapper computes on CPU tensors, and what the
CUDA kernel is held against on the card) is run against
``exp/pallas_conv3x3.py``'s two kernels under
``force_tpu_interpret_mode()``, on the same numpy inputs:
- row 2, ``conv3x3_bias_relu`` (NHWC): bit-equal bf16 outputs (both sum the
  f32 products of bf16 inputs, in one conv-shaped contraction);
- row 3, ``conv3x3_bias_relu_cw`` ([B, H, C, W]): within one bf16 ulp, since
  it sums the three dx taps as separate matmuls, so a few f32 sums round
  differently before the cast.
Then the circular form against the towers' block halo, the bf16 towers on
the new route against the flax bf16 towers, the autograd Function's
gradients against autograd through the plain version, the dropout mask, and
the kernel's packed weight layout and tile choice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from exp.pallas_conv3x3 import conv3x3_bias_relu as pallas_nhwc
from exp.pallas_conv3x3 import conv3x3_bias_relu_cw as pallas_cw
from witw_tpu.configs import FovDsmModelConfig
from witw_tpu.models import FovDsm as JaxFovDsm
from witw_tpu_torch.models.backbones import vgg16
from witw_tpu_torch.models.convert_jax import tower_to_state_dict
from witw_tpu_torch.models.fov_dsm import FovDsm
from witw_tpu_torch.ops import conv3x3


def _case(rng, b, h, w, c, n):
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, n)) / np.sqrt(9 * c)).astype(np.float32)  # HWIO
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, k, bias


def _plain(x, k, bias, circular, relu=True):
    """The port's plain version on numpy NHWC / HWIO inputs -> f32 numpy."""
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    y = conv3x3.conv3x3_bias_relu_plain(torch.from_numpy(x), w, torch.from_numpy(bias),
                                        circular, relu)
    assert y.dtype == torch.bfloat16
    return y.float().numpy()


def _bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at max(|got|, |want|)."""
    mag = np.maximum(np.abs(got), np.abs(want))
    spacing = np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)
    return np.abs(got - want) / spacing


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("cin", [3, 8])
def test_plain_equals_pallas_row2(rng, cin, circular, relu):
    x, k, bias = _case(rng, 2, 16, 24, cin, 16)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_nhwc(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                           circular=circular, relu=relu)
    want = np.asarray(want.astype(jnp.float32))
    got = _plain(x, k, bias, circular, relu)
    assert got.shape == want.shape == (2, 16, 24, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("circular", [False, True])
def test_plain_within_one_ulp_of_pallas_row3(rng, circular):
    x, k, bias = _case(rng, 2, 16, 128, 8, 16)
    x_cw = np.ascontiguousarray(np.transpose(x, (0, 1, 3, 2)))  # [B, H, C, W]
    with pltpu.force_tpu_interpret_mode():
        want = pallas_cw(jnp.asarray(x_cw), jnp.asarray(k), jnp.asarray(bias), circular=circular)
    want = np.transpose(np.asarray(want.astype(jnp.float32)), (0, 1, 3, 2))
    got = _plain(x, k, bias, circular)
    assert got.shape == want.shape
    assert _bf16_ulps(got, want).max() <= 1.0
    assert np.mean(got == want) > 0.999


def test_circular_equals_the_block_halo(rng):
    """Two circular convs equal the towers' f32 form of a block, a 2-column
    wrap halo and two width-VALID convs, bit for bit."""
    x, k1, b1 = _case(rng, 2, 8, 12, 8, 16)
    _, k2, b2 = _case(rng, 1, 1, 1, 16, 16)
    ws = [torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))) for k in (k1, k2)]
    bs = [torch.from_numpy(b) for b in (b1, b2)]
    y = torch.from_numpy(x)
    for w, b in zip(ws, bs):
        y = conv3x3.conv3x3_bias_relu_plain(y, w, b, circular=True)
    h = vgg16.wrap_pad_width(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    for w, b in zip(ws, bs):
        hc = h.to(torch.bfloat16).float()
        acc = F.conv2d(hc, w.to(torch.bfloat16).float(), padding=(1, 0))
        h = torch.relu(acc + b[:, None, None]).to(torch.bfloat16)
    assert torch.equal(y, h.permute(0, 2, 3, 1))


@pytest.mark.parametrize("circ,cin", [(False, 3), (True, 3), (True, 5)])
def test_bf16_towers_on_the_fused_route_match_flax(rng, monkeypatch, circ, cin):
    """Every stride-1 conv of a bf16 tower (10 VGG convs and conv_27) goes
    through ops.conv3x3, and the tower agrees with the flax bf16 tower at the
    tolerance of tests/test_torch_models.py::test_bf16_fov_dsm_matches_jax_bf16
    (rtol 2e-2, atol 2e-2 * max|y|)."""
    calls = []
    real = vgg16.conv3x3_bias_relu

    def counting(x, w, b, circular, relu):
        calls.append((circular, relu))
        return real(x, w, b, circular, relu)

    monkeypatch.setattr(vgg16, "conv3x3_bias_relu", counting)
    cfg = FovDsmModelConfig(in_channels=cin, train_first_conv=cin == 5)
    x = rng.standard_normal((2, 32, 64, cin)).astype(np.float32)
    jmodel = JaxFovDsm(cfg, circ_padding=circ)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(cin), jnp.zeros((1, 32, 64, cin)))["params"]
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    model = FovDsm(cfg, circ_padding=circ).eval()
    model.load_state_dict(tower_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert calls == [(circ, True)] * 10 + [(circ, False)]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_gradients_match_autograd_of_plain(rng, dtype, circular, relu):
    """Gradients of the autograd Function (custom backward, in x's dtype)
    against autograd through the plain version. In f32 the plain version
    rounds the x and w gradients to bf16 on the way back through its casts,
    so they agree to that rounding (rtol 2^-8); the bias gradient is f32 in
    both (rtol 1e-5). In bf16 both round, after sums in different orders
    (rtol 1e-2, as the card check)."""
    x, k, bias = _case(rng, 2, 6, 9, 8, 16)
    w = np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))
    g = rng.standard_normal((2, 6, 9, 16)).astype(np.float32)
    grads = []
    for fn in (conv3x3.conv3x3_bias_relu, conv3x3.conv3x3_bias_relu_plain):
        xt = torch.from_numpy(x).to(torch.bfloat16).to(dtype).requires_grad_(True)
        wt = torch.from_numpy(w).to(torch.bfloat16).to(dtype).requires_grad_(True)
        bt = torch.from_numpy(bias).requires_grad_(True)
        y = fn(xt, wt, bt, circular, relu, out_dtype=dtype)
        y.backward(torch.from_numpy(g).to(dtype))
        grads.append([t.grad.float() for t in (xt, wt, bt)])
    rtol = 2.0 ** -8 if dtype == torch.float32 else 1e-2
    for name, got, want, tol in zip("xwb", grads[0], grads[1], (rtol, rtol, 1e-5)):
        assert float(got.abs().max()) > 0, name
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.abs().max()),
                                   msg=name)


def test_dropout_masks_whole_channels_from_the_generator():
    x = torch.ones(8, 64, 3, 5)
    y = vgg16.dropout2d(x, 0.25, torch.Generator().manual_seed(3))
    per_channel = y.reshape(8, 64, -1)
    assert torch.equal(per_channel.amin(-1), per_channel.amax(-1))  # whole channels
    assert set(per_channel[..., 0].unique().tolist()) == {0.0, float(torch.tensor(1.0) / 0.75)}
    kept = float((per_channel[..., 0] > 0).float().mean())
    assert 0.6 < kept < 0.9
    again = vgg16.dropout2d(x, 0.25, torch.Generator().manual_seed(3))
    other = vgg16.dropout2d(x, 0.25, torch.Generator().manual_seed(4))
    assert torch.equal(y, again) and not torch.equal(y, other)
    with pytest.raises(ValueError):
        vgg16.dropout2d(x, 0.25, None)


@pytest.mark.parametrize("co", [16, 72, 128])
@pytest.mark.parametrize("cin", [3, 5, 40, 64, 512])
def test_pack_weights_round_trips_and_zero_pads(rng, cin, co):
    """unpack_weights gives back the bf16 OIHW weights bit for bit, and every
    slot that pack_weights adds (Cin to a multiple of 16, Co to a multiple of
    the channel tile) is zero."""
    w = torch.from_numpy(rng.standard_normal((co, cin, 3, 3)).astype(np.float32))
    p = conv3x3.pack_weights(w)
    n = conv3x3.tile_n(co)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape == (-(-co // n), 9 * conv3x3.padded_channels(cin) * n)
    assert torch.equal(conv3x3.unpack_weights(p, co, cin), w.to(torch.bfloat16))
    ones = conv3x3.pack_weights(torch.ones(co, cin, 3, 3))
    assert int(ones.count_nonzero()) == co * cin * 9 == int(ones.float().sum())


def test_pack_weights_follows_the_descriptor_order(rng):
    """Element (o, ci, dy, dx) sits where the kernel's wgmma B descriptor
    reads it: channel tile o // N; then 9 x 16 N per earlier 16-channel step
    and 16 N per earlier tap of its own step; 64 per earlier core matrix (two
    k halves per group of 8 channels); 8 per row; ci % 8."""
    co, cin = 72, 40  # N 128, Cin_p 48: three steps, the last one padded
    w = torch.from_numpy(rng.standard_normal((co, cin, 3, 3)).astype(np.float32))
    p = conv3x3.pack_weights(w)
    n = conv3x3.tile_n(co)
    assert (n, conv3x3.padded_channels(cin)) == (128, 48)
    for o in range(co):
        for ci in range(cin):
            o_n, kg = o % n, ci % 16 // 8
            for tap in range(9):
                at = ((ci // 16 * 9 + tap) * n * 16 + (o_n // 8 * 2 + kg) * 64 + o_n % 8 * 8
                      + ci % 8)
                assert p[o // n, at] == w[o, ci, tap // 3, tap % 3].to(torch.bfloat16)


@pytest.mark.parametrize("h,w,tile", [
    (128, 512, (16, 16)), (16, 64, (16, 16)), (16, 16, (16, 16)),  # tower shapes, fov 360 / 90
    (4, 64, (8, 32)),  # conv_27
    (9, 1, (16, 16)), (2, 130, (8, 32)), (64, 8, (32, 8)),
])
def test_tile_shape_pads_least(h, w, tile):
    assert conv3x3.tile_shape(h, w) == tile
    assert conv3x3.padded_channels(3) == 16 and conv3x3.padded_channels(512) == 512
    assert [conv3x3.tile_n(c) for c in (8, 16, 24, 64, 72, 128, 512)] == [16, 16, 64, 64, 128, 128, 128]
