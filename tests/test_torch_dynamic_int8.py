"""The port's dynamic-scale int8 FOV towers (``quantize_fov_params``,
``quantized_fov_forward``, ``quantize_pipeline`` in
witw_tpu_torch.models.quantize) against witw_tpu's
(witw_tpu/models/quantize.py:42-135), on the CPU, where every conv takes
kernel A's plain dequant version.

Inputs come from numpy ``default_rng``; the towers are flax inits moved into
the port with ``convert_jax``. witw_tpu's forward runs op by op, not under
``jax.jit`` (XLA fuses the dequant epilogue and can move rounding ties), and
its activations are read by stepping its ``_quantize_act`` / ``_qconv`` in
witw_tpu's order. Tolerances: the weights bit-equal; every layer's int8
activations and scales equal (a rounding tie that flipped would be counted
in the message); the embeddings within rtol 1e-5, atol 1e-6 of witw_tpu's
``quantized_fov_forward``; cosine against the f32 tower > 0.99 (witw_tpu's
bar, tests/test_quantize.py:28).
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from witw_tpu.configs import FovDsmModelConfig as JaxFovDsmModelConfig
from witw_tpu.models import FovDsm as JaxFovDsm
from witw_tpu.models import quantize as jq
from witw_tpu.models.backbones.vgg16 import VGG16_BLOCKS as JAX_BLOCKS
from witw_tpu.models.backbones.vgg16 import wrap_pad_width as jax_wrap_pad_width
from witw_tpu.models.fov_dsm import HEAD_CONVS as JAX_HEAD_CONVS
from witw_tpu_torch.configs import FovDsmModelConfig
from witw_tpu_torch.models import quantize as tq
from witw_tpu_torch.models.convert_jax import tower_to_state_dict
from witw_tpu_torch.models.fov_dsm import FovDsm
from witw_tpu_torch.ops import fused_block2, int8_conv, maxpool

N_CONVS = len(tq.CONV_ORDER)  # 10 VGG convs and 3 head convs
N_QUANTIZED = N_CONVS  # one quantize pass per conv input


def _tower(circ, hw, cin=3, seed=0):
    model = JaxFovDsm(JaxFovDsmModelConfig(compute_dtype="float32", in_channels=cin),
                      circ_padding=circ)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, cin)))
    params = jax.tree.map(np.asarray, variables["params"])
    return params, tower_to_state_dict(params)


def _jax_stepped(qparams, x, circ):
    """witw_tpu's quantized_fov_forward, step by step in its own order:
    [(int8 activation, its scale)] of each conv's input, and the output."""
    w_pad = (0, 0) if circ else (1, 1)
    acts = []

    def quantize(h):
        q, s = jq._quantize_act(h)
        acts.append((np.asarray(q), np.asarray(s)))
        return q, s

    h = jnp.asarray(x, jnp.float32)
    for block_i, block in enumerate(JAX_BLOCKS):
        if circ:
            h = jax_wrap_pad_width(h, len(block))
        h_q, h_s = quantize(h)
        for torch_idx, _ in block:
            y = jax.nn.relu(jq._qconv(h_q, h_s, qparams["vgg"][f"conv_{torch_idx}"], pad_w=w_pad))
            if torch_idx != block[-1][0]:
                h_q, h_s = quantize(y)
        h = y
        if block_i < 3:
            h = jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    if circ:
        h = jax_wrap_pad_width(h, len(JAX_HEAD_CONVS))
    h_q, h_s = quantize(h)
    for i, (name, _, strides, relu_after) in enumerate(JAX_HEAD_CONVS):
        y = jq._qconv(h_q, h_s, qparams[name], strides=strides, pad_w=w_pad)
        if relu_after:
            y = jax.nn.relu(y)
        if i + 1 < len(JAX_HEAD_CONVS):
            h_q, h_s = quantize(y)
    return acts, np.asarray(y)


@pytest.mark.parametrize("cin", [3, 5])
def test_quantize_fov_params_matches_jax(cin):
    """kernel_q, scale and bias bit-equal to witw_tpu's (the 5-channel
    semantic conv_0 too); kernel A's two tables hold kernel_q."""
    params, sd = _tower(False, (32, 64), cin)
    want = jq.quantize_fov_params(params)
    got = tq.quantize_fov_params(sd)
    for name in tq.CONV_ORDER:
        g = got["vgg"][name] if name in tq.TRUNK_ORDER else got[name]
        w = want["vgg"][name] if name in tq.TRUNK_ORDER else want[name]
        assert set(g) == set(w) | {"kernel_packed", "kernel_wgmma"}
        for key in w:
            assert g[key].dtype == w[key].dtype, (name, key)
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name}.{key}")
        kq = w["kernel_q"]
        cin_k, co = kq.shape[2:]
        np.testing.assert_array_equal(g["kernel_packed"][..., :cin_k], np.transpose(kq, (3, 0, 1, 2)))
        np.testing.assert_array_equal(int8_conv.unpack_weights_wgmma(g["kernel_wgmma"], cin_k, co), kq)


@pytest.mark.parametrize("hw,circ", [
    ((32, 64), False),
    ((32, 64), True),
    ((32, 25), False),  # odd widths, as the 128 x 99 serving crop's: the pools drop a column
])
def test_dynamic_forward_matches_jax_layer_by_layer(rng, monkeypatch, hw, circ):
    params, sd = _tower(circ, hw)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    jqp = jax.tree.map(jnp.asarray, jq.quantize_fov_params(params))
    want_acts, want_stepped = _jax_stepped(jqp, x, circ)
    want = np.asarray(jq.quantized_fov_forward(jqp, jnp.asarray(x), circ_padding=circ))
    np.testing.assert_array_equal(want_stepped, want)  # the stepping is witw_tpu's forward

    acts = []
    real = tq._quantize_act

    def recording(h):
        q, s = real(h)
        acts.append((q, s))
        return q, s

    monkeypatch.setattr(tq, "_quantize_act", recording)
    qp = tq.static_qparams_to_device(tq.quantize_fov_params(sd), "cpu")
    got = tq.quantized_fov_forward(qp, torch.from_numpy(x), circ).numpy()

    assert len(acts) == len(want_acts) == N_QUANTIZED
    for i, ((q, s), (wq, ws)) in enumerate(zip(acts, want_acts)):
        assert q.dtype == torch.int8 and s.shape == () and s.dtype == torch.float32
        assert q.shape == wq.shape, (i, q.shape, wq.shape)
        assert s.numpy() == ws, (i, float(s), float(ws))
        flipped = int((q.numpy() != wq).sum())
        assert flipped == 0, (f"conv input {i}: {flipped} of {wq.size} int8 values differ "
                              f"(rounding ties flipped)")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    model = FovDsm(FovDsmModelConfig(compute_dtype="float32"), circ_padding=circ).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    cos = float(np.sum(got * ref) / (np.linalg.norm(got) * np.linalg.norm(ref)))
    per_row = [float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)))
               for a, b in zip(got.reshape(2, -1), ref.reshape(2, -1))]
    assert cos > 0.99, (cos, per_row)


def test_dynamic_path_runs_every_conv_on_kernel_a(rng, monkeypatch):
    """Each tower makes 13 calls of kernel A's dequant wrapper (the
    stride-2 head convs included) with dequant = x_scale * w_scale, and
    calls no requant conv, pool kernel or kernel C; every scale stays a
    0-dim tensor on the input's device."""
    calls = []
    real = tq.conv3x3_int8_dequant

    def counting(x, w, dequant, bias_f, stride_h=1, pad_w=1, w_wgmma=None):
        calls.append((tuple(x.shape), tuple(w.shape), stride_h, pad_w, dequant))
        assert w_wgmma is not None and dequant.dtype == torch.float32
        return real(x, w, dequant, bias_f, stride_h, pad_w, w_wgmma)

    def forbidden(*args, **kwargs):
        raise AssertionError("the dynamic path called a static-path kernel")

    monkeypatch.setattr(tq, "conv3x3_int8_dequant", counting)
    for name in ("conv3x3_int8", "maxpool2x2", "fused_block2"):
        monkeypatch.setattr(tq, name, forbidden)
    scales = []
    real_q = tq._quantize_act

    def recording(h):
        q, s = real_q(h)
        scales.append(s)
        return q, s

    monkeypatch.setattr(tq, "_quantize_act", recording)
    params = {t: _tower(circ, (32, 64), seed=int(circ))[1]
              for t, circ in (("surface", False), ("overhead", True))}
    q_s, q_o = tq.quantize_pipeline(params)
    assert q_s["vgg"]["conv_0"]["kernel_wgmma"].dtype == torch.int8
    x = torch.from_numpy(rng.standard_normal((2, 32, 64, 3)).astype(np.float32))
    tq.quantized_fov_forward(q_s, x, False)
    tq.quantized_fov_forward(q_o, x, True)
    assert len(calls) == 2 * N_CONVS
    assert [c[2] for c in calls[:N_CONVS]] == [1] * 10 + [2, 2, 1]
    assert {c[3] for c in calls[:N_CONVS]} == {1} and {c[3] for c in calls[N_CONVS:]} == {0}
    assert all(s.shape == () and isinstance(s, torch.Tensor) for s in scales)
    assert len(scales) == 2 * N_QUANTIZED
    assert int8_conv.launches == maxpool.launches == fused_block2.launches == 0
