"""Card tests of the port's CUDA kernels (the fused match, the three
static-int8 kernels, the bf16 conv + bias + ReLU, the ConvNeXt mixer and
the int8 profiling harness's three), of the baseline family's int8 convs on
``torch._int_mm``, of the sharded paths on a mesh of the card and of the
public names the port added last (against the CPU); each
skips without a CUDA device (the two-card mesh without two cards). This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernel vs plain PyTorch in f32 with TF32 off: rtol 1e-5, atol 1e-6 and equal
orientations, except at near ties (plain top-2 correlation gap <= 1e-5 of
the max), where the two summation orders may pick different shifts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from witw_tpu_torch.configs import DataConfig, DatasetConfig, ExperimentConfig, FovDsmModelConfig
from witw_tpu_torch.exp import int8_isolate, int8_mm_probe, mosaic_caps
from witw_tpu_torch.match.correlation import circular_correlation
from witw_tpu_torch.models import quantize
from witw_tpu_torch.models.fov_dsm import FovDsm
from witw_tpu_torch.ops import (conv3x3, convnext_mixer, fused_block2, fused_match, int8_conv,
                                maxpool)
from witw_tpu_torch.train.pipeline import FovPipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(fused_match, "launches", 0)
    return torch.device("cuda")


@pytest.mark.parametrize("g,q,h,w,c,sw,data", [
    (8, 4, 2, 8, 3, 8, "random"),
    (6, 3, 1, 8, 4, 5, "random"),
    (37, 70, 4, 64, 16, 64, "random"),  # ragged query tile
    (5, 9, 2, 100, 8, 33, "random"),  # widths above one 64-shift pass
    (3, 2, 1, 1, 2, 1, "random"),
    (4, 5, 2, 12, 3, 7, "random"),  # hc 6, not a multiple of 8
    (4, 5, 4, 16, 5, 9, "random"),  # hc 20
    (3, 4, 2, 100, 8, 100, "random"),  # sw = W: every window wraps
    (6, 7, 4, 64, 16, 1, "random"),  # sw 1
    (7, 5, 4, 64, 16, 64, "random"),  # G odd: a block's second map is missing
    (6, 9, 4, 64, 16, 64, "scaled"),  # values scaled by 1e3
    (4, 5, 2, 16, 8, 10, "tie"),  # gallery maps of period W / 2: exact ties
    (5, 6, 4, 64, 16, 64, "nan"),  # a NaN in gallery map 2
    (5, 6, 4, 64, 32, 64, "random"),  # hc 128: two channel chunks of 64
    (5, 6, 4, 128, 16, 64, "random"),  # W 128 at hc 64: two chunks of 32
    (4, 5, 4, 20, 18, 9, "random"),  # hc 72: two chunks of 40
    (3, 4, 2, 256, 32, 200, "random"),  # 4 passes of 2 chunks: a refill per chunk
    (6, 5, 1, 16, 8, 1, "offset"),  # o and s 4 bytes off 16-byte alignment
])
def test_kernel_matches_plain(cuda, g, q, h, w, c, sw, data):
    rng = np.random.default_rng(0)
    o = torch.tensor(rng.standard_normal((g, h, w, c)), dtype=torch.float32, device=cuda)
    s = torch.tensor(rng.standard_normal((q, h, sw, c)), dtype=torch.float32, device=cuda)
    if data == "scaled":
        o, s = o * 1e3, s * 1e3
    elif data == "tie":
        o[:, :, w // 2:] = o[:, :, :w // 2]
    elif data == "nan":
        o[2, 1, 5, 3] = float("nan")
    elif data == "offset":  # views the wrapper passes on uncopied (h = 1, sw = 1)
        o = torch.empty(o.numel() + 1, device=cuda)[1:].view(o.shape).copy_(o)
        s = torch.empty(s.numel() + 1, device=cuda)[1:].view(s.shape).copy_(s)
        assert o.data_ptr() % 16 == 4 and s.data_ptr() % 16 == 4
    d_k, or_k = fused_match.fused_chord_distance_nhwc(o, s)
    d_p, or_p = fused_match.fused_chord_distance_plain(o, s)
    torch.cuda.synchronize()
    assert fused_match.launches == 1
    assert d_k.shape == (g, q) and or_k.dtype == torch.int32
    if w > 1:
        # Near ties (top-2 gap <= 1e-5 |max|) are excluded; with exact ties
        # of pairs of shifts, the gap to the next pair (top-3) decides.
        top = torch.topk(circular_correlation(o, s), 3 if data == "tie" else 2, dim=-1).values
        keep = (top[..., 0] - top[..., -1]) > 1e-5 * top[..., 0].abs()
    else:
        keep = torch.ones_like(d_p, dtype=torch.bool)
    assert torch.equal(or_k[keep], or_p[keep])
    torch.testing.assert_close(d_k[keep], d_p[keep], rtol=1e-5, atol=1e-6)
    if data == "tie":  # shifts i and i + W / 2 tie exactly: the lower index wins
        assert bool((or_k < w // 2).all())
    if data == "nan":  # the first NaN shift wins, as in torch.argmax, and d is NaN
        assert torch.equal(or_k[2], or_p[2])
        assert bool(d_k[2].isnan().all()) and bool(d_p[2].isnan().all())
        assert bool(keep[torch.arange(g, device=cuda) != 2].any())


@pytest.mark.parametrize("w", [1721, 2048, 4096])
@pytest.mark.parametrize("sw", [1, 64, "W"])
@pytest.mark.parametrize("h,c", [(2, 4), (4, 4)])  # hc 8 and 16
def test_kernel_matches_plain_past_whole_maps(cuda, w, sw, h, c):
    """Past W = 1720 the maps do not fit shared memory whole: the kernel
    holds windows of them (geometry()["kcols"] columns; several windows a
    pass at sw = W), with the tolerances of the cases above."""
    sw = w if sw == "W" else sw
    g, q = 5, 7
    assert fused_match.geometry(g, q, w, h * c)["kcols"] < w
    rng = np.random.default_rng(1)
    o = torch.tensor(rng.standard_normal((g, h, w, c)), dtype=torch.float32, device=cuda)
    s = torch.tensor(rng.standard_normal((q, h, sw, c)), dtype=torch.float32, device=cuda)
    d_k, or_k = fused_match.fused_chord_distance_nhwc(o, s)
    d_p, or_p = fused_match.fused_chord_distance_plain(o, s)
    torch.cuda.synchronize()
    assert fused_match.launches == 1
    top = torch.topk(circular_correlation(o, s), 2, dim=-1).values
    keep = (top[..., 0] - top[..., -1]) > 1e-5 * top[..., 0].abs()
    assert bool(keep.any())
    assert torch.equal(or_k[keep], or_p[keep])
    torch.testing.assert_close(d_k[keep], d_p[keep], rtol=1e-5, atol=1e-6)


def test_kernel_rejects_mixed_or_strided_cuda_inputs(cuda):
    o = torch.zeros(4, 8, 6, device=cuda)
    s = torch.zeros(5, 3, 6, device=cuda)
    wsq = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        fused_match.fused_corr_distance(o, s, wsq.cpu())
    with pytest.raises(ValueError):
        fused_match.fused_corr_distance(o, torch.zeros(3, 5, 6, device=cuda).transpose(0, 1), wsq)
    assert fused_match.launches == 0


def test_forward_distance_on_gpu_matches_cpu(cuda):
    ds = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True)
    data = DataConfig(dataset=ds, surface_height=32, surface_width_max=64,
                      overhead_size=32, random_orientation=False)
    cfg = ExperimentConfig(data=data, model=FovDsmModelConfig(compute_dtype="float32"))
    cpu = FovPipeline(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {"surface": rng.uniform(0, 255, (6, 32, 64, 3)).astype(np.float32),
             "overhead": rng.uniform(0, 255, (6, 32, 32, 3)).astype(np.float32)}
    want = cpu.forward_distance(params, batch)
    gpu = FovPipeline(cfg, cuda)
    got = gpu.forward_distance({t: {k: v.to(cuda) for k, v in p.items()}
                                for t, p in params.items()}, batch)
    assert fused_match.launches == 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
    for fov in (90,):
        cfg_fov = cfg.replace(data=dataclasses.replace(cfg.data, fov=fov))
        d = FovPipeline(cfg_fov, cuda).forward_distance(
            {t: {k: v.to(cuda) for k, v in p.items()} for t, p in params.items()}, batch)
        assert d.shape == (6, 6) and bool(torch.isfinite(d).all())


# The static-int8 kernels (ops.int8_conv, ops.maxpool, ops.fused_block2)
# against their plain PyTorch versions: int8 outputs equal, f32 outputs
# within rtol 1e-6 and atol 1e-6 (the same int32 accumulator, and the same
# f32 multiply and add without FMA contraction).


@pytest.fixture
def int8_cuda(cuda, monkeypatch):
    for mod in (int8_conv, maxpool, fused_block2):
        monkeypatch.setattr(mod, "launches", 0)
    return cuda


def _conv_case(rng, device, b, h, w, cin, co):
    """int8 input, packed weights, and epilogue tables whose requantized
    outputs spread over the int8 range."""
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, cin, co)).astype(np.int8)
    acc_std = 3.0 * np.sqrt(cin) * 73.3 * 73.3
    t = {
        "x": x, "w": int8_conv.pack_weights(k), "w_wgmma": int8_conv.pack_weights_wgmma(k),
        "bias_q": rng.integers(-int(acc_std), int(acc_std), co).astype(np.int32),
        "m": rng.uniform(20.0, 60.0, co).astype(np.float32) / np.float32(acc_std),
        "dequant": rng.uniform(1e-5, 1e-4, co).astype(np.float32),
        "bias_f": rng.standard_normal(co).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in t.items()}


@pytest.mark.parametrize("b,h,w,cin,co,stride_h,pad_w", [
    (1, 7, 9, 5, 64, 1, 1),      # ragged: odd dims, Cin 5
    (2, 9, 11, 3, 64, 2, 0),     # Cin 3, stride (2, 1), width-VALID
    (2, 16, 21, 64, 128, 1, 0),  # the circular form on a wrap-haloed input
    (1, 5, 6, 512, 16, 1, 1),    # the last head conv's shape
    (3, 17, 35, 128, 256, 2, 1),
    (2, 16, 516, 3, 64, 1, 0),   # overhead conv1_1: W 516 -> 514, a 32 x 8 tile, Cin 3
    (2, 16, 70, 256, 512, 1, 0),  # overhead conv4_1: W 70 -> 68
    (2, 16, 70, 512, 256, 2, 0),  # overhead conv_23: stride 2 at Ho 8
    (2, 8, 64, 256, 64, 2, 1),   # surface conv_25: stride 2 at Ho 4
    (1, 16, 512, 3, 64, 1, 1),   # surface conv1_1: Cin 3 at full width
    (2, 4, 66, 64, 16, 1, 0),    # overhead conv_27: Co 16 (the dequant epilogue below)
    (2, 9, 11, 40, 20, 1, 1),    # Co 20, not a multiple of 16: 4-byte stores; Cin 40
])
def test_int8_conv_matches_plain(int8_cuda, b, h, w, cin, co, stride_h, pad_w):
    t = _conv_case(np.random.default_rng(0), int8_cuda, b, h, w, cin, co)
    for relu in (True, False):
        got = int8_conv.conv3x3_int8(t["x"], t["w"], t["bias_q"], t["m"], stride_h, pad_w, relu,
                                     t["w_wgmma"])
        want = int8_conv.conv3x3_int8_plain(t["x"], t["w"], t["bias_q"], t["m"], stride_h, pad_w,
                                            relu)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert torch.equal(got, want)
        assert got.unique().numel() > 20  # the epilogue spreads over the int8 range
    got = int8_conv.conv3x3_int8_dequant(t["x"], t["w"], t["dequant"], t["bias_f"], stride_h, pad_w,
                                         t["w_wgmma"])
    want = int8_conv.conv3x3_int8_dequant_plain(t["x"], t["w"], t["dequant"], t["bias_f"],
                                                stride_h, pad_w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert int8_conv.launches == 3


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 8, 10, 64), (1, 7, 9, 6), (3, 5, 4, 128)])
def test_maxpool_matches_plain(int8_cuda, dtype, shape):
    gen = torch.Generator(device=int8_cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=int8_cuda) * 40
    x = x.round().clamp(-127, 127).to(dtype)
    got = maxpool.maxpool2x2(x)
    want = maxpool.maxpool2x2_plain(x)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    assert maxpool.launches == 1


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("b,h,w", [
    (2, 8, 20), (2, 7, 9), (2, 17, 34), (2, 2, 2),
    (1, 17, 33), (2, 16, 16), (1, 2, 2), (3, 9, 3),  # tile tails and tiny widths
])
def test_fused_block2_matches_plain(int8_cuda, circular, b, h, w):
    rng = np.random.default_rng(1)
    c1 = _conv_case(rng, int8_cuda, b, h, w, 64, 128)
    c2 = _conv_case(rng, int8_cuda, b, h, w, 128, 128)
    x = c1["x"].abs()  # the pool-1 output of a ReLU tower
    args = (x, c1["w"], c1["bias_q"], c1["m"], c2["w"], c2["bias_q"], c2["m"])
    got = fused_block2.fused_block2(*args, circular=circular, w1_wgmma=c1["w_wgmma"],
                                    w2_wgmma=c2["w_wgmma"])
    want = fused_block2.fused_block2_plain(*args, circular=circular)
    torch.cuda.synchronize()
    assert got.shape == (b, h // 2, w // 2, 128) and torch.equal(got, want)
    assert fused_block2.launches == 1


@pytest.mark.parametrize("table,channel,value", [
    ("m1", 0, 1e-6),       # (2^22 - 1) m < 127.5: conv2_1 past 2^22 need not clip to 127
    ("m2", 77, 2e-5),
    ("b2", 5, 1 << 24),    # |bias_q| >= 2^24
    ("b1", 127, -(1 << 24)),
])
def test_fused_block2_exact_requant_tables(int8_cuda, table, channel, value):
    """Tables outside the range of the kernel's conversion-free requant take
    its int-to-float requant: equal to the plain version all the same."""
    rng = np.random.default_rng(4)
    c1 = _conv_case(rng, int8_cuda, 2, 17, 34, 64, 128)
    c2 = _conv_case(rng, int8_cuda, 2, 17, 34, 128, 128)
    t = {"b1": c1["bias_q"], "m1": c1["m"], "b2": c2["bias_q"], "m2": c2["m"]}
    t[table] = t[table].clone()
    t[table][channel] = value
    args = (c1["x"].abs(), c1["w"], t["b1"], t["m1"], c2["w"], t["b2"], t["m2"])
    for circular in (False, True):
        got = fused_block2.fused_block2(*args, circular=circular, w1_wgmma=c1["w_wgmma"],
                                        w2_wgmma=c2["w_wgmma"])
        want = fused_block2.fused_block2_plain(*args, circular=circular)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert fused_block2.launches == 2


def test_int8_kernels_reject_bad_inputs(int8_cuda):
    t = _conv_case(np.random.default_rng(2), int8_cuda, 1, 4, 4, 8, 16)
    args = (t["bias_q"], t["m"], 1, 1, True)
    with pytest.raises(ValueError):  # Cin_p must be Cin rounded up to 4
        int8_conv.conv3x3_int8(t["x"][..., :3].contiguous(), t["w"], *args, t["w_wgmma"])
    with pytest.raises(ValueError):  # one CUDA device for every input
        int8_conv.conv3x3_int8(t["x"], t["w"], t["bias_q"].cpu(), t["m"], 1, 1, True, t["w_wgmma"])
    with pytest.raises(ValueError):  # the kernel reads pack_weights_wgmma's table
        int8_conv.conv3x3_int8(t["x"], t["w"], *args)
    with pytest.raises(ValueError):  # a table for another Cin
        wrong = int8_conv.pack_weights_wgmma(np.ones((3, 3, 40, 16), np.int8))
        int8_conv.conv3x3_int8(t["x"], t["w"], *args, torch.from_numpy(wrong).to(int8_cuda))
    with pytest.raises(ValueError):  # Co must be a multiple of 4
        c = _conv_case(np.random.default_rng(2), int8_cuda, 1, 4, 4, 8, 18)
        int8_conv.conv3x3_int8(c["x"], c["w"], c["bias_q"], c["m"], 1, 1, True, c["w_wgmma"])
    with pytest.raises(ValueError):  # strided
        maxpool.maxpool2x2(t["x"].transpose(1, 2))
    with pytest.raises(ValueError):  # block 2 takes 64 channels
        fused_block2.fused_block2(t["x"], t["w"], t["bias_q"], t["m"], t["w"], t["bias_q"], t["m"],
                                  w1_wgmma=t["w_wgmma"], w2_wgmma=t["w_wgmma"])
    c1 = _conv_case(np.random.default_rng(2), int8_cuda, 1, 4, 4, 64, 128)
    c2 = _conv_case(np.random.default_rng(3), int8_cuda, 1, 4, 4, 128, 128)
    block2 = (c1["x"], c1["w"], c1["bias_q"], c1["m"], c2["w"], c2["bias_q"], c2["m"])
    with pytest.raises(ValueError):  # the kernel reads pack_weights_wgmma's tables
        fused_block2.fused_block2(*block2)
    with pytest.raises(ValueError):  # conv2_2's table in conv2_1's place
        fused_block2.fused_block2(*block2, w1_wgmma=c2["w_wgmma"], w2_wgmma=c2["w_wgmma"])
    assert int8_conv.launches == maxpool.launches == fused_block2.launches == 0


@pytest.mark.parametrize("circ", [False, True])
def test_static_int8_tower_on_gpu_matches_cpu(int8_cuda, circ):
    """The same tables and int8 input through the kernels and through the
    CPU plain path: equal embeddings (atol 1e-6), all three kernels used."""
    model = FovDsm(FovDsmModelConfig(compute_dtype="float32"), circ_padding=circ)
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 32, 64, 3)).astype(np.float32))
    tables = quantize.prepare_static_qparams(
        sd, quantize.calibrate_fov_activation_scales(sd, [x], circ))
    sq_cpu = quantize.static_qparams_to_device(tables, "cpu")
    sq_gpu = quantize.static_qparams_to_device(tables, int8_cuda)
    xq = quantize.quantize_input(x, sq_cpu["input_scale"])
    want = quantize.quantized_fov_forward_static(sq_cpu, xq, circ, x_quantized=True)
    got = quantize.quantized_fov_forward_static(sq_gpu, xq.to(int8_cuda), circ, x_quantized=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    assert int8_conv.launches == 11 and maxpool.launches == 2 and fused_block2.launches == 1


@pytest.mark.parametrize("b,h,w,cin,co,stride_h,pad_w", [
    (2, 16, 64, 64, 128, 1, 1),    # stride 1, zero width padding
    (2, 16, 70, 256, 512, 1, 0),   # stride 1, circular (width-VALID on a wrap halo)
    (2, 16, 64, 512, 256, 2, 1),   # stride 2 head conv_23, zero padding
    (2, 16, 70, 512, 256, 2, 0),   # stride 2, circular
    (2, 8, 66, 256, 64, 2, 0),     # conv_25, circular
    (2, 32, 99, 3, 64, 1, 1),      # the 128 x 99 serving crop's widths: conv1_1 at W 99
    (2, 32, 49, 64, 128, 1, 1),    # conv2_1 at W 49
    (2, 32, 24, 128, 256, 1, 1),   # conv3_1 at W 24
    (2, 16, 12, 256, 512, 1, 1),   # conv4_1 at W 12
    (2, 16, 12, 512, 256, 2, 1),   # conv_23 at W 12
])
def test_int8_dequant_with_device_scales_matches_plain(int8_cuda, b, h, w, cin, co, stride_h,
                                                       pad_w):
    """Kernel A's dequant epilogue as the dynamic-int8 towers drive it: an
    f32 activation quantized on the card (``_quantize_act``: a 0-dim scale
    tensor), per-channel int8 weights, dequant = x_scale * w_scale computed
    on the card. Bit-equal (0 ULP) to the plain formula float(acc) *
    dequant + bias; with dequant 1 and bias 0, equal to the plain int32
    accumulator as f32."""
    gen = torch.Generator(device=int8_cuda).manual_seed(15)
    x = torch.relu(torch.randn((b, h, w, cin), generator=gen, device=int8_cuda))
    x_q, x_scale = quantize._quantize_act(x)
    kernel = torch.randn((3, 3, cin, co), generator=gen, device=int8_cuda) / (3 * cin ** 0.5)
    w_scale = torch.clamp(kernel.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
    kq = torch.clamp(torch.round(kernel / w_scale), -127, 127).to(torch.int8).cpu().numpy()
    packed = torch.from_numpy(int8_conv.pack_weights(kq)).to(int8_cuda)
    w_wgmma = torch.from_numpy(int8_conv.pack_weights_wgmma(kq)).to(int8_cuda)
    bias = torch.randn(co, generator=gen, device=int8_cuda)
    dequant = x_scale * w_scale
    assert x_scale.shape == () and x_scale.device == dequant.device == x.device
    got = int8_conv.conv3x3_int8_dequant(x_q, packed, dequant, bias, stride_h, pad_w, w_wgmma)
    want = int8_conv.conv3x3_int8_dequant_plain(x_q, packed, dequant, bias, stride_h, pad_w)
    ones, zeros = torch.ones_like(dequant), torch.zeros_like(bias)
    acc = int8_conv.conv3x3_int8_dequant(x_q, packed, ones, zeros, stride_h, pad_w, w_wgmma)
    want_acc = int8_conv.conv3x3_int8_acc_plain(x_q, packed, stride_h, pad_w).to(torch.float32)
    torch.cuda.synchronize()
    ho, wo = int8_conv.output_hw(h, w, stride_h, pad_w)
    assert got.shape == want.shape == (b, ho, wo, co)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(acc, want_acc), float((acc - want_acc).abs().max())
    assert int8_conv.launches == 2


@pytest.mark.parametrize("circ", [False, True])
def test_dynamic_int8_tower_on_gpu_matches_cpu(int8_cuda, circ):
    """The dynamic-int8 tower (per-batch scales on the device, every conv
    on kernel A's dequant epilogue, f32 pools) on the card against the CPU
    plain path with the same weights: equal embeddings (atol 1e-6), kernel A
    13 launches, no pool kernel or kernel C."""
    model = FovDsm(FovDsmModelConfig(compute_dtype="float32"), circ_padding=circ)
    model.reset_parameters(torch.Generator().manual_seed(0))
    tables = quantize.quantize_fov_params(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 32, 99, 3))
                         .astype(np.float32))
    want = quantize.quantized_fov_forward(quantize.static_qparams_to_device(tables, "cpu"), x,
                                          circ)
    got = quantize.quantized_fov_forward(quantize.static_qparams_to_device(tables, int8_cuda),
                                         x.to(int8_cuda), circ)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    assert int8_conv.launches == 13 and maxpool.launches == fused_block2.launches == 0


@pytest.mark.parametrize("circ", [False, True])
def test_static_int8_safa_tower_on_gpu_matches_cpu(int8_cuda, circ):
    """A SAFA tower's int8 trunk, conv4_3 on the dequant epilogue, then the
    f32 head: the kernels on the card against the CPU plain path on the
    same tables, unit embeddings within atol 1e-6; kernel A 7 requant + 1
    dequant launches (block 2's convs are kernel C's), B 2, C 1."""
    from witw_tpu_torch.configs.base import SafaModelConfig
    from witw_tpu_torch.models.safa import VggSafa

    model = VggSafa(SafaModelConfig(compute_dtype="float32"), (32, 64), circ)
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 32, 64, 3))
                         .astype(np.float32))
    sq_cpu, head = quantize.quantize_safa_tower_static(sd, [x], circ)
    sq_gpu = quantize.static_qparams_to_device(sq_cpu, int8_cuda)
    head_gpu = {k: v.to(int8_cuda) for k, v in head.items()}
    want = quantize.quantized_safa_forward_static(sq_cpu, head, x, circ)
    got = quantize.quantized_safa_forward_static(sq_gpu, head_gpu, x.to(int8_cuda), circ)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    assert int8_conv.launches == 8 and maxpool.launches == 2 and fused_block2.launches == 1


@pytest.mark.parametrize("b,hw", [(1, (500, 500)), (2, (448, 1232))])
def test_static_int8_baseline_tower_on_gpu_matches_cpu(int8_cuda, b, hw):
    """The baseline int8 tower (im2col + torch._int_mm, cuBLASLt on the
    card) against the CPU on the same tables: every layer's int32
    accumulator equal, embeddings within rtol 1e-5, atol 1e-6 (GeM's means
    sum in another order). A WITW photo at batch 1 leaves conv7 one output
    row (M = 1), padded to the 17 rows the card's GEMM takes; CVUSA's
    row-repeated 448 x 1232 at batch 2. None of the port's kernels runs."""
    from witw_tpu_torch.configs.base import BaselineModelConfig
    from witw_tpu_torch.models.baseline import BaselineEncoder

    model = BaselineEncoder(BaselineModelConfig(compute_dtype="float32"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 255, (b, *hw, 3))
                         .astype(np.float32))
    sq_cpu = quantize.quantize_baseline_tower_static(sd, [x])
    sq_gpu = quantize.static_qparams_to_device(sq_cpu, int8_cuda)
    accs = {}
    real_acc = quantize.conv4x4s2_int8_acc

    def record(h, kernel_mm):
        out = real_acc(h, kernel_mm)
        accs.setdefault(h.device.type, []).append(out.cpu())
        return out

    quantize.conv4x4s2_int8_acc = record
    try:
        want = quantize.quantized_baseline_forward_static(sq_cpu, x)
        got = quantize.quantized_baseline_forward_static(sq_gpu, x.to(int8_cuda))
        torch.cuda.synchronize()
    finally:
        quantize.conv4x4s2_int8_acc = real_acc
    assert len(accs["cuda"]) == len(accs["cpu"]) == 7
    assert accs["cuda"][-1].shape[:3] == ((b, 1, 1) if hw == (500, 500) else (b, 1, 7))
    for i, (g, w) in enumerate(zip(accs["cuda"], accs["cpu"]), 1):
        assert torch.equal(g, w), f"conv{i}"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    assert int8_conv.launches == maxpool.launches == fused_block2.launches == 0


@pytest.mark.parametrize("w,pad_w", [(64, 1), (66, 0)])
def test_int8_dequant_conv4_3_at_full_safa_shape(int8_cuda, w, pad_w):
    """conv4_3 of the SAFA towers on kernel A's dequant epilogue at the main
    path's shape, batch 128, 16 x 64 outputs, Cin = Co = 512 (zero padded,
    and width-VALID on the circular tower's 66-column input): within rtol
    1e-6, atol 1e-6 of the plain version."""
    gen = torch.Generator(device=int8_cuda).manual_seed(5)
    x = torch.randint(0, 128, (128, 16, w, 512), generator=gen, device=int8_cuda,
                      dtype=torch.int8)
    k = torch.randint(-127, 128, (512, 3, 3, 512), generator=gen, device=int8_cuda,
                      dtype=torch.int8)
    w_wgmma = torch.from_numpy(int8_conv.pack_weights_wgmma(
        k.permute(1, 2, 3, 0).cpu().numpy())).to(int8_cuda)
    dequant = 1e-6 * (1 + torch.rand(512, generator=gen, device=int8_cuda))
    bias_f = torch.randn(512, generator=gen, device=int8_cuda)
    got = int8_conv.conv3x3_int8_dequant(x, k, dequant, bias_f, 1, pad_w, w_wgmma)
    want = int8_conv.conv3x3_int8_dequant_plain(x, k, dequant, bias_f, 1, pad_w)
    torch.cuda.synchronize()
    assert got.shape == (128, 16, 64, 512) and int8_conv.launches == 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# The bf16 conv + bias + ReLU kernel (ops.conv3x3) against its plain version:
# the same f32 products summed in another order, then one bf16 rounding, so
# outputs agree to a bf16 ulp (rtol 2^-7) except where a sum cancels to far
# below its terms (atol 1e-2 of the output scale).


@pytest.fixture
def conv_cuda(cuda, monkeypatch):
    monkeypatch.setattr(conv3x3, "launches", 0)
    return cuda


@pytest.mark.parametrize("b,h,w,cin,co,circular,relu", [
    (2, 16, 24, 3, 64, False, True),   # conv1_1: Cin 3 computed as 16
    (1, 7, 9, 5, 24, True, False),     # ragged: odd dims, Cin 5, Co 24 < 64
    (3, 9, 1, 16, 8, True, True),      # W = 1 wraps onto itself
    (2, 17, 33, 40, 72, True, False),  # half chunk (Cin_p 48), Co tail
    (2, 16, 64, 512, 512, False, True),
    (2, 16, 16, 256, 128, False, True),   # fov 90 block 4: 16 x 16 tile, W = 16
    (1, 5, 66, 64, 64, False, True),      # W = 66: a 2-column tile tail
    (2, 4, 64, 64, 16, True, False),      # conv_27: Co 16, 8 x 32 tile
    (2, 6, 20, 40, 16, False, True),      # Cin 40 (Cin_p 48) at Co 16
    (2, 11, 24, 64, 72, True, True),      # circular at W < 64, Co 72
    (1, 2, 24, 128, 256, True, True),     # circular, an 8 x 32 tile wider than W
])
def test_conv3x3_matches_plain(conv_cuda, b, h, w, cin, co, circular, relu):
    gen = torch.Generator(device=conv_cuda).manual_seed(0)
    x = torch.randn(b, h, w, cin, generator=gen, device=conv_cuda).to(torch.bfloat16)
    wt = (torch.randn(co, cin, 3, 3, generator=gen, device=conv_cuda) / (9 * cin) ** 0.5)
    bias = 0.1 * torch.randn(co, generator=gen, device=conv_cuda)
    got = conv3x3.conv3x3_bias_relu(x, wt, bias, circular, relu)
    want = conv3x3.conv3x3_bias_relu_plain(x, wt, bias, circular, relu)
    torch.cuda.synchronize()
    assert conv3x3.launches == 1 and got.dtype == torch.bfloat16 and got.shape == want.shape
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-2 * scale)
    assert float((got == want).float().mean()) > 0.99


def test_conv3x3_gradients_on_gpu_match_plain(conv_cuda):
    gen = torch.Generator(device=conv_cuda).manual_seed(1)
    x = torch.randn(2, 12, 20, 32, generator=gen, device=conv_cuda).to(torch.bfloat16)
    wt = (torch.randn(64, 32, 3, 3, generator=gen, device=conv_cuda) / 17.0).to(torch.bfloat16)
    bias = 0.1 * torch.randn(64, generator=gen, device=conv_cuda)
    for circular in (False, True):
        grads = []
        for fn in (conv3x3.conv3x3_bias_relu, conv3x3.conv3x3_bias_relu_plain):
            xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, wt, bias))
            fn(xs, ws, bs, circular, True).float().square().sum().backward()
            grads.append([t.grad.float() for t in (xs, ws, bs)])
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * float(want.abs().max()))


def test_conv3x3_rejects_bad_inputs(conv_cuda):
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16, device=conv_cuda)
    w = torch.zeros(12, 8, 3, 3, device=conv_cuda)
    b = torch.zeros(12, device=conv_cuda)
    with pytest.raises(ValueError):  # Co must be a multiple of 8
        conv3x3.conv3x3_bias_relu(x, w, b)
    with pytest.raises(ValueError):  # the kernel writes bfloat16 only
        conv3x3.conv3x3_bias_relu(x, w[:8], b[:8], out_dtype=torch.float32)
    with pytest.raises(ValueError):  # one CUDA device for every input
        conv3x3.conv3x3_bias_relu_kernel(x, conv3x3.pack_weights(w[:8]), b[:8].cpu())
    assert conv3x3.launches == 0


def test_bf16_train_step_on_gpu_matches_cpu(conv_cuda):
    """One bf16 train step (dropout on, random crops) on the card and on the
    CPU from the same params and generator seed: the losses agree to bf16
    precision (rtol 2e-2) and the kernel ran in forward passes."""
    ds = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True)
    data = DataConfig(dataset=ds, surface_height=32, surface_width_max=64, overhead_size=32)
    cfg = ExperimentConfig(data=data, model=FovDsmModelConfig())
    rng = np.random.default_rng(2)
    batch = {"surface": rng.integers(0, 256, (4, 32, 64, 3), np.uint8),
             "overhead": rng.integers(0, 256, (4, 32, 32, 3), np.uint8)}
    losses = []
    for device in ("cpu", conv_cuda):
        pipeline = FovPipeline(cfg, device)
        state = pipeline.init_state(torch.Generator().manual_seed(0))
        state, metrics = pipeline.train_step(state, batch, torch.Generator().manual_seed(3))
        losses.append(float(metrics["loss"]))
    assert conv3x3.launches == 22  # 11 fused convs per tower
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-2)


# The ConvNeXt mixer kernel against its plain version on the card, TF32 off
# (the plain conv in f32 on the same bf16-rounded operands): the two f32
# results differ only in the order of their sums (the conv's 49 taps, the
# LayerNorm's reductions), so the bf16 outputs agree to one rounding step
# (rtol 2^-7) with atol 1e-4 for values near 0, and nearly all bit for bit.


@pytest.fixture
def mixer_cuda(cuda, monkeypatch):
    monkeypatch.setattr(convnext_mixer, "launches", 0)
    return cuda


def _mixer_inputs(device, b, h, w, c, in_dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=gen, device=device).to(in_dtype)
    weight = torch.randn(c, 1, 7, 7, generator=gen, device=device) / 7.0
    bias = 0.02 * torch.randn(c, generator=gen, device=device)
    ln_w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
    ln_b = 0.02 * torch.randn(c, generator=gen, device=device)
    return x, weight, bias, ln_w, ln_b


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w", [
    (128, 35, 192), (128, 96, 96),  # stage 0: the panorama's and the tile's maps
    (256, 17, 96), (256, 48, 48),
    (512, 8, 48), (512, 24, 24),
    (1024, 4, 24), (1024, 12, 12),
])
def test_convnext_mixer_matches_plain(mixer_cuda, c, h, w, in_dtype):
    """The kernel at every stage's width and both views' map sizes (Sample4Geo
    at 140 x 768 and 384^2), f32 block inputs and bf16 ones (a stage's first
    block), against the plain version."""
    args = _mixer_inputs(mixer_cuda, 2, h, w, c, in_dtype, seed=c + h)
    got = convnext_mixer.convnext_mixer(*args, 1e-6)
    want = convnext_mixer.convnext_mixer_plain(*args, 1e-6)
    torch.cuda.synchronize()
    assert convnext_mixer.launches == 1 and got.dtype == torch.bfloat16
    assert got.shape == want.shape == (2, h, w, c)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-4)
    assert float((got == want).float().mean()) > 0.99


def test_convnext_mixer_geometry(mixer_cuda):
    """The library's tiling: every ConvNeXt width from 96 to 1024 splits into
    at most 8 slices of at most 128 channels and each of the 8 warps takes
    one micro-tile; each map of the Sample4Geo cell takes the tile that
    computes and stages the fewest pixels, and below C 1024 its block fits
    two to an SM (2 x (smem + 1 KB) within the H100's 228 KB); widths with
    no such split raise."""
    for c in (96, 128, 192, 256, 384, 512, 768, 1024):
        for h, w in ((35, 192), (17, 96), (8, 48)):
            geo = convnext_mixer.geometry(c, h, w)
            (tr, tc), (th, tw) = geo["tile"], geo["micro"]
            assert geo["ranks"] * geo["slice"] == c and geo["slice"] % 32 == 0
            assert geo["slice"] <= 128 and geo["ranks"] <= 8
            assert tr % th == 0 and tc % tw == 0 and (tr // th) * (tc // tw) == 8
            assert geo["tiles"] == (-(-h // tr), -(-w // tc))
            bf16 = convnext_mixer.geometry(c, h, w, torch.bfloat16)
            assert bf16["slice"] == geo["slice"] and bf16["smem_bytes"] < geo["smem_bytes"]
    stages = {(128, 35, 192): (12, 8), (128, 96, 96): (12, 8), (256, 17, 96): (4, 24),
              (256, 48, 48): (12, 8), (512, 8, 48): (8, 12), (512, 24, 24): (12, 8),
              (1024, 4, 24): (4, 24), (1024, 12, 12): (12, 8)}
    assert {k: convnext_mixer.geometry(*k)["tile"] for k in stages} == stages
    for c, h, w in stages:  # two blocks an SM below C 1024
        geo = convnext_mixer.geometry(c, h, w)
        assert (2 * (geo["smem_bytes"] + 1024) <= 228 * 1024) == (c < 1024), (c, h, w, geo)
    assert [convnext_mixer.geometry(c, 24, 24)["ranks"] for c in (128, 256, 512, 1024)] == [
        2, 4, 8, 8]
    for c in (0, 48, 1056, 1280, 2048):
        with pytest.raises(ValueError):
            convnext_mixer.geometry(c, 8, 8)


def test_convnext_mixer_rejects_bad_inputs(mixer_cuda):
    x, weight, bias, ln_w, ln_b = _mixer_inputs(mixer_cuda, 1, 4, 4, 64, torch.float32, seed=1)
    bad = [
        _mixer_inputs(mixer_cuda, 1, 4, 4, 48, torch.float32, seed=1),  # C not a multiple of 32
        _mixer_inputs(mixer_cuda, 1, 4, 4, 1056, torch.float32, seed=1),  # no 8 slices of 32k
        (x.half(), weight, bias, ln_w, ln_b),  # fp16 input
        (x.transpose(1, 2), weight, bias, ln_w, ln_b),  # not contiguous
        (x, weight.to(torch.bfloat16), bias, ln_w, ln_b),  # weights are f32
        (x, weight, bias.cpu(), ln_w, ln_b),  # one CUDA device for every input
    ]
    for args in bad:
        with pytest.raises(ValueError):
            convnext_mixer.convnext_mixer(*args, 1e-6)
    assert convnext_mixer.launches == 0


def _planted_mixer(x, weight, bias, ln_weight, ln_bias, eps):
    """A faulty mixer forward: the plain version with its normalized output
    scaled up by one bf16 rounding step (2^-8), as a LayerNorm whose
    variance came out a step too small would give."""
    return convnext_mixer.convnext_mixer_plain(x, weight, bias, ln_weight * (1 + 2.0 ** -8),
                                               ln_bias, eps)


def test_sample4geo_gradients_on_the_kernel_path(mixer_cuda, monkeypatch):
    """One train step's gradients at small widths on the card, with the
    mixer's kernel forward (its backward recomputes the plain version)
    against the plain mixer throughout: each weight's gradient within 0.025
    of its norm. The forwards differ by a bf16 rounding step here and there
    (test_convnext_mixer_matches_plain), which the bf16 towers carry through
    later roundings: on the H100 the largest gap read 0.0133 here (0.0149
    and 0.0200 with the batch and weights of two other seeds). A forward
    whose output is one rounding step off throughout (_planted_mixer) read
    0.0416 here, and must fail the same limit. The loss is not held: its
    gap, 0.0023 on the kernel path, grows only to 0.008 under that fault."""
    from benchmark.traffic.eval_global import make_weights
    from witw_tpu_torch.configs import Sample4GeoModelConfig, sample4geo_experiment
    from witw_tpu_torch.models.backbones import convnext
    from witw_tpu_torch.train.pipeline import make_pipeline

    cfg = sample4geo_experiment("cvusa")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, surface_height=140,
                                               surface_width_max=128, overhead_size=96),
                      model=Sample4GeoModelConfig(dims=(64, 128, 256, 512), depths=(1, 1, 2, 1)))
    pipeline = make_pipeline(cfg, mixer_cuda)
    gen = torch.Generator(device=mixer_cuda).manual_seed(7)
    batch = {"surface": torch.randint(0, 256, (4, 140, 128, 3), generator=gen,
                                      device=mixer_cuda, dtype=torch.uint8),
             "overhead": torch.randint(0, 256, (4, 96, 96, 3), generator=gen,
                                       device=mixer_cuda, dtype=torch.uint8)}
    params = make_weights(cfg.model, 9, mixer_cuda)

    def grads():
        w = {k: v.detach().clone().requires_grad_(True) for k, v in params["surface"].items()}
        loss, _ = pipeline._forward_loss({"surface": w, "overhead": w}, batch, None, train=True)
        return torch.autograd.grad(loss, list(w.values()))

    def gaps(got, want):
        return {name: float((g - p).norm() / p.norm().clamp_min(1e-30))
                for name, g, p in zip(params["surface"], got, want)}

    grads_k = grads()
    assert convnext_mixer.launches == 2 * sum(cfg.model.depths)
    with monkeypatch.context() as m:
        m.setattr(convnext_mixer, "convnext_mixer_kernel", _planted_mixer)
        grads_f = grads()
    monkeypatch.setattr(convnext, "convnext_mixer", convnext_mixer.convnext_mixer_plain)
    grads_p = grads()
    assert convnext_mixer.launches == 2 * sum(cfg.model.depths)
    kernel, planted = gaps(grads_k, grads_p), gaps(grads_f, grads_p)
    assert max(kernel.values()) < 0.025, kernel
    assert max(planted.values()) >= 0.025, planted


# The int8 profiling harness (witw_tpu_torch.exp) against the plain
# versions at the probes' shapes: bit for bit, except mmf at many reps,
# whose kernel sums each rep's dot in another order (reps * 2^-24 * max|y|).


@pytest.fixture
def probe_cuda(cuda, monkeypatch):
    for counts in (int8_isolate.launches, int8_mm_probe.launches, mosaic_caps.launches):
        for name in counts:
            monkeypatch.setitem(counts, name, 0)
    return cuda


def _s8(gen, device, *shape, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int8)


@pytest.mark.parametrize("b,h,w,c,n", [(32, 64, 256, 128, 128), (3, 16, 40, 32, 64),
                                       (2, 21, 45, 64, 96)])  # H, W past the 16 x 16 tile
def test_conv_like_matches_plain(probe_cuda, b, h, w, c, n):
    gen = torch.Generator(device=probe_cuda).manual_seed(0)
    xp = _s8(gen, probe_cuda, b, h + 2, -(-(w + 2) // 32) * 32, c)
    wmat = _s8(gen, probe_cuda, 9 * c, n, lo=-20, hi=21)
    m = torch.full((1, n), 0.001, device=probe_cuda)
    want = int8_isolate.conv_like_plain(xp, wmat, m, "full", w)
    assert want.shape == (b, h, w, n) and want.unique().numel() > 20
    for mode in int8_isolate.MODES:
        got = int8_isolate.conv_like(xp, wmat, m, mode, w)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == torch.int8
        if mode == "full":
            assert torch.equal(got, want)
        else:
            assert not got.any()
    assert int8_isolate.launches == {mode: 1 for mode in int8_isolate.MODES}


@pytest.mark.parametrize("m,k,n", [(2048, 1152, 128), (2048, 1152, 512), (256, 128, 64),
                                   (128, 4096, 128)], ids=["128", "512", "t3", "long-k"])
def test_mm_matches_plain(probe_cuda, m, k, n):
    gen = torch.Generator(device=probe_cuda).manual_seed(1)
    a, b = _s8(gen, probe_cuda, m, k), _s8(gen, probe_cuda, k, n)
    for reps in (1, 2048):  # 2048 wraps the int32 sum
        got = int8_mm_probe.mm(a, b, reps)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, int8_mm_probe.mm_plain(a, b, reps))
    assert int8_mm_probe.launches["mm"] == 2


def test_mmf_matches_plain(probe_cuda):
    gen = torch.Generator(device=probe_cuda).manual_seed(2)
    a = _s8(gen, probe_cuda, 2048, 1152).to(torch.bfloat16)
    b = _s8(gen, probe_cuda, 1152, 128).to(torch.bfloat16)
    for reps in (1, 1024):
        got, want = int8_mm_probe.mmf(a, b, reps), int8_mm_probe.mmf_plain(a, b, reps)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        if reps == 1:  # integer-valued partial sums below 2^24: exact in any order
            assert torch.equal(got, want)
        else:
            assert float((got - want).abs().max()) <= reps * 2.0 ** -24 * float(want.abs().max())
    assert int8_mm_probe.launches["mmf"] == 2


def test_mmf_without_whole_dots_exact_at_few_reps(probe_cuda):
    """Accumulated straight in the tensor core (the rate probe's variant):
    exact while every partial sum of the integer-valued inputs stays below
    2^24."""
    gen = torch.Generator(device=probe_cuda).manual_seed(2)
    a = _s8(gen, probe_cuda, 2048, 1152).to(torch.bfloat16)
    b = _s8(gen, probe_cuda, 1152, 128).to(torch.bfloat16)
    for reps in (1, 8):
        got = int8_mm_probe.mm_kernel(a, int8_mm_probe.pack_b(b), reps, whole_dots=False)
        torch.cuda.synchronize()
        assert torch.equal(got, int8_mm_probe.mmf_plain(a, b, reps))
    assert int8_mm_probe.launches["mmf"] == 2


def test_caps_match_plain(probe_cuda):
    gen = torch.Generator(device=probe_cuda).manual_seed(3)
    x, w = _s8(gen, probe_cuda, 256, 128), _s8(gen, probe_cuda, 128, 64, lo=-20, hi=21)
    slab = _s8(gen, probe_cuda, 8, 64, 128)
    for fn, plain, args in ((mosaic_caps.t1, mosaic_caps.t1_plain, (x,)),
                            (mosaic_caps.t2, mosaic_caps.t2_plain, (x,)),
                            (mosaic_caps.t3, lambda *a: int8_mm_probe.mm_plain(*a, 1), (x, w)),
                            (mosaic_caps.t4, mosaic_caps.t4_plain, (slab,))):
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert mosaic_caps.launches == {"t1": 1, "t2": 1, "t4": 1}
    assert int8_mm_probe.launches["mm"] == 1


_CAPS_RAGGED = [("t1", (37, 128)), ("t1", (1001, 96)), ("t1", (300, 1088)), ("t2", (37, 128)),
                ("t2", (1001, 96)), ("t2", (300, 1088)), ("t2", (5000, 128)), ("t4", (5, 64, 128)),
                ("t4", (3, 100, 96)), ("t4", (2, 600, 64)), ("t4", (7, 33, 1088)),
                ("t4", (5, 257, 64))]


@pytest.mark.parametrize("name,shape", _CAPS_RAGGED,
                         ids=[f"{n}-{'x'.join(map(str, s))}" for n, s in _CAPS_RAGGED])
def test_caps_ragged_match_plain(probe_cuda, name, shape):
    """Rows that fill no box (the TMA clips the stores), halves of 48 bytes
    and of 17 column chunks, W folded past a box's 256, with and without
    programmatic dependent launch."""
    gen = torch.Generator(device=probe_cuda).manual_seed(5)
    x = _s8(gen, probe_cuda, *shape)
    fn, plain = getattr(mosaic_caps, name), getattr(mosaic_caps, f"{name}_plain")
    for pdl in (True, False):
        got = fn(x, pdl=pdl)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(x))
    assert mosaic_caps.launches[name] == 2


def test_caps_slab_match_plain(probe_cuda):
    """Kernel C's block-2 slab at batch 8 of 128 ([1024, 256, 128], 32 MB):
    thousands of blocks, t4's W folded to 128 pixels a box."""
    gen = torch.Generator(device=probe_cuda).manual_seed(6)
    slab = _s8(gen, probe_cuda, 1024, 256, 128)
    rows = slab.view(-1, 128)
    for fn, plain, arg in ((mosaic_caps.t1, mosaic_caps.t1_plain, rows),
                           (mosaic_caps.t2, mosaic_caps.t2_plain, rows),
                           (mosaic_caps.t4, mosaic_caps.t4_plain, slab)):
        got = fn(arg)
        torch.cuda.synchronize()
        assert got.dtype == plain(arg).dtype and torch.equal(got, plain(arg))
    assert mosaic_caps.launches == {"t1": 1, "t2": 1, "t4": 1}


@pytest.mark.parametrize("pdl", [True, False], ids=["pdl", "no-pdl"])
def test_caps_graph_of_dependent_calls(probe_cuda, pdl):
    """A CUDA graph of back-to-back calls, each reading the one before's
    output (with PDL, a kernel's prologue overlaps the one before, and its
    griddepcontrol.wait must hold its reads until that one has written),
    replayed on new inputs."""
    gen = torch.Generator(device=probe_cuda).manual_seed(7)
    x = _s8(gen, probe_cuda, 512, 128)

    def chain():
        y = x
        for _ in range(4):
            y = mosaic_caps.t2(y, pdl=pdl)
        z = mosaic_caps.t4(mosaic_caps.t2(y, pdl=pdl).view(8, 64, 128), pdl=pdl)
        return mosaic_caps.t1(z, pdl=pdl)

    def want():
        y = x
        for _ in range(5):
            y = mosaic_caps.t2_plain(y)
        return mosaic_caps.t1_plain(mosaic_caps.t4_plain(y.view(8, 64, 128)))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain()
    for _ in range(3):
        x.copy_(_s8(gen, probe_cuda, 512, 128))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want())
    assert mosaic_caps.launches == {"t1": 2, "t2": 10, "t4": 2}  # the warm-up and the capture


def test_probe_kernels_reject_bad_inputs(probe_cuda):
    gen = torch.Generator(device=probe_cuda).manual_seed(4)
    for a_shape, b_shape in (((96, 64), (64, 64)),    # M not a multiple of 64
                             ((64, 64), (64, 96)),    # N
                             ((64, 48), (48, 64))):   # K not a multiple of 32
        with pytest.raises(ValueError):
            int8_mm_probe.mm(_s8(gen, probe_cuda, *a_shape), _s8(gen, probe_cuda, *b_shape), 1)
    with pytest.raises(ValueError):  # one int8 and one bf16 operand
        int8_mm_probe.mm_kernel(_s8(gen, probe_cuda, 64, 64),
                                _s8(gen, probe_cuda, 64, 64).to(torch.bfloat16), 1)
    xp = _s8(gen, probe_cuda, 2, 10, 64, 32)
    m = torch.full((1, 64), 0.001, device=probe_cuda)
    with pytest.raises(ValueError):  # wmat [9C, N] for another C
        int8_isolate.conv_like(xp, _s8(gen, probe_cuda, 9 * 16, 64), m, "full", 32)
    with pytest.raises(ValueError):  # the width does not fit in xp's padded columns
        int8_isolate.conv_like(xp, _s8(gen, probe_cuda, 9 * 32, 64), m, "full", 63)
    with pytest.raises(ValueError):  # C not a multiple of 32
        int8_isolate.conv_like(_s8(gen, probe_cuda, 2, 10, 64, 16), _s8(gen, probe_cuda, 9 * 16, 64),
                               m, "full", 32)
    with pytest.raises(ValueError):  # N not a multiple of 32
        int8_isolate.conv_like(xp, _s8(gen, probe_cuda, 9 * 32, 48),
                               torch.full((1, 48), 0.001, device=probe_cuda), "full", 32)
    with pytest.raises(ValueError):  # rows of t1 must be a multiple of 32 bytes
        mosaic_caps.t1(_s8(gen, probe_cuda, 4, 48))
    assert not any(int8_isolate.launches.values()) and not any(int8_mm_probe.launches.values())
    assert not any(mosaic_caps.launches.values())


# The sharded paths (witw_tpu_torch.parallel) on a mesh of the card: each
# against its single-device call on cuda:0. "cuda:0,cuda:0" is two shards on
# one card (placement, the merge, equal results); "cuda:0,cuda:1" skips
# unless the host has two cards, where it checks real cross-device placement.
# Planted maps and lattice vectors, so no rank sits on a roundoff tie.


@pytest.fixture(params=["cuda:0,cuda:0", "cuda:0,cuda:1"])
def card_mesh(request, cuda, monkeypatch):
    from witw_tpu_torch.parallel import make_mesh

    names = request.param.split(",")
    if torch.cuda.device_count() < len(set(names)):
        pytest.skip(f"needs {len(set(names))} CUDA devices")
    monkeypatch.setattr(conv3x3, "launches", 0)
    return make_mesh(devices=names)


def _planted_card_maps(n, h=2, w=32, c=4, sw=16, seed=30):
    """Each query a window of its own gallery map under noise 2: ranks spread
    over about ten values at these widths, none on a roundoff tie."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, h, w, c)).astype(np.float32)
    shifts = rng.integers(0, w, n)
    s = np.stack([o[i][:, (shifts[i] + np.arange(sw)) % w] for i in range(n)])
    return o, (s + 2.0 * rng.standard_normal(s.shape)).astype(np.float32)


@pytest.mark.parametrize("shard_gallery", [False, True], ids=["query_axis", "gallery_resident"])
@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "fft"])
def test_sharded_rank_sweeps_match_one_device(card_mesh, shard_gallery, use_fused):
    from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator

    o, s = _planted_card_maps(301)
    kw = dict(query_block=64, gallery_chunk=128, use_fused=use_fused)
    want = FovGalleryEvaluator(device=torch.device("cuda", 0), **kw).ranks(o, s)
    before = fused_match.launches
    ev = FovGalleryEvaluator(mesh=card_mesh, shard_gallery=shard_gallery, **kw)
    got = ev.ranks(o, s)
    assert len(set(want.tolist())) > 3
    np.testing.assert_array_equal(got, want)
    assert (fused_match.launches > before) == use_fused
    if shard_gallery:
        assert [p["device"] for p in ev.last_gallery_placement] == list(card_mesh.devices)
        assert [p["valid"] for p in ev.last_gallery_placement] == [256, 45]  # chunks of 128


def test_sharded_euclidean_ranks_match_one_device(card_mesh):
    from witw_tpu_torch.evaluation.gallery import euclidean_ranks

    rng = np.random.default_rng(31)
    g = rng.integers(-3, 4, (901, 8)).astype(np.float32)
    q = g[:600] + rng.integers(-3, 4, (600, 8)).astype(np.float32)
    tm = np.arange(600)
    want = euclidean_ranks(g, q, block=256, true_match=tm, device=torch.device("cuda", 0))
    got = euclidean_ranks(g, q, block=256, true_match=tm, mesh=card_mesh)
    assert len(set(want.tolist())) > 3
    np.testing.assert_array_equal(got, want)


def test_sharded_indexes_match_one_device(card_mesh):
    from witw_tpu_torch.evaluation.index import GalleryIndex
    from witw_tpu_torch.evaluation.vector_index import VectorIndex

    o, s = _planted_card_maps(1001, h=4, w=64, c=16, sw=64)
    index = GalleryIndex(o, device=torch.device("cuda", 0))
    index.place_sharded(card_mesh, gallery_chunk=256)
    i1, d1, o1 = index.search(s[:16], k=10)
    i2, d2, o2 = index.search_sharded(s[:16], k=10)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(o2, o1)
    np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-6)
    d_all, o_all = index.score_all_sharded(s[:4])
    d_one, o_one = index.score_all(s[:4])
    np.testing.assert_allclose(d_all, d_one, rtol=1e-5, atol=1e-6)
    assert float(np.mean(o_all == o_one)) > 0.999  # off-planted pairs: near ties may flip

    rng = np.random.default_rng(32)
    g = rng.integers(-3, 4, (1001, 256)).astype(np.float32)
    q = g[:16] + rng.integers(-3, 4, (16, 256)).astype(np.float32)
    vindex = VectorIndex(g, device=torch.device("cuda", 0))
    vindex.place_sharded(card_mesh, gallery_chunk=256)
    i1, d1 = vindex.search(q, k=10)
    i2, d2 = vindex.search_sharded(q, k=10)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vindex.score_all_sharded(q), vindex.score_all(q), rtol=1e-5,
                               atol=1e-6)


def _planted_pairs(rng, sizes, h, w, side):
    """Blocky overhead tiles [b, side, side, 3] and surfaces that are their
    own tile's polar panorama [b, h, w, 3] under noise growing to 0.3 x
    128: with tied towers each query's true match is planted apart from the
    rest (tests/test_torch_slice.py's pairs)."""
    from witw_tpu_torch.ops.polar import polar_transform

    n = sum(sizes)
    coarse = rng.uniform(0, 255, (n, 4, 4, 3))
    over = np.repeat(np.repeat(coarse, side // 4, axis=1), side // 4, axis=2).astype(np.float32)
    pol = polar_transform(torch.from_numpy(over), h, w).numpy()
    noise = np.linspace(0.0, 0.3, n)[:, None, None, None] * 128.0
    surf = np.clip(pol + noise * rng.standard_normal(pol.shape), 0, 255).astype(np.float32)
    starts = np.cumsum((0,) + tuple(sizes))
    return [{"surface": surf[a:b], "overhead": over[a:b]} for a, b in zip(starts, starts[1:])]


def test_embed_all_and_test_on_a_card_mesh(card_mesh):
    """bf16 FOV towers (the conv kernel) on planted pairs in batches of 8, 8
    and a straggler of 5 that the mesh does not divide: embed_all(mesh=)
    within bf16 rounding of one device's (cuDNN's stride-2 head convs may
    pick another algorithm at another batch size), and loop.test on the
    mesh, both sweeps through the fused match, ranks equal to one device's."""
    from witw_tpu_torch.train import loop

    ds = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True)
    data = DataConfig(dataset=ds, surface_height=32, surface_width_max=64, overhead_size=32)
    cfg = ExperimentConfig(data=data, model=FovDsmModelConfig())
    pipeline = FovPipeline(cfg, torch.device("cuda", 0))
    tower = pipeline.init(torch.Generator().manual_seed(0))["overhead"]
    params = {"surface": tower, "overhead": tower}
    batches = _planted_pairs(np.random.default_rng(33), (8, 8, 5), 32, 64, 32)
    s_one, o_one = loop.embed_all(pipeline, params, batches)
    conv_before = conv3x3.launches
    s_m, o_m = loop.embed_all(pipeline, params, batches, mesh=card_mesh)
    assert conv3x3.launches > conv_before
    assert s_m.shape == s_one.shape and s_m.device == card_mesh.devices[0]
    torch.testing.assert_close(s_m, s_one, rtol=1e-2, atol=1e-2)  # bf16 towers
    torch.testing.assert_close(o_m, o_one, rtol=1e-2, atol=1e-2)
    _, want = loop.test_ranks(cfg, pipeline, batches, params, verbose=False)
    assert len(set(want.tolist())) > 1
    for shard_gallery in (False, True):
        c = cfg.replace(eval=dataclasses.replace(cfg.eval, shard_gallery=shard_gallery))
        before = fused_match.launches
        _, got = loop.test_ranks(c, pipeline, batches, params, verbose=False, mesh=card_mesh)
        assert fused_match.launches > before
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b", [8, 7], ids=["full", "straggler"])
def test_dp_train_step_on_a_card_mesh(card_mesh, b):
    """The data-parallel bf16 FOV train step (dropout on, crops drawn, the
    conv kernel in each shard's forward) on the card mesh against one
    device's step on the same batch, seed and params, with chip_smoke.py
    [31]'s tolerances: the loss within rtol 1e-3, every gradient tensor at
    cosine >= 0.999 and a norm ratio within 1e-2 of 1 (bf16 towers round
    otherwise at another batch size)."""
    from witw_tpu_torch.train import loop

    ds = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True)
    data = DataConfig(dataset=ds, surface_height=32, surface_width_max=64, overhead_size=32)
    cfg = ExperimentConfig(data=data, model=FovDsmModelConfig())
    pipeline = FovPipeline(cfg, torch.device("cuda", 0))
    rng = np.random.default_rng(5)
    batch = {"surface": rng.integers(0, 256, (b, 32, 64, 3), np.uint8),
             "overhead": rng.integers(0, 256, (b, 32, 32, 3), np.uint8)}
    (gb, count), = list(loop.device_prefetch([batch], None, mesh=card_mesh))
    assert count == b and gb.rows == 8
    runs = []
    for data_in in (batch, gb):
        state = pipeline.init_state(torch.Generator().manual_seed(0))
        before = conv3x3.launches
        state, metrics = pipeline.train_step(state, data_in, torch.Generator().manual_seed(3))
        assert conv3x3.launches > before
        grads = {f"{t}/{k}": p.grad.double() for t in state.params
                 for k, p in state.params[t].items() if p.grad is not None}
        runs.append((float(metrics["loss"]), grads))
    (l_one, g_one), (l_dp, g_dp) = runs
    np.testing.assert_allclose(l_dp, l_one, rtol=1e-3)
    for name, w in g_one.items():
        g = g_dp[name]
        assert float(g.flatten() @ w.flatten() / (g.norm() * w.norm())) >= 0.999, name
        assert abs(float(g.norm() / w.norm()) - 1.0) <= 1e-2, name


def test_nccl_collectives_take_host_tensors(cuda, monkeypatch):
    """A one-process NCCL group on the card: NCCL refuses a host tensor,
    and the collectives' staged copies of host counts, masks, rows and
    bf16 values (on the current CUDA device) go through it and come back
    to the host unchanged."""
    import socket

    import torch.distributed as dist

    from witw_tpu_torch.parallel import collectives, initialize_distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("LOCAL_RANK", "0")
    initialize_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl", timeout=60)
    try:
        assert dist.get_backend() == "nccl"
        assert collectives.stage_device() == torch.device("cuda", 0)
        with pytest.raises(Exception):
            dist.all_reduce(torch.ones(3))
            torch.cuda.synchronize()
        for t in (torch.tensor([5, 7]), torch.tensor([1, 0, 1], dtype=torch.uint8),
                  torch.arange(12.0).view(3, 4), torch.arange(6.0).to(torch.bfloat16)):
            staged = collectives._staged(t)
            assert staged.device == torch.device("cuda", 0)
            dist.all_reduce(staged)
            out = [torch.empty_like(staged)]
            dist.all_gather(out, staged)
            assert torch.equal(out[0].to("cpu", t.dtype), t)
            assert torch.equal(staged.to("cpu", t.dtype), t)
        views = [None]
        dist.all_gather_object(views, {"rows": 3})
        assert views == [{"rows": 3}]
        box = [("epoch", 2)]
        dist.broadcast_object_list(box, src=0)
        assert box == [("epoch", 2)]
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- dataset tools


def _u16_raster(seed, shape):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 4000, shape).astype(np.uint16)
    img[: shape[0] // 8] = 0
    return img


def test_convert_8bit_on_the_card_matches_cpu(cuda):
    from witw_tpu_torch.tools import convert_8bit

    img = _u16_raster(0, (700, 500, 3))
    for b in range(3):
        assert convert_8bit.band_percentiles(img[..., b], device=cuda) == \
            convert_8bit.band_percentiles(img[..., b], device="cpu")
        f = img[..., b].astype(np.float32)
        assert convert_8bit.band_percentiles(f, device=cuda) == \
            convert_8bit.band_percentiles(f, device="cpu")
    for kw in ({}, {"rescale": "clip"}):
        np.testing.assert_array_equal(convert_8bit.rescale_to_u8(img, device=cuda, **kw),
                                      convert_8bit.rescale_to_u8(img, device="cpu", **kw))
    got = convert_8bit.rescale_to_u8(img, gamma=2.2, device=cuda).astype(int)
    want = convert_8bit.rescale_to_u8(img, gamma=2.2, device="cpu").astype(int)
    assert np.abs(got - want).max() <= 1 and (got != want).mean() <= 1e-4
    assert convert_8bit.zero_fraction(img, device=cuda) == convert_8bit.zero_fraction(img, device="cpu")


def test_reproject_on_the_card_matches_cpu(cuda, tmp_path):
    from witw_tpu_torch.tools import geotiff, reproject

    rng = np.random.default_rng(1)
    lat, lon = 48.8566, 2.3522
    gt = np.array([lon, 0.3 / (111320 * np.cos(np.radians(lat))), 0, lat, 0, -0.3 / 111132])
    src = str(tmp_path / "src.tif")
    geotiff.write_geotiff_u8(src, rng.integers(0, 256, (300, 280, 3), dtype=np.uint8), gt, 4326)
    outs = {}
    for dev in (cuda, "cpu"):
        path = str(tmp_path / f"{torch.device(dev).type}.tif")
        reproject.reproject_to_utm(src, path, 32631, block=128, device=dev)
        with geotiff.GeoTiff(path) as tif:
            outs[torch.device(dev).type] = (tif.read().astype(int), list(tif.geotransform))
    assert outs["cuda"][1] == outs["cpu"][1]
    diff = np.abs(outs["cuda"][0] - outs["cpu"][0])
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    e = torch.tensor(rng.uniform(4.4e5, 4.6e5, 1000), dtype=torch.float64)
    n = torch.tensor(rng.uniform(5.40e6, 5.42e6, 1000), dtype=torch.float64)
    la_g, lo_g = reproject._utm_to_wgs84_vec(e.to(cuda), n.to(cuda), 32631)
    la_c, lo_c = reproject._utm_to_wgs84_vec(e, n, 32631)
    assert (la_g.cpu() - la_c).abs().max() <= 1e-10 and (lo_g.cpu() - lo_c).abs().max() <= 1e-10
    e_g, n_g = reproject._wgs84_to_utm_vec(la_c.to(cuda), lo_c.to(cuda), 32631)
    e_c, n_c = reproject._wgs84_to_utm_vec(la_c, lo_c, 32631)
    assert (e_g.cpu() - e_c).abs().max() <= 1e-6 and (n_g.cpu() - n_c).abs().max() <= 1e-6


def test_road_masks_and_classifiers_on_the_card_match_cpu(cuda, tmp_path):
    from PIL import Image

    from witw_tpu_torch.tools import build_dataset, semantic_masks

    rng = np.random.default_rng(2)
    tile = rng.integers(0, 256, (750, 750, 3)).astype(np.float32)
    tile[300:400] = 120.0
    got = semantic_masks.heuristic_road_mask(tile, device=cuda)
    want = semantic_masks.heuristic_road_mask(tile, device="cpu")
    assert np.abs(got - want).max() <= 2e-4
    torch.manual_seed(0)
    torch.save(torch.nn.Conv2d(3, 1, 3, padding=1), tmp_path / "seg.pth")
    masks = [semantic_masks.minmax_normalize(semantic_masks.torch_segmenter(
        str(tmp_path / "seg.pth"), dev)(torch.from_numpy(tile[:64, :64]))).cpu()
        for dev in (cuda, "cpu")]
    assert masks[0].shape == (64, 64) and (masks[0] - masks[1]).abs().max() <= 1e-5
    model = torch.nn.Sequential(torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
                                torch.nn.Linear(3, 2))
    with torch.no_grad():
        model[2].weight.copy_(torch.tensor([[-1.0] * 3, [1.0] * 3]))
        model[2].bias.zero_()
    torch.save(model, tmp_path / "places.pth")
    (tmp_path / "io.txt").write_text("indoor 1\noutdoor 2\n")
    for i, level in enumerate((10, 240)):
        Image.fromarray(np.full((40, 60, 3), level, np.uint8)).save(tmp_path / f"{i}.jpg")
    on_card, on_cpu = (build_dataset.torch_indoor_classifier(
        str(tmp_path / "places.pth"), str(tmp_path / "io.txt"), device=dev) for dev in (cuda, "cpu"))
    assert [on_card(str(tmp_path / f"{i}.jpg")) for i in range(2)] == \
        [on_cpu(str(tmp_path / f"{i}.jpg")) for i in range(2)] == [True, False]


def test_density_on_the_card_matches_cpu(cuda):
    from witw_tpu_torch.tools import density

    rng = np.random.default_rng(3)
    n = 1500
    aoi = np.empty(n, object)
    aoi[:] = list(rng.choice(["paris", "vegas"], n))
    table = {"aoi": aoi, "id": np.arange(n), "latitude": 48.85 + rng.uniform(0, 2e-3, n),
             "longitude": 2.35 + rng.uniform(0, 2e-3, n)}
    got = density.limit_density(table, 12.0, seed=4, device=cuda)
    want = density.limit_density(table, 12.0, seed=4, device="cpu")
    assert list(got["id"]) == list(want["id"])


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.bfloat16])
def test_public_names_on_the_card_match_cpu(cuda, dtype):
    """ops.resize_bilinear (NHWC and HWC; f32 within 1e-4 on [0, 255] data,
    bf16 within one bf16 ulp), match.orientation_estimate (bit-equal on
    tie-free data) and the materialized oracle (the crop bit-equal, the
    distances within rtol 1e-5 / atol 1e-6) on the card against the CPU."""
    from witw_tpu_torch.match import (chord_distance_materialized, crop_overhead_materialized,
                                      orientation_estimate)
    from witw_tpu_torch.ops import resize_bilinear

    g = torch.Generator().manual_seed(3)
    x = (torch.rand(2, 30, 41, 3, generator=g) * 255.0).to(dtype)
    for inp, size in ((x, (17, 64)), (x[0], (45, 20))):
        got, want = resize_bilinear(inp.to(cuda), *size), resize_bilinear(inp, *size)
        assert got.dtype == want.dtype == (dtype if dtype.is_floating_point else torch.float32)
        err = (got.cpu().float() - want.float()).abs()
        if dtype == torch.bfloat16:
            ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
            assert bool((err <= ulp).all())
        else:
            assert float(err.max()) <= 1e-4

    corr = torch.randn(5, 7, 16, generator=g)
    top = torch.topk(corr, 2, dim=-1).values
    assert bool((top[..., 0] > top[..., 1]).all())
    orient = orientation_estimate(corr.to(cuda))
    assert orient.dtype == torch.int32
    assert torch.equal(orient.cpu(), orientation_estimate(corr))

    o, s = torch.randn(5, 2, 16, 4, generator=g), torch.randn(7, 2, 9, 4, generator=g)
    crop = crop_overhead_materialized(o.to(cuda), orient, 9)
    crop_cpu = crop_overhead_materialized(o, orient.cpu(), 9)
    assert torch.equal(crop.cpu(), crop_cpu)
    torch.testing.assert_close(chord_distance_materialized(crop, s.to(cuda)).cpu(),
                               chord_distance_materialized(crop_cpu, s), rtol=1e-5, atol=1e-6)


def test_span_device_stretch_encloses_its_kernels(cuda):
    """Under the benchmark's CUDA-only profiler a span's device stretch holds
    the device time of the kernels it launched, a child's stretch lies within
    its parent's, and its host stamps (``time.time_ns``) enclose the
    launches; a span opened without ``stretch`` has none."""
    from witw_tpu_torch.utils.profiling import reset, span, spans

    a = torch.randn(2048, 2048, device=cuda)
    (a @ a).sum().item()
    reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with span("outer", stretch=True):
            with span("mm", stretch=True):
                for _ in range(4):
                    b = a @ a
            with span("sum"):
                b.sum()
        torch.cuda.synchronize()
    outer, mm, plain = spans()
    assert (outer.parent, mm.parent, mm.root, plain.parent) == (None, 0, 0, 0)
    assert plain.device_s is None and plain.end_ns <= outer.end_ns
    events = list(prof.profiler.kineto_results.events())
    on_card = torch.autograd.DeviceType.CUDA
    gemms = [e for e in events if e.device_type() == on_card and not e.is_user_annotation()
             and "gemm" in e.name().lower()]
    launches = [e for e in events if e.device_type() != on_card and "Launch" in e.name()
                and mm.start_ns <= e.start_ns() < mm.end_ns]
    assert len(gemms) >= 4 and len(launches) >= 4
    assert all(e.start_ns() + e.duration_ns() <= mm.end_ns for e in launches)
    assert sum(e.duration_ns() for e in gemms) * 1e-9 <= mm.device_s * 1.001
    assert 0 < mm.device_s <= outer.device_s


def _preset_batch(cfg, b, seed):
    """A raw uint8 batch and crop origins at ``cfg``'s full input sizes."""
    d = cfg.data
    gen = torch.Generator().manual_seed(seed)
    batch = {"surface": torch.randint(0, 256, (b, d.surface_height, d.surface_width_max,
                                                d.channels), generator=gen, dtype=torch.uint8),
             "overhead": torch.randint(0, 256, (b, d.overhead_size, d.overhead_size, d.channels),
                                       generator=gen, dtype=torch.uint8)}
    return batch, torch.randint(0, d.surface_width_max, (b,), generator=gen)


def _presets():
    from witw_tpu_torch.configs import fov_experiment, safa_experiment

    return {"fov_dsm": fov_experiment("cvusa", 360), "safa": safa_experiment("cvusa")}


@pytest.mark.parametrize("preset", ["fov_dsm", "safa"])
def test_warm_preprocess_on_the_card_makes_no_sync(cuda, preset):
    """After one warm call, ``preprocess`` of a batch already on the card
    runs under ``set_sync_debug_mode("error")`` (no host-device copy, no
    stream sync) and builds no normalization constants; its outputs equal
    the CPU's within the preprocessing ops' tolerances (rtol 1e-5, atol
    1e-4)."""
    from witw_tpu_torch.ops import image
    from witw_tpu_torch.train.pipeline import make_pipeline

    cfg = _presets()[preset]
    batch, starts = _preset_batch(cfg, 4, seed=11)
    pipeline = make_pipeline(cfg, cuda)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    draws = starts.to(cuda)
    pipeline.preprocess(on_card, draws=draws)
    torch.cuda.synchronize()
    uploads = image.constant_uploads
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pipeline.preprocess(on_card, draws=draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert image.constant_uploads == uploads
    want = make_pipeline(cfg, "cpu").preprocess(batch, draws=starts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("preset", ["fov_dsm", "safa"])
def test_warm_embed_step_on_the_card_makes_no_sync(cuda, preset):
    """A warm ``embed_step`` (preprocess, then both bf16 towers on the
    port's kernels) makes no host-device copy or stream sync either."""
    from witw_tpu_torch.ops import image
    from witw_tpu_torch.train.pipeline import make_pipeline

    cfg = _presets()[preset]
    batch, starts = _preset_batch(cfg, 4, seed=12)
    pipeline = make_pipeline(cfg, cuda)
    params = pipeline.init(torch.Generator().manual_seed(0))
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    draws = starts.to(cuda)
    pipeline.embed_step(params, on_card, draws=draws)
    torch.cuda.synchronize()
    uploads, launches = image.constant_uploads, conv3x3.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_emb, o_emb = pipeline.embed_step(params, on_card, draws=draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert image.constant_uploads == uploads and conv3x3.launches > launches
    assert bool(torch.isfinite(s_emb).all()) and bool(torch.isfinite(o_emb).all())


def test_warm_sample4geo_embed_step_on_the_card(cuda):
    """The Sample4Geo family at the preset's geometry and published widths on
    the card: a warm ``embed_step`` makes no host-device copy or stream sync,
    launches the ConvNeXt mixer kernel once a block (36 an encoder call, two
    calls) and no other kernel of the port, and its unit embeddings are
    within the bf16 tolerance of tests/test_torch_convnext.py (0.03 of an
    embedding) of the float32 reference's."""
    from benchmark import reference
    from benchmark.reference import convnext as ref
    from benchmark.reference import preprocess as ref_pre
    from benchmark.traffic.eval_global import make_weights
    from witw_tpu_torch.configs import sample4geo_experiment
    from witw_tpu_torch.train.pipeline import make_pipeline

    cfg = sample4geo_experiment("cvusa")
    d = cfg.data
    g = torch.Generator(device=cuda).manual_seed(3)
    batch = {"surface": torch.randint(0, 256, (4, d.surface_height, d.surface_width_max, 3),
                                      generator=g, device=cuda, dtype=torch.uint8),
             "overhead": torch.randint(0, 256, (4, d.overhead_size, d.overhead_size, 3),
                                       generator=g, device=cuda, dtype=torch.uint8)}
    pipeline = make_pipeline(cfg, cuda)
    params = make_weights(cfg.model, 5, cuda)
    pipeline.embed_step(params, batch)
    torch.cuda.synchronize()
    launches, mixers = conv3x3.launches, convnext_mixer.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_emb, o_emb = pipeline.embed_step(params, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert conv3x3.launches == launches and s_emb.shape == o_emb.shape == (4, 1024)
    assert sum(cfg.model.depths) == 36 and convnext_mixer.launches - mixers == 2 * 36
    with torch.no_grad(), reference.exact():
        for got, view in ((s_emb, "surface"), (o_emb, "overhead")):
            x = ref_pre.normalize(batch[view], d.img_mean, d.img_std).permute(0, 3, 1, 2)
            want = ref.encoder(x.contiguous(), params["surface"], cfg.model.depths)
            assert float(((got - want).norm(dim=1) / want.norm(dim=1)).max()) < 0.03
