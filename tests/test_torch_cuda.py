"""Card tests of the port's CUDA kernels (the fused match, the three
static-int8 kernels, the bf16 conv + bias + ReLU and the int8 profiling
harness's three) and of the baseline family's int8 convs on
``torch._int_mm``; each skips without a CUDA device. This file imports no JAX, so it also runs where JAX is absent:

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
from witw_tpu_torch.ops import conv3x3, fused_block2, fused_match, int8_conv, maxpool
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


@pytest.mark.parametrize("b,h,w,c,n", [(32, 64, 256, 128, 128), (3, 16, 40, 32, 64)])
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


@pytest.mark.parametrize("n", [128, 512])
def test_mm_matches_plain(probe_cuda, n):
    gen = torch.Generator(device=probe_cuda).manual_seed(1)
    a, b = _s8(gen, probe_cuda, 2048, 1152), _s8(gen, probe_cuda, 1152, n)
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


def test_probe_kernels_reject_bad_inputs(probe_cuda):
    gen = torch.Generator(device=probe_cuda).manual_seed(4)
    for a_shape, b_shape in (((96, 64), (64, 64)),    # M not a multiple of 64
                             ((64, 64), (64, 96)),    # N
                             ((64, 48), (48, 64))):   # K not a multiple of 32
        with pytest.raises(ValueError):
            int8_mm_probe.mm(_s8(gen, probe_cuda, *a_shape), _s8(gen, probe_cuda, *b_shape), 1)
    with pytest.raises(ValueError):  # K too long for shared memory
        int8_mm_probe.mm(_s8(gen, probe_cuda, 64, 4096), _s8(gen, probe_cuda, 4096, 64), 1)
    xp = _s8(gen, probe_cuda, 2, 10, 64, 32)
    m = torch.full((1, 64), 0.001, device=probe_cuda)
    with pytest.raises(ValueError):  # wmat [9C, N] for another C
        int8_isolate.conv_like(xp, _s8(gen, probe_cuda, 9 * 16, 64), m, "full", 32)
    with pytest.raises(ValueError):  # the width does not fit in xp's padded columns
        int8_isolate.conv_like(xp, _s8(gen, probe_cuda, 9 * 32, 64), m, "full", 63)
    with pytest.raises(ValueError):  # rows of t1 must be a multiple of 32 bytes
        mosaic_caps.t1(_s8(gen, probe_cuda, 4, 48))
    assert not any(int8_isolate.launches.values()) and not any(int8_mm_probe.launches.values())
    assert not any(mosaic_caps.launches.values())
