"""The Sample4Geo family (ConvNeXt encoder shared by both views) against the
plain float32 reference ``benchmark/reference/convnext.py``, on the CPU.

Small widths (dims 16, 32, 64, 128) at the published kernel, MLP ratio and
eps; weights from the benchmark's draw (``benchmark.traffic.eval_global
.make_weights``: the layer scale of the order of the residual stream, the
LayerNorm affines and the biases away from 1 and 0). Tolerances:

- float32 port against the float32 reference: rtol 1e-4 and atol 1e-5 of
  the output's scale. Both compute the same sums; they differ in the order
  of a conv's or a product's sum (channels_last against NCHW kernels) and in
  the residual add, fused with the layer scale in one multiply-add, so some
  ulps of f32 per layer, compounded over at most a few blocks.
- bfloat16 port against the float32 reference: relative error 0.03 of an
  embedding. Each conv and linear rounds its operands to bf16 (2^-9
  relative), about five roundings a block, over six blocks and a head;
  the measured error is 0.015.
- the loss and its gradients in float32: rtol 1e-4, atol 1e-6 (the
  reference normalizes the unit embeddings again, a no-op to f32 ulps).
- the bf16 mixer (``ops.convnext_mixer``) against the reference's float32
  mixer on the same bf16-rounded input and weight: rtol 2^-8, one bf16
  rounding of the output, atol 1e-5 of its scale for the f32 sums' order.
- a bf16 block against its output before the mixer was fused (the conv's
  sum rounded to bf16 on its way into the LayerNorm, as autocast ran it):
  relative error 0.01 of the block's change to its input. That one extra
  rounding (2^-9 relative) moves some mixer outputs by a bf16 ulp, which
  fc1 and fc2 carry at bf16 precision; measured 0.0049.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.reference import convnext as ref
from benchmark.reference import preprocess as ref_pre
from benchmark.traffic.eval_global import make_weights
from witw_tpu_torch.configs import Sample4GeoModelConfig, sample4geo_experiment
from witw_tpu_torch.configs.serialize import load_config, save_config
from witw_tpu_torch.evaluation.gallery import euclidean_ranks
from witw_tpu_torch.models.backbones import convnext
from witw_tpu_torch.models.backbones.convnext import Block, Stage
from witw_tpu_torch.ops import convnext_mixer as mixer_ops
from witw_tpu_torch.models.sample4geo import Sample4Geo
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.pipeline import Sample4GeoPipeline, make_pipeline

ROOT = Path(__file__).resolve().parents[1]
DIMS = (16, 32, 64, 128)
DEPTHS = (1, 1, 3, 1)
# 140 rows, as the preset's panorama: 35 after the stem, then 17, 8, 4.
GEOMETRY = dict(surface_height=140, surface_width_max=64, overhead_size=64)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 0.03


def _model(dtype="float32", **kw):
    return Sample4GeoModelConfig(dims=DIMS, depths=kw.pop("depths", DEPTHS),
                                 compute_dtype=dtype, **kw)


def _cfg(dtype="float32", **model):
    cfg = sample4geo_experiment("cvusa")
    return cfg.replace(data=dataclasses.replace(cfg.data, **GEOMETRY), model=_model(dtype, **model),
                       eval=dataclasses.replace(cfg.eval, batch_size=3),
                       train=dataclasses.replace(cfg.train, batch_size=4))


def _weights(m, seed=5):
    return make_weights(m, seed, "cpu")["surface"]


def _sub(w, prefix):
    return {k[len(prefix) + 1:]: v for k, v in w.items() if k.startswith(prefix + ".")}


def _pixels(b, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, h, w, 3), generator=g, dtype=torch.uint8)


def _ref_input(u8, d):
    return ref_pre.normalize(u8, d.img_mean, d.img_std).permute(0, 3, 1, 2).contiguous()


def _close(got, want, rtol, atol):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol * scale)


def _rel(got, want):
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def test_block_against_reference():
    w = _weights(_model())
    name = "model.stages.2.blocks.1"
    block = Block(64, 7, 4, 1e-6, torch.float32)
    block.load_state_dict(_sub(w, name))
    x = torch.randn(2, 64, 9, 11, generator=torch.Generator().manual_seed(1))
    got = block(x.contiguous(memory_format=torch.channels_last))
    with torch.no_grad():
        want = ref.block(x, w, name)
        _close(got.detach(), want, **F32_TOL)
        assert _rel(got.detach().flatten(1), x.flatten(1)) > 0.1  # the block does something


def test_stage_rounds_odd_sizes_down():
    """A stage on a 35 x 13 map: the downsample gives 17 x 6, as the
    reference's."""
    w = _weights(_model())
    name = "model.stages.1"
    stage = Stage(16, 32, 1, 7, 4, 1e-6, torch.float32)
    stage.load_state_dict(_sub(w, name))
    x = torch.randn(2, 16, 35, 13, generator=torch.Generator().manual_seed(2))
    got = stage(x.contiguous(memory_format=torch.channels_last)).detach()
    with torch.no_grad():
        want = ref.conv(ref.layer_norm_channels(x, w, f"{name}.downsample.0"), w,
                        f"{name}.downsample.1", stride=2)
        want = ref.block(want, w, f"{name}.blocks.0")
    assert got.shape == want.shape == (2, 32, 17, 6)
    _close(got, want, **F32_TOL)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _mixer_case(b, h, w, c, seed):
    """An NHWC input and a block's mixer weights from the benchmark's draw,
    at C channels (stage 2's block 1 of a model whose third width is C)."""
    wts = _weights(Sample4GeoModelConfig(dims=(16, 32, c, 128), depths=DEPTHS))
    name = "model.stages.2.blocks.1"
    x = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(seed))
    return x, wts, name


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c", [
    (2, 35, 192, 32),  # the panorama's stage-0 map at reduced C
    (2, 17, 96, 64),  # and stage 1's, after the downsample rounds 35 down
    (1, 7, 9, 96),  # a map smaller than the 7x7 window's reach; C not a power of 2
    (2, 4, 24, 128),  # the panorama's last stage map, fewer rows than the window
])
def test_mixer_plain_against_reference(in_dtype, b, h, w, c):
    """The plain mixer against the reference's float32 depthwise conv and
    LayerNorm: in bf16 on the bf16-rounded input and weight (one rounding
    of the output apart), in f32 on the input as given."""
    x, wts, name = _mixer_case(b, h, w, c, seed=3)
    x = x.to(in_dtype)
    args = (wts[f"{name}.conv_dw.weight"], wts[f"{name}.conv_dw.bias"],
            wts[f"{name}.norm.weight"], wts[f"{name}.norm.bias"], 1e-6)
    for dtype, quantize in ((torch.bfloat16, _bf16), (torch.float32, None)):
        got = mixer_ops.convnext_mixer_plain(x, *args, dtype=dtype)
        assert got.dtype == dtype and got.shape == (b, h, w, c)
        with torch.no_grad():
            want = ref.conv(x.float().permute(0, 3, 1, 2), wts, f"{name}.conv_dw", padding=3,
                            groups=c, quantize=quantize)
            want = ref.layer_norm_channels(want, wts, f"{name}.norm").permute(0, 2, 3, 1)
        if dtype == torch.bfloat16:
            _close(got.float(), want, rtol=2.0 ** -8, atol=1e-5)
        else:
            _close(got, want, **F32_TOL)
    # the CPU path of the public wrapper is the bf16 plain version
    torch.testing.assert_close(mixer_ops.convnext_mixer(x, *args),
                               mixer_ops.convnext_mixer_plain(x, *args), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,in_dtype", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16),  # a stage's first block, after the downsample
])
def test_block_against_its_previous_output(monkeypatch, dtype, in_dtype):
    """A block on the CPU against its output before the mixer was fused:
    the same in f32 bit for bit; in bf16 within 0.01 of the block's change
    (the conv's sum no longer rounded to bf16 before the LayerNorm)."""
    x, wts, name = _mixer_case(2, 17, 23, 64, seed=4)
    block = Block(64, 7, 4, 1e-6, dtype)
    block.load_state_dict(_sub(wts, name))
    x = x.to(in_dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = block(x)
        monkeypatch.setattr(convnext, "convnext_mixer", mixer_ops.convnext_mixer_library)
        monkeypatch.setattr(convnext, "convnext_mixer_plain", mixer_ops.convnext_mixer_library)
        before = block(x)
    if dtype == torch.float32:
        torch.testing.assert_close(got, before, rtol=0, atol=0)
        return
    change = (before - x.float()).flatten(1)
    err = float(((got - before).flatten(1).norm(dim=1) / change.norm(dim=1)).max())
    assert 0 < err < 0.01


@pytest.mark.parametrize("needs", ["all", "input", "weights"])
def test_mixer_backward_is_the_plain_versions(monkeypatch, needs):
    """The autograd Function's backward (the plain version recomputed under
    autograd) gives autograd's gradients of the plain version, for whichever
    inputs want one. Its forward's kernel is the plain version here."""
    monkeypatch.setattr(mixer_ops, "convnext_mixer_kernel", mixer_ops.convnext_mixer_plain)
    x, wts, name = _mixer_case(2, 9, 11, 32, seed=5)
    tensors = [x, *(wts[f"{name}.{k}"] for k in ("conv_dw.weight", "conv_dw.bias",
                                                    "norm.weight", "norm.bias"))]
    want_grad = {"all": [True] * 5, "input": [True] + [False] * 4,
                 "weights": [False] + [True] * 4}[needs]
    g = torch.randn(2, 9, 11, 32, generator=torch.Generator().manual_seed(6)).to(torch.bfloat16)
    grads = []
    for fn in (mixer_ops._ConvNeXtMixer.apply, mixer_ops.convnext_mixer_plain):
        ins = [t.detach().clone().requires_grad_(w) for t, w in zip(tensors, want_grad)]
        y = fn(*ins, 1e-6)
        assert y.dtype == torch.bfloat16
        y.backward(g)
        grads.append([t.grad for t in ins])
    for got, want, w in zip(*grads, want_grad):
        assert (got is None) == (not w)
        if w:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert float(want.abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_against_reference(dtype):
    """The whole encoder on 140-row panoramas (35 -> 17 -> 8 -> 4) and
    64^2 tiles."""
    m = _model(dtype)
    w = _weights(m)
    enc = Sample4Geo(m)
    enc.load_state_dict(w)
    d = _cfg().data
    for u8 in (_pixels(3, 140, 64), _pixels(3, 64, 64, seed=1)):
        x = _ref_input(u8, d)
        with torch.no_grad():
            got = enc(x.to(getattr(torch, dtype)).contiguous(memory_format=torch.channels_last))
            want = ref.encoder(x, w, DEPTHS)
        assert got.dtype == torch.float32 and got.shape == (3, 128)
        if dtype == "float32":
            _close(got, want, **F32_TOL)
        else:
            assert _rel(got, want) < BF16_TOL


def test_embed_step_against_reference():
    """uint8 NHWC batches through the pipeline, one encoder for both views."""
    cfg = _cfg()
    pipe = make_pipeline(cfg, "cpu")
    assert isinstance(pipe, Sample4GeoPipeline) and pipe.surface_model is pipe.overhead_model
    params = make_weights(cfg.model, 7, "cpu")
    assert params["surface"] is params["overhead"]
    batch = {"surface": _pixels(3, 140, 64, 3), "overhead": _pixels(3, 64, 64, 4)}
    s, o = pipe.embed_step(params, batch)
    w = params["surface"]
    with torch.no_grad():
        want_s = ref.encoder(_ref_input(batch["surface"], cfg.data), w, DEPTHS)
        want_o = ref.encoder(_ref_input(batch["overhead"], cfg.data), w, DEPTHS)
    _close(s, want_s, **F32_TOL)
    _close(o, want_o, **F32_TOL)
    torch.testing.assert_close(s.norm(dim=1), torch.ones(3))


def test_preprocess_is_normalize_to_channels_last():
    cfg = _cfg("bfloat16")
    pipe = make_pipeline(cfg, "cpu")
    batch = {"surface": _pixels(2, 140, 64), "overhead": _pixels(2, 64, 64, 1)}
    for got, u8 in zip(pipe.preprocess(batch), (batch["surface"], batch["overhead"])):
        assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
        # one bf16 step at most: the port scales by 1/255, the reference divides by 255
        want = _ref_input(u8, cfg.data).to(torch.bfloat16)
        torch.testing.assert_close(got, want, rtol=2.0 ** -8, atol=0.0)
    assert pipe.draw(torch.Generator(), 2) is None


def test_loss_and_gradients_against_reference():
    """The symmetric InfoNCE loss of a batch and its gradients in every
    weight (both views' sums into the one set) and the logit scale,
    against the reference's autograd."""
    cfg = _cfg()
    pipe = make_pipeline(cfg, "cpu")
    params = make_weights(cfg.model, 9, "cpu")
    for p in params["surface"].values():
        p.requires_grad_(True)
    batch = {"surface": _pixels(4, 140, 64, 5), "overhead": _pixels(4, 64, 64, 6)}
    loss, _ = pipe._forward_loss(params, batch, None, train=True)
    grads = torch.autograd.grad(loss, list(params["surface"].values()))
    w = {k: v.detach().clone().requires_grad_(True) for k, v in params["surface"].items()}
    want = ref.infonce(ref.encoder(_ref_input(batch["surface"], cfg.data), w, DEPTHS),
                       ref.encoder(_ref_input(batch["overhead"], cfg.data), w, DEPTHS),
                       w["logit_scale"], cfg.model.label_smoothing)
    want_grads = torch.autograd.grad(want, list(w.values()))
    torch.testing.assert_close(loss.detach(), want.detach(), rtol=1e-4, atol=1e-6)
    for name, g, wg in zip(w, grads, want_grads):
        torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6 + 1e-4 * float(wg.abs().max()),
                                   msg=name)
    assert float(want_grads[list(w).index("logit_scale")].abs()) > 0


def test_train_step_steps_the_shared_weights_once():
    cfg = _cfg()
    pipe = make_pipeline(cfg, "cpu")
    state = pipe.init_state(torch.Generator().manual_seed(0))
    assert state.params["surface"] is state.params["overhead"]
    n = len(state.params["surface"])
    assert len(state.optimizer.param_groups[0]["params"]) == n
    before = {k: v.detach().clone() for k, v in state.params["surface"].items()}
    batch = {"surface": _pixels(4, 140, 64, 2), "overhead": _pixels(4, 64, 64, 3)}
    state, out = pipe.train_step(state, batch, torch.Generator())
    assert torch.isfinite(out["loss"])
    assert not torch.equal(before["logit_scale"], state.params["surface"]["logit_scale"])


def test_every_block_moves_the_embedding():
    """With the benchmark's weight draw at the published depths, zeroing
    any one block's fc2 moves an embedding by more than the bf16 tolerance
    and the cell's ``emb_err`` limit: no block is an identity."""
    m = _model(depths=(3, 3, 27, 3))
    w = _weights(m, seed=11)
    limit = json.loads((ROOT / "benchmark" / "workloads" / "sample4geo-cvusa.eval-bf16.json")
                       .read_text())["limits"]["emb_err"]
    x = _ref_input(_pixels(2, 64, 64, 8), _cfg().data)
    with torch.no_grad():
        base = ref.encoder(x, w, m.depths)
        moves = []
        for i, depth in enumerate(m.depths):
            for j in range(depth):
                fc2 = f"model.stages.{i}.blocks.{j}.mlp.fc2"
                cut = dict(w, **{f"{fc2}.weight": torch.zeros_like(w[f"{fc2}.weight"]),
                                 f"{fc2}.bias": torch.zeros_like(w[f"{fc2}.bias"])})
                moves.append(float((ref.encoder(x, cut, m.depths) - base).norm(dim=1).min()))
    assert min(moves) > max(BF16_TOL, limit), moves


def test_noise_images_do_not_embed_at_one_vector():
    """The draw keeps random pixels' embeddings apart: the squared distance
    of two images' unit embeddings is far from 0."""
    m = _model(depths=(3, 3, 27, 3))
    w = _weights(m, seed=12)
    x = _ref_input(_pixels(4, 64, 64, 9), _cfg().data)
    with torch.no_grad():
        e = ref.encoder(x, w, m.depths)
    d2 = torch.cdist(e, e) ** 2
    assert float(d2[~torch.eye(4, dtype=torch.bool)].min()) > 0.1


def test_test_ranks_end_to_end():
    """``train.loop.test_ranks`` ranks the family's embeddings with
    ``euclidean_ranks``, as the reference's distances rank them."""
    cfg = _cfg()
    pipe = make_pipeline(cfg, "cpu")
    params = make_weights(cfg.model, 13, "cpu")
    n = 7
    surface, overhead = _pixels(n, 140, 64, 20), _pixels(n, 64, 64, 21)
    loader = [{"surface": surface[i:i + 3].numpy(), "overhead": overhead[i:i + 3].numpy()}
              for i in range(0, n, 3)]
    metrics, ranks = loop.test_ranks(cfg, pipe, loader, params, verbose=False)
    w = params["surface"]
    with torch.no_grad():
        s = ref.encoder(_ref_input(surface, cfg.data), w, DEPTHS)
        o = ref.encoder(_ref_input(overhead, cfg.data), w, DEPTHS)
    d = ((o[:, None, :] - s[None, :, :]) ** 2).sum(-1)  # [gallery, query]
    want = (d <= d.diagonal()[None, :]).sum(0)  # the true match and all at or under it
    np.testing.assert_array_equal(ranks, want.numpy())
    np.testing.assert_array_equal(euclidean_ranks(o, s, device="cpu"), ranks)
    assert metrics["locations"] == n


def test_preset_is_the_published_setting():
    cfg = sample4geo_experiment("cvusa")
    m, d = cfg.model, cfg.data
    assert (m.kind, m.depths, m.dims, m.kernel_size, m.mlp_ratio) == (
        "sample4geo", (3, 3, 27, 3), (128, 256, 512, 1024), 7, 4)
    assert m.ln_eps == 1e-6 and m.compute_dtype == "bfloat16" and m.label_smoothing == 0.1
    assert m.logit_scale_init == pytest.approx(np.log(1 / 0.07))
    assert (d.surface_height, d.surface_width_max, d.surface_width, d.overhead_size) == (
        140, 768, 768, 384)
    assert round(224 / 1232 * 768) == 140
    assert not d.random_orientation
    assert (d.img_mean, d.img_std) == ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    assert (cfg.eval.batch_size, cfg.train.batch_size) == (64, 128)
    enc = Sample4Geo(m)
    n_params = sum(p.numel() for p in enc.parameters())
    assert 87e6 < n_params < 89e6  # ConvNeXt-B's 88 M without a classifier


def test_serialize_round_trip(tmp_path):
    cfg = sample4geo_experiment("cvusa")
    path = tmp_path / "cfg.yaml"
    save_config(cfg, str(path))
    back = load_config(str(path))
    assert back == cfg and type(back.model) is Sample4GeoModelConfig


def test_fp8_control_is_coarser_than_the_bf16_tolerance():
    """The reference with fp8 operands, the benchmark's control, misses the
    bf16 tolerance that the port meets."""
    m = _model()
    w = _weights(m)
    x = _ref_input(_pixels(3, 140, 64), _cfg().data)
    with torch.no_grad():
        want = ref.encoder(x, w, DEPTHS)
        ctl = ref.encoder(x, w, DEPTHS, reference.fp8_round)
    assert _rel(ctl, want) > BF16_TOL
