"""Card tests of the port's fused-match CUDA kernel; each skips without a
CUDA device. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernel vs plain PyTorch in f32 with TF32 off: rtol 1e-5, atol 1e-6 and equal
orientations, except at near ties (plain top-2 correlation gap <= 1e-5 of
the max), where the two summation orders may pick different shifts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from witw_tpu.configs import DataConfig, DatasetConfig, ExperimentConfig, FovDsmModelConfig
from witw_tpu_torch.match.correlation import circular_correlation
from witw_tpu_torch.ops import fused_match
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


@pytest.mark.parametrize("g,q,h,w,c,sw", [
    (8, 4, 2, 8, 3, 8),
    (6, 3, 1, 8, 4, 5),
    (37, 70, 4, 64, 16, 64),  # ragged query tile
    (5, 9, 2, 100, 8, 33),  # widths above one 64-shift pass
    (3, 2, 1, 1, 2, 1),
])
def test_kernel_matches_plain(cuda, g, q, h, w, c, sw):
    rng = np.random.default_rng(0)
    o = torch.tensor(rng.standard_normal((g, h, w, c)), dtype=torch.float32, device=cuda)
    s = torch.tensor(rng.standard_normal((q, h, sw, c)), dtype=torch.float32, device=cuda)
    d_k, or_k = fused_match.fused_chord_distance_nhwc(o, s)
    d_p, or_p = fused_match.fused_chord_distance_plain(o, s)
    torch.cuda.synchronize()
    assert fused_match.launches == 1
    assert d_k.shape == (g, q) and or_k.dtype == torch.int32
    if w > 1:
        top2 = torch.topk(circular_correlation(o, s), 2, dim=-1).values
        keep = (top2[..., 0] - top2[..., 1]) > 1e-5 * top2[..., 0].abs()
    else:
        keep = torch.ones_like(d_p, dtype=torch.bool)
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
    cpu = FovPipeline(cfg)
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
