"""Sample4Geo's encoder and loss in float32 (Deuser, Habel, Oswald, ICCV 2023,
arXiv:2303.11851; ConvNeXt, Liu et al., CVPR 2022, arXiv:2201.03545, timm
``convnext_base``): one ConvNeXt with shared weights embeds both views.

    stem:   x = LN_c(conv4x4/4(x))
    stage i (i >= 1 first): x = conv2x2/2(LN_c(x))      (odd sizes round down)
    block:  x = x + gamma * fc2(GELU_erf(fc1(LN_c(dwconv_k(x)))))
    head:   e = normalize(LN(mean_hw(x)))
    loss:   (CE_ls(exp(s) f_g f_a^T, I) + CE_ls(exp(s) f_a f_g^T, I)) / 2

LN_c is a LayerNorm over channels (eps 1e-6), the depthwise conv has padding
k // 2 and a bias, fc1 and fc2 map C -> 4C -> C with biases, CE_ls is
cross-entropy with label smoothing, s the learnable logit scale.

Weights are a dict of float32 tensors under the names of Sample4Geo's
checkpoint: ``model.stem.0`` (conv), ``model.stem.1`` (LN),
``model.stages.<i>.downsample.0`` (LN) / ``.1`` (conv),
``model.stages.<i>.blocks.<j>.conv_dw`` / ``.norm`` / ``.mlp.fc1`` /
``.mlp.fc2`` (``.weight`` and ``.bias``) and ``.gamma``,
``model.head.norm``, ``logit_scale``.

Departures from the published description:

- Weights are random, from the benchmark's seed, not the published
  checkpoint; the layer scale is drawn far above its 1e-6 init, so that
  every block changes the embedding.
- Inputs come at the model's sizes (a 140 x 768 panorama, a 384 x 384
  tile); Sample4Geo resizes 1232 x 224 and 750 x 750 images on its host
  loader, outside the measured path.
- No stochastic depth (Sample4Geo trains ``convnext_base`` without it and
  an eval has none).
- The embeddings are normalized again inside the loss, as Sample4Geo's
  ``InfoNCE`` does (no change on unit vectors).

NCHW throughout, ``F.conv2d`` / ``F.layer_norm`` / ``F.linear`` /
``F.gelu`` (erf), float32 with TF32 off where the caller runs it under
``benchmark.reference.exact()``; ``quantize`` rounds the operands of every
conv and linear (``benchmark.reference.fp8_round`` for the control).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import Quantize, apply

EPS = 1e-6
Weights = Dict[str, torch.Tensor]


def layer_norm_channels(x: torch.Tensor, w: Weights, name: str) -> torch.Tensor:
    """LayerNorm over the channels of NCHW ``x``."""
    y = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], w[f"{name}.weight"],
                     w[f"{name}.bias"], EPS)
    return y.permute(0, 3, 1, 2)


def conv(x: torch.Tensor, w: Weights, name: str, stride: int = 1, padding: int = 0,
         groups: int = 1, quantize: Quantize = None) -> torch.Tensor:
    return F.conv2d(apply(quantize, x), apply(quantize, w[f"{name}.weight"]), w[f"{name}.bias"],
                    stride=stride, padding=padding, groups=groups)


def linear(x: torch.Tensor, w: Weights, name: str, quantize: Quantize = None) -> torch.Tensor:
    return F.linear(apply(quantize, x), apply(quantize, w[f"{name}.weight"]), w[f"{name}.bias"])


def block(x: torch.Tensor, w: Weights, name: str, quantize: Quantize = None) -> torch.Tensor:
    c = x.shape[1]
    k = w[f"{name}.conv_dw.weight"].shape[-1]
    y = conv(x, w, f"{name}.conv_dw", padding=k // 2, groups=c, quantize=quantize)
    y = layer_norm_channels(y, w, f"{name}.norm").permute(0, 2, 3, 1)  # NHWC
    y = F.gelu(linear(y, w, f"{name}.mlp.fc1", quantize), approximate="none")
    y = linear(y, w, f"{name}.mlp.fc2", quantize) * w[f"{name}.gamma"]
    return x + y.permute(0, 3, 1, 2)


def encoder(x: torch.Tensor, w: Weights, depths: Sequence[int],
            quantize: Quantize = None) -> torch.Tensor:
    """NCHW float32 images -> [B, D] unit embeddings."""
    x = layer_norm_channels(conv(x, w, "model.stem.0", stride=4, quantize=quantize), w,
                            "model.stem.1")
    for i, depth in enumerate(depths):
        stage = f"model.stages.{i}"
        if i > 0:
            x = conv(layer_norm_channels(x, w, f"{stage}.downsample.0"), w,
                     f"{stage}.downsample.1", stride=2, quantize=quantize)
        for j in range(depth):
            x = block(x, w, f"{stage}.blocks.{j}", quantize)
    pooled = x.mean(dim=(2, 3))
    e = F.layer_norm(pooled, pooled.shape[1:], w["model.head.norm.weight"],
                     w["model.head.norm.bias"], EPS)
    return F.normalize(e, dim=-1)


def infonce(f_ground: torch.Tensor, f_aerial: torch.Tensor, logit_scale: torch.Tensor,
            label_smoothing: float) -> torch.Tensor:
    """Sample4Geo's symmetric InfoNCE loss (row i's positive is column i)."""
    f_ground = F.normalize(f_ground, dim=-1)
    f_aerial = F.normalize(f_aerial, dim=-1)
    logits = logit_scale.exp() * f_ground @ f_aerial.T
    labels = torch.arange(len(logits), device=logits.device)
    return (F.cross_entropy(logits, labels, label_smoothing=label_smoothing)
            + F.cross_entropy(logits.T, labels, label_smoothing=label_smoothing)) / 2
