"""The towers in float32: VGG16 conv1_1 .. conv4_3 with ReLU and three 2x2
max pools, then the FOV-DSM head (three 3x3 convs, the first two of height
stride 2 with ReLU; cvig_fov.py:248-294) or the SAFA head (Shi et al.,
NeurIPS 2019: M two-layer MLPs on the channel-max plan give M spatial masks;
the embedding is the M mask-weighted feature sums, L2-normalized).

Weights are a dict of float32 tensors under the names a checkpoint of the
towers uses: ``vgg.conv_<i>.weight`` [Co, Ci, 3, 3] and ``.bias`` for the
trunk (i the torchvision feature index), ``conv_23`` / ``conv_25`` /
``conv_27`` for the FOV head, ``safa.fc1`` [hw, hw/r, M], ``safa.fc1_bias``
[hw/r, M], ``safa.fc2`` [hw/r, hw, M], ``safa.fc2_bias`` [hw, M].

The overhead tower convolves a polar panorama that wraps around: its convs
pad the width circularly, the height with zeros. Training-mode dropout
(whole channels after conv4_1, 4_2 and 4_3, scaled by 1 / (1 - rate)) takes
its keep masks as an argument.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import Quantize, apply

VGG_BLOCKS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21))
DROPOUT_AFTER = (17, 19, 21)
FOV_HEAD = ((23, 2, True), (25, 2, True), (27, 1, False))
Weights = Dict[str, torch.Tensor]


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride_h: int,
            circular: bool, quantize: Quantize = None) -> torch.Tensor:
    """NCHW 3x3 conv, height padded by one zero row each side, width by one
    zero column or (``circular``) by the wrapped column."""
    x = apply(quantize, x)
    weight = apply(quantize, weight)
    if circular:
        x = F.pad(F.pad(x, (1, 1, 0, 0), mode="circular"), (0, 0, 1, 1))
        return F.conv2d(x, weight, bias, stride=(stride_h, 1))
    return F.conv2d(x, weight, bias, stride=(stride_h, 1), padding=1)


def vgg_trunk(x: torch.Tensor, w: Weights, circular: bool, quantize: Quantize = None,
              keep: Optional[Sequence[torch.Tensor]] = None, rate: float = 0.0,
              prefix: str = "vgg.") -> torch.Tensor:
    """NCHW input -> conv4_3's ReLU output. ``keep``: the three dropout keep
    masks [B, 512] (training mode), else no dropout."""
    masks = list(keep) if keep is not None else None
    for block_i, block in enumerate(VGG_BLOCKS):
        for i in block:
            x = conv3x3(x, w[f"{prefix}conv_{i}.weight"], w[f"{prefix}conv_{i}.bias"], 1,
                        circular, quantize)
            if masks is not None and i in DROPOUT_AFTER:
                m = masks.pop(0).to(x.dtype)[:, :, None, None]
                x = x * m / (1.0 - rate)
            x = F.relu(x)
        if block_i < 3:
            x = F.max_pool2d(x, 2, 2)
    return x


def fov_tower(x_nhwc: torch.Tensor, w: Weights, circular: bool, quantize: Quantize = None,
              keep: Optional[Sequence[torch.Tensor]] = None, rate: float = 0.0) -> torch.Tensor:
    """FOV-DSM tower: NHWC input -> NHWC float32 map [B, h, w, 16]."""
    x = vgg_trunk(x_nhwc.permute(0, 3, 1, 2), w, circular, quantize, keep, rate)
    for i, stride_h, relu in FOV_HEAD:
        x = conv3x3(x, w[f"conv_{i}.weight"], w[f"conv_{i}.bias"], stride_h, circular, quantize)
        if relu:
            x = F.relu(x)
    return x.permute(0, 2, 3, 1).contiguous()


def safa_head(feats_nhwc: torch.Tensor, w: Weights, quantize: Quantize = None) -> torch.Tensor:
    """[B, h, w, C] features -> [B, M * C] unit embedding (head-major)."""
    b, h, wd, c = feats_nhwc.shape
    f = feats_nhwc.reshape(b, h * wd, c)
    plan = f.amax(dim=-1)  # [B, hw]
    w1, b1 = apply(quantize, w["safa.fc1"]), w["safa.fc1_bias"]
    w2, b2 = apply(quantize, w["safa.fc2"]), w["safa.fc2_bias"]
    heads = w1.shape[2]
    masks = []
    for m in range(heads):
        hidden = apply(quantize, plan) @ w1[:, :, m] + b1[:, m]
        masks.append(apply(quantize, hidden) @ w2[:, :, m] + b2[:, m])
    mask = torch.stack(masks, dim=-1)  # [B, hw, M]
    embed = torch.einsum("bpc,bpm->bmc", apply(quantize, f), apply(quantize, mask)).reshape(b, -1)
    return embed / embed.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def safa_tower(x_nhwc: torch.Tensor, w: Weights, circular: bool,
               quantize: Quantize = None) -> torch.Tensor:
    """VGG16 + SAFA tower: NHWC input -> [B, M * 512] unit embedding."""
    feats = vgg_trunk(x_nhwc.permute(0, 3, 1, 2), w, circular, quantize)
    return safa_head(feats.permute(0, 2, 3, 1), w, quantize)


def blocks(n: int, size: int) -> List[slice]:
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]
