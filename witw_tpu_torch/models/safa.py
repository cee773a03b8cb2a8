"""VGG16 + SAFA (Spatial-Aware Feature Aggregation) embedding towers (port of
witw_tpu/models/safa.py; Shi et al., NeurIPS 2019).

A tower runs the shared VGG16 trunk (through conv4_3, ``Vgg16Features``
without dropout) and aggregates its [B, h, w, C] features into M
attention-weighted sums: the max-over-channels plan [B, h·w] goes through M
independent two-layer MLPs (h·w -> h·w / 2 -> h·w), giving M spatial masks,
and the embedding is the concatenation of the M mask-weighted feature sums,
[B, M·C], L2-normalized.

The head's parameters are flax's, unchanged: ``fc1`` [hw, hid, M],
``fc1_bias`` [hid, M], ``fc2`` [hid, hw, M], ``fc2_bias`` [hw, M], indexed by
the position p = y·w + x of flax's NHWC reshape. So h·w is fixed when the
tower is built: ``in_hw`` is the tower's input height and width (the surface
crop's, or the polar map's), and the trunk's three floor pools give h, w.

With the bf16 compute dtype the trunk's convs run on the conv3x3_bf16
kernel, and the head computes the hidden layer and the masks in bf16, then
the weighted sum in f32 from f32 casts of the masks and the features, as
witw_tpu does.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch
from torch import nn

from witw_tpu_torch.configs.base import SafaModelConfig
from witw_tpu_torch.models.backbones.vgg16 import Vgg16Features

HEAD_PARAMS = ("fc1", "fc1_bias", "fc2", "fc2_bias")
W_STD = 0.005  # flax truncated_normal(stddev=0.005): +-2 std, no variance correction
B_INIT = 0.1


def feature_hw(in_hw: Tuple[int, int]) -> Tuple[int, int]:
    """The trunk's output height and width: three 2x2 floor pools."""
    return in_hw[0] // 8, in_hw[1] // 8


def safa_head_apply(head, feats: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The SAFA head on NHWC features [B, h, w, C] with parameters ``head``
    (a mapping with the four HEAD_PARAMS): hidden layer and masks in
    ``dtype``, the mask-weighted sums in f32, then the L2 normalization.
    Returns [B, M·C] f32."""
    b, h, w, c = feats.shape
    f = feats.reshape(b, h * w, c)
    plan = f.amax(dim=-1)  # [B, hw] channel-max plan
    w1, b1, w2, b2 = (head[k].to(dtype) for k in HEAD_PARAMS)
    hidden = torch.einsum("bp,pqm->bqm", plan.to(dtype), w1) + b1
    masks = torch.einsum("bqm,qpm->bpm", hidden, w2) + b2
    embed = torch.einsum("bpc,bpm->bmc", f.to(torch.float32), masks.to(torch.float32))
    embed = embed.reshape(b, -1)
    return embed / embed.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class SafaHead(nn.Module):
    """M spatial masks from the channel-max plan, each from its own
    two-layer MLP (rank-3 parameters, not a shared bottleneck)."""

    def __init__(self, hw: int, num_heads: int = 8, reduction: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hid = hw // reduction
        self.dtype = dtype
        self.fc1 = nn.Parameter(torch.zeros(hw, hid, num_heads))
        self.fc1_bias = nn.Parameter(torch.zeros(hid, num_heads))
        self.fc2 = nn.Parameter(torch.zeros(hid, hw, num_heads))
        self.fc2_bias = nn.Parameter(torch.zeros(hw, num_heads))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: truncated normal (std 0.005, cut at +-2 std) weights,
        biases 0.1."""
        with torch.no_grad():
            for w in (self.fc1, self.fc2):
                nn.init.trunc_normal_(w, 0.0, W_STD, -2.0 * W_STD, 2.0 * W_STD,
                                      generator=generator)
            for b in (self.fc1_bias, self.fc2_bias):
                b.fill_(B_INIT)

    def forward(self, feats_nhwc: torch.Tensor) -> torch.Tensor:
        return safa_head_apply({k: getattr(self, k) for k in HEAD_PARAMS}, feats_nhwc, self.dtype)


class VggSafa(nn.Module):
    """One SAFA tower: VGG16 trunk + SAFA aggregation -> unit embedding
    [B, M·512] f32, from an NHWC input of height and width ``in_hw``."""

    def __init__(self, cfg: SafaModelConfig, in_hw: Tuple[int, int],
                 circ_padding: bool = False):
        super().__init__()
        dtype = getattr(torch, cfg.compute_dtype)
        self.in_hw = tuple(in_hw)
        self.vgg = Vgg16Features(
            in_channels=cfg.in_channels,
            circ_padding=circ_padding,
            dropout_rate=0.0,
            dtype=dtype,
            # Blocks 1-3 frozen with nothing trainable below them: no
            # backward through them.
            frozen_prefix=cfg.freeze_backbone,
        )
        h, w = feature_hw(in_hw)
        self.safa = SafaHead(h * w, cfg.num_heads, cfg.reduction, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.vgg.reset_parameters(generator)
        self.safa.reset_parameters(generator)

    def forward(self, x_nhwc: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if tuple(x_nhwc.shape[1:3]) != self.in_hw:
            raise ValueError(f"this tower was built for {self.in_hw} inputs (its head is "
                             f"indexed by position), got {tuple(x_nhwc.shape[1:3])}")
        feats = self.vgg(x_nhwc.permute(0, 3, 1, 2), train, generator)
        return self.safa(feats.permute(0, 2, 3, 1))


def safa_trainable_mask(names: Iterable[str], cfg: SafaModelConfig) -> List[str]:
    """The trainable ones of a tower's parameter names (port of witw_tpu's
    boolean mask): VGG blocks 1-3 (torch feature idx < 17) frozen with
    ``freeze_backbone``; conv4_x and the SAFA head train."""

    def decide(name: str) -> bool:
        if not cfg.freeze_backbone:
            return True
        for part in name.split("."):
            if part.startswith("conv_"):
                return int(part.split("_")[1]) >= 17
        return True

    return [n for n in names if decide(n)]
