"""FOV-DSM tower: truncated VGG16 + 3-conv embedding head (port of
witw_tpu/models/fov_dsm.py; reference model/cvig_fov.py:248-294).

Output layout is NHWC float32: [B, h, w, 16] ([B, 4, 64, 16] at CVUSA).

With the bf16 compute dtype the stride-1 head conv ``conv_27`` runs on the
fused conv kernel (``relu=False``, wrapped width in the circular tower);
the stride-(2, 1) head convs ``conv_23`` and ``conv_25`` stay ``F.conv2d``
+ ReLU (the kernel is stride 1), each on a 1-column wrap halo when circular.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from witw_tpu_torch.configs.base import FovDsmModelConfig
from witw_tpu_torch.models.backbones.vgg16 import Conv3x3, Vgg16Features, wrap_pad_width

# Head conv specs: (name, out_channels, (stride_h, stride_w), relu_after).
# Width-stride 1 throughout, so the circular tower takes its whole width
# halo (3 columns per side) in one wrap pad.
HEAD_CONVS = (
    ("conv_23", 256, (2, 1), True),
    ("conv_25", 64, (2, 1), True),
    ("conv_27", 16, (1, 1), False),
)


class FovDsm(nn.Module):
    def __init__(self, cfg: FovDsmModelConfig, circ_padding: bool = False):
        super().__init__()
        self.circ_padding = circ_padding
        dtype = getattr(torch, cfg.compute_dtype)
        self.vgg = Vgg16Features(
            in_channels=cfg.in_channels,
            circ_padding=circ_padding,
            dropout_rate=cfg.dropout_rate,
            dtype=dtype,
            # Blocks 1-3 frozen with nothing trainable below them (the
            # standard fov config; semantic trains conv1_1) -> no backward
            # through them.
            frozen_prefix=cfg.freeze_backbone and not cfg.train_first_conv,
        )
        self.fused = dtype == torch.bfloat16
        in_ch = 512
        for name, out_ch, strides, _ in HEAD_CONVS:
            self.add_module(
                name,
                Conv3x3(in_ch, out_ch, strides, pad_width=not circ_padding, dtype=dtype),
            )
            in_ch = out_ch

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax init distributions: lecun_normal VGG kernels, xavier_uniform
        head kernels, zero biases."""
        self.vgg.reset_parameters(generator)
        with torch.no_grad():
            for name, _, _, _ in HEAD_CONVS:
                conv = getattr(self, name)
                nn.init.xavier_uniform_(conv.weight, generator=generator)
                conv.bias.zero_()

    def forward(self, x_nhwc: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, H, W, C] -> [B, h, w, 16] float32. ``train`` turns on the
        block-4 dropout, whose masks come from ``generator`` (a
        ``torch.Generator`` or the ``vgg16.DropoutMasks`` drawn for it)."""
        x = self.vgg(x_nhwc.permute(0, 3, 1, 2), train, generator)
        if self.circ_padding and not self.fused:
            x = wrap_pad_width(x, len(HEAD_CONVS))
        for name, _, strides, relu_after in HEAD_CONVS:
            conv = getattr(self, name)
            if self.fused and tuple(strides) == (1, 1):
                x = conv.fused(x, relu=relu_after, circular=self.circ_padding)
                continue
            if self.fused and self.circ_padding:
                x = wrap_pad_width(x, 1)
            x = conv(x)
            if relu_after:
                x = F.relu(x)
        return x.to(torch.float32).permute(0, 2, 3, 1)


def fov_dsm_trainable_mask(names: Iterable[str], cfg: FovDsmModelConfig) -> List[str]:
    """The trainable ones of a tower's parameter names (port of witw_tpu's
    boolean mask): the reference's freezing rule, torch feature idx < 17
    frozen (cvig_fov.py:274-278), conv1_1 trainable in the semantic variant
    (cvig_semantic.py:306-309), everything trainable without
    ``freeze_backbone``."""

    def decide(name: str) -> bool:
        if not cfg.freeze_backbone:
            return True
        for part in name.split("."):
            if part.startswith("conv_"):
                idx = int(part.split("_")[1])
                return idx >= 17 or (idx == 0 and cfg.train_first_conv)
        return True

    return [n for n in names if decide(n)]
