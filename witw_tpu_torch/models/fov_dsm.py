"""FOV-DSM tower: truncated VGG16 + 3-conv embedding head (port of
witw_tpu/models/fov_dsm.py; reference model/cvig_fov.py:248-294).

Output layout is NHWC float32: [B, h, w, 16] ([B, 4, 64, 16] at CVUSA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from witw_tpu.configs.base import FovDsmModelConfig
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
        )
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

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = self.vgg(x_nhwc.permute(0, 3, 1, 2))
        if self.circ_padding:
            x = wrap_pad_width(x, len(HEAD_CONVS))
        for name, _, _, relu_after in HEAD_CONVS:
            x = getattr(self, name)(x)
            if relu_after:
                x = F.relu(x)
        return x.to(torch.float32).permute(0, 2, 3, 1)
