"""VGG16 feature trunk through conv4_3 + ReLU (torch ``features[:23]``).

Port of witw_tpu/models/backbones/vgg16.py. The trunk runs inside
``FovDsm`` on NCHW tensors with channels_last strides (the NHWC memory of
the tower's input viewed as NCHW), the layout cuDNN prefers. Submodules are named ``conv_<torch idx>``
so flax params and torchvision weights map 1:1.

- Circular width padding (the overhead tower convolves a horizontally
  wrapping polar panorama): the wrap halo is materialized once per conv
  block (``len(block)`` columns per side) and the block's convs run
  width-VALID, each consuming one halo column; height is zero-padded by 1.
- Dropout2d after conv4_1/4_2/4_3, applied conv -> dropout -> relu
  (reference cvig_fov.py:234-245); off in eval mode.
- ``dtype`` is the compute dtype of the convs (weights, inputs and outputs),
  as flax's ``dtype=``; parameters are stored in float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (torch feature index, out_channels); pools sit at torch indices 4, 9, 16.
VGG16_CONVS: Tuple[Tuple[int, int], ...] = (
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512),
)
POOL_AFTER = {2, 7, 14}
DROPOUT_CONVS = {17, 19, 21}

# Convs grouped between pools (block-level wrap halo).
VGG16_BLOCKS: Tuple[Tuple[Tuple[int, int], ...], ...] = (
    ((0, 64), (2, 64)),
    ((5, 128), (7, 128)),
    ((10, 256), (12, 256), (14, 256)),
    ((17, 512), (19, 512), (21, 512)),
)


def wrap_pad_width(x: torch.Tensor, halo: int, dim: int = -1) -> torch.Tensor:
    """Circular-pad the width axis by ``halo`` (at most the width) per side,
    as ``jnp.pad`` mode "wrap" does: ``dim`` -1 on NCHW (the bf16 towers,
    whose channels_last memory format is kept), 2 on NHWC (the int8
    towers)."""
    if halo == 0:
        return x
    w = x.shape[dim]
    if halo > w:
        raise ValueError(f"a wrap halo of {halo} needs a width of at least {halo}, got {w}")
    return torch.cat([x.narrow(dim, w - halo, halo), x, x.narrow(dim, 0, halo)], dim=dim)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal at +-2 sigma, variance 1/fan_in
    after truncation."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Conv3x3(nn.Module):
    """3x3 conv on an NCHW tensor, zero height padding 1, width padding 1 or
    0 (width-VALID, for the circular towers), run in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, stride=(1, 1),
                 pad_width: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride = tuple(stride)
        self.padding = (1, 1 if pad_width else 0)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w, self.bias.to(self.dtype), self.stride, self.padding)


class Vgg16Features(nn.Module):
    """VGG16 conv1_1 .. conv4_3 (+ReLU), 3 maxpools; output stride 8.
    NCHW in, NCHW out (in ``dtype``)."""

    def __init__(self, in_channels: int = 3, circ_padding: bool = False,
                 dropout_rate: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.circ_padding = circ_padding
        self.dtype = dtype
        in_ch = in_channels
        for torch_idx, out_ch in VGG16_CONVS:
            self.add_module(
                f"conv_{torch_idx}",
                Conv3x3(in_ch, out_ch, pad_width=not circ_padding, dtype=dtype),
            )
            if torch_idx in DROPOUT_CONVS and dropout_rate > 0:
                self.add_module(f"dropout_{torch_idx}", nn.Dropout2d(dropout_rate))
            in_ch = out_ch

    def reset_parameters(self, generator: torch.Generator) -> None:
        for torch_idx, _ in VGG16_CONVS:
            conv = getattr(self, f"conv_{torch_idx}")
            with torch.no_grad():
                lecun_normal_(conv.weight, generator)
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for block_i, block in enumerate(VGG16_BLOCKS):
            if self.circ_padding:
                x = wrap_pad_width(x, len(block))
            for torch_idx, _ in block:
                x = getattr(self, f"conv_{torch_idx}")(x)
                if hasattr(self, f"dropout_{torch_idx}"):
                    x = getattr(self, f"dropout_{torch_idx}")(x)
                x = F.relu(x)
            if block_i < 3:
                x = F.max_pool2d(x, 2, 2)  # floor, as torch MaxPool2d(2, 2)
        return x
