"""VGG16 feature trunk through conv4_3 + ReLU (torch ``features[:23]``).

Port of witw_tpu/models/backbones/vgg16.py. The trunk runs inside
``FovDsm`` on NCHW tensors with channels_last strides (the NHWC memory of
the tower's input viewed as NCHW). Submodules are named ``conv_<torch idx>``
so flax params and torchvision weights map 1:1.

- bf16 towers (the default compute dtype): every conv is one call of
  ``ops.conv3x3.conv3x3_bias_relu``, the hand-written conv + bias + ReLU
  kernel on the card. The circular tower passes ``circular=True`` (the
  width read modulo W), which equals the block halo below value for value.
- f32 towers: ``F.conv2d`` then ReLU. Circular width padding (the overhead
  tower convolves a horizontally wrapping polar panorama): the wrap halo is
  materialized once per conv block (``len(block)`` columns per side) and
  the block's convs run width-VALID, each consuming one halo column; height
  is zero-padded by 1.
- Dropout2d after conv4_1/4_2/4_3, only with ``train=True``, its channel
  mask drawn from an explicit ``torch.Generator``, or taken from
  ``DropoutMasks`` drawn beforehand (``draw_masks``): a data-parallel step
  draws the global batch's masks and gives each shard its rows. The reference order is
  conv -> dropout -> relu (cvig_fov.py:234-245); the bf16 towers apply it
  after the fused conv + ReLU, which is exact: the mask scales each channel
  by 0 or 1/(1-p) >= 0, and ReLU commutes with that.
- ``frozen_prefix`` detaches block 4's input (witw_tpu's stop_gradient):
  with blocks 1-3 frozen nothing upstream needs a gradient.
- ``dtype`` is the compute dtype of the convs (weights, inputs and outputs),
  as flax's ``dtype=``; parameters are stored in float32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from witw_tpu_torch.ops.conv3x3 import conv3x3_bias_relu
from witw_tpu_torch.utils.profiling import span

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

    def fused(self, x: torch.Tensor, relu: bool, circular: bool) -> torch.Tensor:
        """Stride-1 conv + bias (+ReLU) through ``ops.conv3x3`` on the
        unpadded input (the width zero-padded, or wrapped when
        ``circular``); NCHW channels_last in and out."""
        if self.stride != (1, 1):
            raise ValueError(f"the fused conv is stride 1, this one is {self.stride}")
        y = conv3x3_bias_relu(x.permute(0, 2, 3, 1), self.weight.to(self.dtype),
                              self.bias.to(self.dtype), circular, relu)
        return y.permute(0, 3, 1, 2)


def draw_keep_mask(generator: torch.Generator, b: int, channels: int, rate: float) -> torch.Tensor:
    """A whole-channel dropout keep mask, bool [b, channels, 1, 1], each
    element kept with probability 1 - rate, drawn on ``generator``'s
    device."""
    with span("draw"):
        return torch.bernoulli(
            torch.full((b, channels, 1, 1), 1.0 - rate, device=generator.device),
            generator=generator).to(torch.bool)


class DropoutMasks:
    """Keep masks drawn before the towers run, handed to ``dropout2d`` in
    place of a generator, one per dropout layer in draw order: a data
    shard's rows of the masks drawn for the global batch."""

    def __init__(self, masks: Sequence[torch.Tensor]):
        self._masks = list(masks)

    def next(self, x: torch.Tensor) -> torch.Tensor:
        if not self._masks:
            raise ValueError("more dropout layers than masks drawn")
        keep = self._masks.pop(0)
        if keep.shape != (x.shape[0], x.shape[1], 1, 1):
            raise ValueError(f"a keep mask of {tuple(keep.shape)} for an input of "
                             f"{tuple(x.shape)}")
        return keep.to(x.device)


def dropout2d(x: torch.Tensor, rate: float,
              generator: Union[torch.Generator, DropoutMasks]) -> torch.Tensor:
    """Whole-channel dropout of an NCHW tensor, as flax ``nn.Dropout`` with
    ``broadcast_dims=(1, 2)`` on NHWC: keep each (image, channel) with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate). The mask
    is drawn on ``generator``'s device (:func:`draw_keep_mask`), or is the
    next of the ``DropoutMasks`` given."""
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    if isinstance(generator, DropoutMasks):
        keep = generator.next(x)
    else:
        keep = draw_keep_mask(generator, x.shape[0], x.shape[1], rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Vgg16Features(nn.Module):
    """VGG16 conv1_1 .. conv4_3 (+ReLU), 3 maxpools; output stride 8.
    NCHW in, NCHW out (in ``dtype``)."""

    def __init__(self, in_channels: int = 3, circ_padding: bool = False,
                 dropout_rate: float = 0.2, dtype: torch.dtype = torch.float32,
                 frozen_prefix: bool = False):
        super().__init__()
        self.circ_padding = circ_padding
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.frozen_prefix = frozen_prefix
        in_ch = in_channels
        for torch_idx, out_ch in VGG16_CONVS:
            self.add_module(
                f"conv_{torch_idx}",
                Conv3x3(in_ch, out_ch, pad_width=not circ_padding, dtype=dtype),
            )
            in_ch = out_ch

    def reset_parameters(self, generator: torch.Generator) -> None:
        for torch_idx, _ in VGG16_CONVS:
            conv = getattr(self, f"conv_{torch_idx}")
            with torch.no_grad():
                lecun_normal_(conv.weight, generator)
                conv.bias.zero_()

    def draw_masks(self, generator: torch.Generator, b: int) -> List[torch.Tensor]:
        """The keep masks a train-mode forward of a batch of ``b`` draws,
        in its order (none without dropout): the same draws as the forward's
        own from the same generator state."""
        if self.dropout_rate <= 0:
            return []
        return [draw_keep_mask(generator, b, out_ch, self.dropout_rate)
                for torch_idx, out_ch in VGG16_CONVS if torch_idx in DROPOUT_CONVS]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Union[torch.Generator, DropoutMasks, None] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        fused = self.dtype == torch.bfloat16
        for block_i, block in enumerate(VGG16_BLOCKS):
            if block_i == 3 and self.frozen_prefix:
                x = x.detach()
            if self.circ_padding and not fused:
                x = wrap_pad_width(x, len(block))
            for torch_idx, _ in block:
                conv = getattr(self, f"conv_{torch_idx}")
                drop = train and torch_idx in DROPOUT_CONVS and self.dropout_rate > 0
                if fused:
                    x = conv.fused(x, relu=True, circular=self.circ_padding)
                    if drop:
                        x = dropout2d(x, self.dropout_rate, generator)
                else:
                    x = conv(x)
                    if drop:
                        x = dropout2d(x, self.dropout_rate, generator)
                    x = F.relu(x)
            if block_i < 3:
                x = F.max_pool2d(x, 2, 2)  # floor, as torch MaxPool2d(2, 2)
        return x
