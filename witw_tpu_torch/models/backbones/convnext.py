"""ConvNeXt (Liu et al., A ConvNet for the 2020s, CVPR 2022), the encoder of
the Sample4Geo family (``models.sample4geo``).

- Stem: a 4x4 stride-4 conv (with bias), then a LayerNorm over channels.
- Four stages of widths ``dims`` and depths ``depths``; before stages 1-3 a
  LayerNorm over channels, then a 2x2 stride-2 conv without padding (odd
  sizes round down: 35 rows become 17, then 8, then 4).
- Block: ``x + gamma * fc2(GELU(fc1(LN(dwconv(x)))))``: a depthwise
  ``kernel_size`` conv (padding k // 2, a bias), a LayerNorm with affine,
  ``fc1`` C -> ``mlp_ratio`` C and ``fc2`` back (both with bias), the exact
  erf GELU, ``gamma`` a per-channel layer scale.
- Head: the mean over H and W, then a LayerNorm (``head.norm``).

Parameter names are timm's ``convnext_*`` names (``stem.0``, ``stem.1``,
``stages.<i>.downsample.{0,1}``, ``stages.<i>.blocks.<j>.{conv_dw, norm,
mlp.fc1, mlp.fc2, gamma}``, ``head.norm``), so a published checkpoint's
state dict fits.

Precision, with the bf16 compute dtype, as ``torch.autocast`` runs timm's
model: convs and linears in bf16 (f32 accumulation), their weights and
biases cast per call; every LayerNorm in f32; the residual stream in f32
(the f32 ``gamma`` promotes each block's branch; a stage's first block adds
its branch to the bf16 output of the downsample conv). A block's mixer (the
depthwise conv, its bias and the LayerNorm) is ``ops.convnext_mixer``: the
input and the depthwise weight rounded to bf16, the conv's f32 sums, the
bias and the LayerNorm in f32, one rounding to bf16; on CUDA tensors one
hand-written kernel (``csrc/convnext_mixer.cu``) that reads the block input
as stored. The conv's sum goes into the LayerNorm unrounded, where autocast
rounds cuDNN's output to bf16 first. With the f32 compute dtype the mixer
is the plain PyTorch version, on either device. Activations are NCHW
tensors in the channels_last memory format, so a block's NCHW <-> NHWC
permutes are views.

Spans (``utils.profiling``), each block's with a device stretch:
``convnext.mixer`` (the mixer's one launch on the card) and
``convnext.mlp`` (fc1, GELU, fc2, gamma and the residual add).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from witw_tpu_torch.ops.convnext_mixer import convnext_mixer, convnext_mixer_plain
from witw_tpu_torch.utils.profiling import span

LS_INIT = 1e-6  # timm's layer-scale init
INIT_STD = 0.02  # timm's truncated-normal std for conv and linear weights


class _Affine(nn.Module):
    """One layer's weight and bias (zeros until ``reset_parameters``)."""

    def __init__(self, weight_shape: Tuple[int, ...], out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(weight_shape))
        self.bias = nn.Parameter(torch.zeros(out))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """timm's init: LayerNorm weight 1 and bias 0; conv and linear
        weights truncated normal (std 0.02, cut at +-2), biases 0."""
        with torch.no_grad():
            if self.weight.dim() == 1:
                self.weight.fill_(1.0)
            else:
                nn.init.trunc_normal_(self.weight, 0.0, INIT_STD, -2.0, 2.0, generator=generator)
            self.bias.zero_()


def _cast(layer: _Affine, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    return layer.weight.to(dtype), layer.bias.to(dtype)


def layer_norm_nchw(x: torch.Tensor, norm: _Affine, eps: float) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW channels_last tensor, in f32;
    returns f32 NCHW channels_last."""
    y = F.layer_norm(x.permute(0, 2, 3, 1).float(), norm.weight.shape, norm.weight, norm.bias,
                     eps)
    return y.permute(0, 3, 1, 2)


class Block(nn.Module):
    def __init__(self, dim: int, kernel_size: int, mlp_ratio: int, eps: float,
                 dtype: torch.dtype):
        super().__init__()
        self.conv_dw = _Affine((dim, 1, kernel_size, kernel_size), dim)
        self.norm = _Affine((dim,), dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = _Affine((mlp_ratio * dim, dim), mlp_ratio * dim)
        self.mlp.fc2 = _Affine((dim, mlp_ratio * dim), dim)
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW channels_last in (f32, or bf16 after a downsample) -> f32."""
        dt = self.dtype
        with span("convnext.mixer", stretch=True):
            args = (x.permute(0, 2, 3, 1), self.conv_dw.weight, self.conv_dw.bias,
                    self.norm.weight, self.norm.bias, self.eps)
            y = convnext_mixer(*args) if dt == torch.bfloat16 else convnext_mixer_plain(*args, dt)
        with span("convnext.mlp", stretch=True):
            y = F.gelu(F.linear(y, *_cast(self.mlp.fc1, dt)))
            y = F.linear(y, *_cast(self.mlp.fc2, dt))
            out = torch.addcmul(x.permute(0, 2, 3, 1), y, self.gamma)
        return out.permute(0, 3, 1, 2)


class Stage(nn.Module):
    """A stage's blocks, after a downsample from ``cin`` channels (None: the
    first stage, which has none)."""

    def __init__(self, cin: Optional[int], dim: int, depth: int, kernel_size: int,
                 mlp_ratio: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.downsample = None
        if cin is not None:
            self.downsample = nn.ModuleList([_Affine((cin,), cin), _Affine((dim, cin, 2, 2), dim)])
        self.blocks = nn.ModuleList([Block(dim, kernel_size, mlp_ratio, eps, dtype)
                                     for _ in range(depth)])
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            norm, conv = self.downsample
            x = F.conv2d(layer_norm_nchw(x, norm, self.eps).to(self.dtype),
                         *_cast(conv, self.dtype), stride=2)
        for block in self.blocks:
            x = block(x)
        return x


class ConvNeXt(nn.Module):
    """NCHW image -> [B, dims[-1]] f32: the pooled, LayerNormed features."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int], in_channels: int = 3,
                 kernel_size: int = 7, mlp_ratio: int = 4, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = nn.ModuleList([_Affine((dims[0], in_channels, 4, 4), dims[0]),
                                   _Affine((dims[0],), dims[0])])
        cins = [None] + list(dims[:-1])
        self.stages = nn.ModuleList([Stage(cin, dim, depth, kernel_size, mlp_ratio, eps, dtype)
                                     for cin, dim, depth in zip(cins, dims, depths)])
        self.head = nn.Module()
        self.head.norm = _Affine((dims[-1],), dims[-1])
        self.eps = eps
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """timm's init, layer scale at 1e-6."""
        for m in self.modules():
            if isinstance(m, _Affine):
                m.reset_parameters(generator)
            elif isinstance(m, Block):
                with torch.no_grad():
                    m.gamma.fill_(LS_INIT)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's map, f32 NCHW channels_last."""
        conv, norm = self.stem
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = layer_norm_nchw(F.conv2d(x, *_cast(conv, self.dtype), stride=4), norm, self.eps)
        for stage in self.stages:
            x = stage(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.forward_features(x).mean(dim=(2, 3), dtype=torch.float32)
        return F.layer_norm(pooled, pooled.shape[-1:], self.head.norm.weight,
                            self.head.norm.bias, self.eps)
