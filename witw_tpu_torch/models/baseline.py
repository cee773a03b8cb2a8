"""Baseline twin-tower encoder: seven strided convs and multi-scale GeM
pooling (port of witw_tpu/models/baseline.py; reference
model/cvig_baseline.py:228-283).

Seven 4x4 stride-2 VALID convs (3 -> 64 -> 128 -> 256 -> 512 x 4), each
followed by LeakyReLU(0.2) *then* BatchNorm with torch's semantics; the
input is scaled from 0-255 to [-1, 1]; the embedding concatenates the
generalized-mean (p = 3) pooled ReLU features of conv5, conv6 and conv7
(1536-d) and is scaled by f / ||f||^0.5, deliberately not to unit length.
The convs run in ``cfg.compute_dtype`` (cuDNN on the card); BatchNorm, GeM
and the pseudo-normalization run in f32, as flax's dtype handling does.

Parameter names are ``conv{i}.weight`` (OIHW), ``conv{i}.bias``,
``bn{i}.weight``, ``bn{i}.bias`` and the buffers ``bn{i}.running_mean``,
``bn{i}.running_var`` (``nn.BatchNorm2d``'s names).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from witw_tpu_torch.configs.base import BaselineModelConfig

CHANNELS = (64, 128, 256, 512, 512, 512, 512)
GEM_FROM = 5  # GeM pooling of conv5, conv6 and conv7
BN_BUFFERS = ("running_mean", "running_var")


def scale_input(x: torch.Tensor) -> torch.Tensor:
    """Raw 0-255 pixels -> the encoder's [-1, 1] input in f32 (reference
    cvig_baseline.py:265-266), dividing by a tensor: a true division on the
    card too, which multiplies by the reciprocal of a Python number."""
    return -1.0 + 2.0 * (x.to(torch.float32) / torch.tensor(255.0, device=x.device))


class BatchNorm(nn.Module):
    """BatchNorm over the channels of an NCHW tensor with torch's
    ``nn.BatchNorm2d`` semantics as witw_tpu's ``TorchBatchNorm`` computes
    them: train mode normalizes with the biased batch variance (the fast
    form E[x²] - E[x]² in f32, clamped at 0) and updates the running buffers
    in place with the unbiased one (n / (n - 1)), momentum torch-style
    (running = (1 - m) running + m batch); eval mode uses the buffers.
    ``mask`` (bool [B], optional) leaves padded rows out of the statistics.
    Output f32."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None, n_valid: Optional[int] = None) -> torch.Tensor:
        """``n_valid``: the count of True rows of ``mask`` (the caller reads
        it once for all layers)."""
        x32 = x.to(torch.float32)
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            per_ch = x32.shape[2] * x32.shape[3]
            if mask is None:
                n = x32.shape[0] * per_ch
                mean = x32.mean(dim=(0, 2, 3))
                m2 = x32.square().mean(dim=(0, 2, 3))
            else:
                w = mask.to(torch.float32)[:, None, None, None]
                n = n_valid * per_ch
                n_t = w.sum() * per_ch
                mean = (x32 * w).sum(dim=(0, 2, 3)) / n_t
                m2 = (x32.square() * w).sum(dim=(0, 2, 3)) / n_t
            if n <= 1:
                raise ValueError(f"BatchNorm in train mode needs more than one value per channel, "
                                 f"got {n} (torch raises here; witw_tpu would store inf)")
            var = torch.clamp(m2 - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var + m * var * (n / (n - 1.0)))
        inv = torch.rsqrt(var + self.eps)
        return ((x32 - mean[:, None, None]) * (inv * self.weight)[:, None, None]
                + self.bias[:, None, None])


class StridedConv(nn.Module):
    """A 4x4 stride-2 VALID conv in ``dtype`` (weight OIHW, bias [O])."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
                        stride=2)


class BaselineEncoder(nn.Module):
    """One baseline tower: raw NHWC 0-255 input [B, H, W, C] -> the f32
    embedding [B, 1536]. H and W must be at least 382 (seven VALID stride-2
    convs)."""

    def __init__(self, cfg: BaselineModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        cin = cfg.bands + (2 if cfg.orientation_maps else 0)
        for i, ch in enumerate(CHANNELS, start=1):
            self.add_module(f"conv{i}", StridedConv(cin, ch, dtype))
            self.add_module(f"bn{i}", BatchNorm(ch, momentum=cfg.bn_momentum))
            cin = ch

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: conv weights and biases N(0, init_std), BatchNorm
        scales N(1, init_std) and biases N(0, init_std); running mean 0 and
        variance 1. Drawn from ``generator`` layer by layer."""
        std = self.cfg.init_std
        with torch.no_grad():
            for i in range(1, len(CHANNELS) + 1):
                conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
                for p, mean in ((conv.weight, 0.0), (conv.bias, 0.0), (bn.weight, 1.0),
                                (bn.bias, 0.0)):
                    p.copy_(torch.normal(mean, std, p.shape, generator=generator))
                bn.running_mean.zero_()
                bn.running_var.fill_(1.0)

    def forward(self, x_nhwc: torch.Tensor, train: bool = False,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``train``: BatchNorm on batch statistics, updating the running
        buffers in place. ``valid`` (bool [B], optional): real rows of a
        zero-padded batch; train-mode statistics cover only them."""
        p = self.cfg.gem_power
        n_valid = None
        if train and valid is not None:
            valid = torch.as_tensor(valid, device=x_nhwc.device)
            n_valid = int(valid.sum())
        x = scale_input(x_nhwc).permute(0, 3, 1, 2)
        feats = []
        for i in range(1, len(CHANNELS) + 1):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), self.cfg.leaky_slope)
            x = getattr(self, f"bn{i}")(x, train, valid if train else None, n_valid)
            if i >= GEM_FROM:
                feats.append(F.relu(x).pow(p).mean(dim=(2, 3)).pow(1.0 / p))
        f = torch.cat(feats, dim=1)
        return f / f.norm(dim=1, keepdim=True).sqrt()


def baseline_trainable_mask(names: Iterable[str]) -> List[str]:
    """The trainable ones of a tower's names: every conv and BatchNorm
    weight and bias, no running buffer."""
    return [n for n in names if n.rsplit(".", 1)[-1] not in BN_BUFFERS]
