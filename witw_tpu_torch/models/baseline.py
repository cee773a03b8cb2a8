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

``forward_sharded`` runs the towers on one global batch's data shards in
lockstep, layer by layer, with the global batch's BatchNorm statistics (the
data-parallel train step, as witw_tpu's statistics under GSPMD).

Parameter names are ``conv{i}.weight`` (OIHW), ``conv{i}.bias``,
``bn{i}.weight``, ``bn{i}.bias`` and the buffers ``bn{i}.running_mean``,
``bn{i}.running_var`` (``nn.BatchNorm2d``'s names).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

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


def row_moments(x32: torch.Tensor) -> torch.Tensor:
    """[B, 2, C]: per row and channel of an NCHW f32 tensor, the mean and
    the sum of squared deviations from it (M2), in one ``var_mean`` pass
    (no E[x²] - E[x]², which cancels in f32 where a channel's values nearly
    agree)."""
    var, mean = torch.var_mean(x32, dim=(2, 3), correction=0)
    return torch.stack([mean, var * (x32.shape[2] * x32.shape[3])], dim=1)


def batch_stats(rows: torch.Tensor, keep: Optional[torch.Tensor], n_rows: int, hw: int):
    """The f32 mean and biased variance [C] of the ``n_rows`` rows of
    ``rows`` [B, 2, C] (:func:`row_moments` of ``hw`` values each) that
    ``keep`` (bool [B], optional) selects: Chan's combination of the rows
    in f64, in row order, mean = sum mean_r / n_rows and M2 = sum M2_r +
    hw sum (mean_r - mean)². Given the same rows, a data-parallel step gets
    one device's statistics, however its shards split the rows."""
    r = rows.to(torch.float64)
    w = 1.0 if keep is None else keep.to(r.device, torch.float64)[:, None]
    mean, m2 = r[:, 0], r[:, 1]
    total = (w * mean).sum(dim=0) / n_rows
    m2 = (w * (m2 + hw * (mean - total).square())).sum(dim=0)
    return total.to(torch.float32), (m2 / (n_rows * hw)).to(torch.float32)


class BatchNorm(nn.Module):
    """BatchNorm over the channels of an NCHW tensor with torch's
    ``nn.BatchNorm2d`` semantics as witw_tpu's ``TorchBatchNorm`` computes
    them: train mode normalizes with the biased batch variance (per-row
    moments combined in f64, :func:`batch_stats`, where witw_tpu's is the
    fast form E[x²] - E[x]² in f32) and updates the running buffers in
    place with the unbiased one (n / (n - 1)), momentum torch-style
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
            rows = x32.shape[0] if mask is None else n_valid
            hw = x32.shape[2] * x32.shape[3]
            mean, var = self.update_running(*batch_stats(row_moments(x32), mask, rows, hw),
                                            rows * hw, self.running_mean, self.running_var)
        return self.normalize(x32, mean, var, self.weight, self.bias)

    def update_running(self, mean: torch.Tensor, var: torch.Tensor, n: int,
                       running_mean: torch.Tensor, running_var: torch.Tensor):
        """Updates the running buffers in place, torch-style, from the batch
        ``mean`` and biased ``var`` of ``n`` values per channel (the buffer
        takes the unbiased variance) and returns (mean, var). Raises for
        n <= 1."""
        if n <= 1:
            raise ValueError(f"BatchNorm in train mode needs more than one value per channel, "
                             f"got {n} (torch raises here; witw_tpu would store inf)")
        with torch.no_grad():
            m = self.momentum
            running_mean.copy_((1.0 - m) * running_mean + m * mean)
            running_var.copy_((1.0 - m) * running_var + m * var * (n / (n - 1.0)))
        return mean, var

    def normalize(self, x32: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(var + self.eps)
        return ((x32 - mean[:, None, None]) * (inv * weight)[:, None, None]
                + bias[:, None, None])


class StridedConv(nn.Module):
    """A 4x4 stride-2 VALID conv in ``dtype`` (weight OIHW, bias [O])."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv with its own parameters, or with ``weight`` and
        ``bias`` when given."""
        weight = self.weight if weight is None else weight
        bias = self.bias if bias is None else bias
        return F.conv2d(x.to(self.dtype), weight.to(self.dtype), bias.to(self.dtype), stride=2)


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


def forward_sharded(towers: Sequence[BaselineEncoder],
                    shard_params: Sequence[Sequence[Dict[str, torch.Tensor]]],
                    xs: Sequence[Sequence[torch.Tensor]], train: bool,
                    valid: torch.Tensor, n_valid: int,
                    gather: Callable[[List[torch.Tensor]], torch.Tensor],
                    running: Sequence[Dict[str, torch.Tensor]]) -> List[List[torch.Tensor]]:
    """Towers on the data shards of one global batch, layer by layer in
    lockstep: tower t on shard i's input ``xs[t][i]`` (raw NHWC) with its
    parameters there ``shard_params[t][i]`` (the tower's state dict on the
    shard's device). In train mode each BatchNorm normalizes every shard
    with the global batch's statistics: each shard's :func:`row_moments`,
    every tower's stacked [b, T, 2, C], go through one ``gather`` per layer
    (the global batch's rows [B, T, 2, C] in row order on every process,
    with autograd), and :func:`batch_stats` combines the ``n_valid`` rows
    that ``valid`` (bool [B]) keeps; each tower's running buffers
    ``running[t]`` (the home state dict) are updated once with them, alike
    on every process. One collective per layer for all towers keeps the
    backward's collectives in one order on every process. Eval mode reads
    each shard's buffers. Returns [t][i], each shard's embeddings on its
    device."""
    cfg = towers[0].cfg
    xs = [[scale_input(x).permute(0, 3, 1, 2) for x in tower_xs] for tower_xs in xs]
    feats = [[[] for _ in tower_xs] for tower_xs in xs]
    for i in range(1, len(CHANNELS) + 1):
        xs = [[F.leaky_relu(getattr(tower, f"conv{i}")(x, sp[f"conv{i}.weight"],
                                                      sp[f"conv{i}.bias"]),
                            cfg.leaky_slope).to(torch.float32)
               for x, sp in zip(tower_xs, sps)]
              for tower, tower_xs, sps in zip(towers, xs, shard_params)]
        if train:
            rows = gather([torch.stack([row_moments(tower_xs[k]) for tower_xs in xs], dim=1)
                           for k in range(len(xs[0]))])
            stats = []
            for t, tower in enumerate(towers):
                hw = xs[t][0].shape[2] * xs[t][0].shape[3]
                mean, var = getattr(tower, f"bn{i}").update_running(
                    *batch_stats(rows[:, t], valid, n_valid, hw), n_valid * hw,
                    running[t][f"bn{i}.running_mean"], running[t][f"bn{i}.running_var"])
                stats.append([(mean.to(x.device), var.to(x.device)) for x in xs[t]])
        else:
            stats = [[(sp[f"bn{i}.running_mean"], sp[f"bn{i}.running_var"]) for sp in sps]
                     for sps in shard_params]
        xs = [[getattr(tower, f"bn{i}").normalize(x, mean, var, sp[f"bn{i}.weight"],
                                                  sp[f"bn{i}.bias"])
               for x, (mean, var), sp in zip(tower_xs, tower_stats, sps)]
              for tower, tower_xs, tower_stats, sps in zip(towers, xs, stats, shard_params)]
        if i >= GEM_FROM:
            p = cfg.gem_power
            for tower_feats, tower_xs in zip(feats, xs):
                for f, x in zip(tower_feats, tower_xs):
                    f.append(F.relu(x).pow(p).mean(dim=(2, 3)).pow(1.0 / p))
    feats = [[torch.cat(f, dim=1) for f in tower_feats] for tower_feats in feats]
    return [[f / f.norm(dim=1, keepdim=True).sqrt() for f in tower_feats] for tower_feats in feats]


def baseline_trainable_mask(names: Iterable[str]) -> List[str]:
    """The trainable ones of a tower's names: every conv and BatchNorm
    weight and bias, no running buffer."""
    return [n for n in names if n.rsplit(".", 1)[-1] not in BN_BUFFERS]
