"""The towers' inputs from raw pixels: the field-of-view crop of the
panorama, the ImageNet normalization, and the polar transform of the
overhead tile (Shi et al., CVPR 2020; cvig_fov.py:117-183).

The tile is normalized first and then polar-transformed, as the reference
script does: each output pixel (x, y) of the h x w pseudo-panorama samples
the s x s tile at

    row = s/2 + s/2 * (h-1-y)/h * cos(2 pi x / w)
    col = s/2 - s/2 * (h-1-y)/h * sin(2 pi x / w)

bilinearly, with the corner indices clipped to the tile before the weights
are taken from them, so that a sample on the tile's last row or column has
all four weights 0 and reads 0.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """uint8-scale NHWC -> (x / 255 - mean) / std, float32."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x.to(torch.float32) / 255.0 - m) / s


def fov_crop(panorama: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """Columns starts[i] .. starts[i] + width - 1 of image i, wrapping past
    the panorama's seam. [B, H, W, C] -> [B, H, width, C]."""
    w_max = panorama.shape[2]
    out = []
    for img, s in zip(panorama, starts.tolist()):
        cols = (s + torch.arange(width, device=panorama.device)) % w_max
        out.append(img[:, cols])
    return torch.stack(out)


def polar(tile: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, s, s, C] float -> [B, h, w, C] float32 pseudo-panoramas."""
    b, s, _, c = tile.shape
    dev = tile.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev), indexing="ij")
    radius = (s / 2.0) * (h - 1 - yy) / h
    row = s / 2.0 + radius * torch.cos(2.0 * math.pi * xx / w)
    col = s / 2.0 - radius * torch.sin(2.0 * math.pi * xx / w)
    r0 = torch.floor(row).long().clamp(0, s - 1)
    r1 = (torch.floor(row).long() + 1).clamp(0, s - 1)
    c0 = torch.floor(col).long().clamp(0, s - 1)
    c1 = (torch.floor(col).long() + 1).clamp(0, s - 1)
    out = torch.zeros(b, h, w, c, dtype=torch.float64, device=dev)
    x = tile.to(torch.float64)
    for rr, wr in ((r0, r1 - row), (r1, row - r0)):
        for cc, wc in ((c0, c1 - col), (c1, col - c0)):
            out += x[:, rr, cc, :] * (wr * wc)[None, :, :, None]
    return out.to(torch.float32)


def surface_input(panorama_u8: torch.Tensor, starts: torch.Tensor, width: int,
                  mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """The surface tower's input: the crop at ``starts``, normalized."""
    return normalize(fov_crop(panorama_u8, starts, width), mean, std)


def overhead_input(tile_u8: torch.Tensor, h: int, w: int, mean: Sequence[float],
                   std: Sequence[float]) -> torch.Tensor:
    """The overhead tower's input: the tile normalized, then polar-mapped."""
    return polar(normalize(tile_u8, mean, std), h, w)
