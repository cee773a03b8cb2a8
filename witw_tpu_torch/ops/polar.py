"""Polar transform (port of witw_tpu/ops/polar.py; Shi et al., CVPR 2020).

Output pixel (x, y) of the h_s x w_s pseudo-panorama samples the s_o x s_o
overhead tile at

    row = s_o/2 + s_o/2 * (h_s-1-y)/h_s * cos(2*pi*x/w_s)
    col = s_o/2 - s_o/2 * (h_s-1-y)/h_s * sin(2*pi*x/w_s)

with bilinear interpolation whose corner indices are clipped BEFORE the
weights are computed (reference cvig_fov.py:163-183): at exact-boundary
samples all four weights vanish and the output is 0, not the border pixel.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


class PolarGrid(NamedTuple):
    """Precomputed flat gather indices and bilinear weights.

    idx: int32 [4, h_s*w_s] flat indices into a flattened (s_o*s_o) tile.
    weight: float32 [4, h_s*w_s] matching bilinear corner weights.
    wsum: float32 [h_s, w_s] per-pixel weight sum: 1 in the interior, 0 at
        exact-boundary samples.
    """

    idx: np.ndarray
    weight: np.ndarray
    wsum: np.ndarray
    out_hw: Tuple[int, int]


@functools.lru_cache(maxsize=8)
def polar_grid(
    surface_height: int = 128,
    surface_width: int = 512,
    overhead_size: int = 256,
) -> PolarGrid:
    """Numpy copy of witw_tpu.ops.polar.polar_grid (tests pin the two equal)."""
    h_s, w_s, s_o = surface_height, surface_width, overhead_size
    xx, yy = np.meshgrid(np.arange(w_s), np.arange(h_s))
    radius = (s_o / 2.0) * (h_s - 1 - yy) / h_s
    row = (s_o / 2.0) + radius * np.cos(2.0 * math.pi * xx / w_s)
    col = (s_o / 2.0) - radius * np.sin(2.0 * math.pi * xx / w_s)

    r0 = np.floor(row).astype(np.int64)
    r1 = r0 + 1
    c0 = np.floor(col).astype(np.int64)
    c1 = c0 + 1
    # Clip the corner indices FIRST, then weight from the clipped values.
    r0c = np.clip(r0, 0, s_o - 1)
    r1c = np.clip(r1, 0, s_o - 1)
    c0c = np.clip(c0, 0, s_o - 1)
    c1c = np.clip(c1, 0, s_o - 1)
    w_r0 = r1c - row
    w_r1 = row - r0c
    w_c0 = c1c - col
    w_c1 = col - c0c

    idx = np.stack(
        [
            (r0c * s_o + c0c).reshape(-1),
            (r1c * s_o + c0c).reshape(-1),
            (r0c * s_o + c1c).reshape(-1),
            (r1c * s_o + c1c).reshape(-1),
        ]
    ).astype(np.int32)
    weight = np.stack(
        [
            (w_c0 * w_r0).reshape(-1),
            (w_c0 * w_r1).reshape(-1),
            (w_c1 * w_r0).reshape(-1),
            (w_c1 * w_r1).reshape(-1),
        ]
    ).astype(np.float32)
    wsum = ((r1c - r0c) * (c1c - c0c)).astype(np.float32)
    return PolarGrid(idx=idx, weight=weight, wsum=wsum, out_hw=(h_s, w_s))


@functools.lru_cache(maxsize=8)
def grid_tensors(
    surface_height: int, surface_width: int, overhead_size: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx int64 [4, P], weight f32 [4, P], wsum f32 [h_s, w_s]) on
    ``device``, uploaded once per geometry and device."""
    g = polar_grid(surface_height, surface_width, overhead_size)
    return (
        torch.from_numpy(g.idx.astype(np.int64)).to(device),
        torch.from_numpy(g.weight).to(device),
        torch.from_numpy(g.wsum).to(device),
    )


def polar_transform(
    overhead: torch.Tensor,
    surface_height: int = 128,
    surface_width: int = 512,
    gather_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Polar-map a batch of square overhead tiles to pseudo-panoramas.

    overhead: [B, S, S, C] (NHWC) or [S, S, C]. Returns [B, h_s, w_s, C]
    float32. ``gather_dtype=torch.bfloat16`` rounds the tile to bf16 before
    the gather, as the JAX pipeline does (exact for uint8-valued pixels).
    """
    squeeze = overhead.ndim == 3
    if squeeze:
        overhead = overhead[None]
    b, s, s2, c = overhead.shape
    if s != s2:
        raise ValueError(f"overhead tile must be square, got {tuple(overhead.shape)}")
    idx, weight, _ = grid_tensors(surface_height, surface_width, s, overhead.device)
    flat = overhead.reshape(b, s * s, c).to(gather_dtype)
    corners = flat[:, idx, :].to(torch.float32)  # [B, 4, P, C]
    out = (corners * weight[None, :, :, None]).sum(dim=1)
    out = out.reshape(b, surface_height, surface_width, c)
    return out[0] if squeeze else out
