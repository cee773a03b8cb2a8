"""Orientation-map channels of the baseline family (port of
witw_tpu/ops/orientation_maps.py; Liu & Li, CVPR 2019).

The reference carries them as dead code (model/cvig_baseline.py:163-206):
two u-v channels appended to each view, the normalized row and column
coordinates for the surface view and (radius, azimuth) for the overhead
view. The map is computed once per shape in numpy and broadcast over the
batch.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def orientation_map(height: int, width: int, view: str = "surface") -> np.ndarray:
    """[2, H, W] float32 u-v map. surface: normalized row and column
    coordinates in [-1, 1]; overhead: (normalized radius, azimuth / pi)."""
    shape = (height, width)
    shape_expanded = np.expand_dims(np.array(shape), (1, 2))
    shape_max = max(shape)
    uv = np.indices(shape, dtype=float)
    uv = (2 * uv - shape_expanded + 1) / (shape_max - 1)
    if view == "overhead":
        radius = (np.sqrt(uv[0] ** 2 + uv[1] ** 2) / math.sqrt(2)) * 2.0 - 1.0
        azimuth = np.arctan2(uv[1], -uv[0]) / math.pi
        uv = np.stack([radius, azimuth])
    return uv.astype(np.float32)


def append_orientation_maps(surface: torch.Tensor,
                            overhead: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append the two u-v channels to NHWC surface and overhead batches.

    The batches are in the raw 0-255 image domain, and the baseline encoder
    rescales every channel with -1 + 2 (x / 255) (reference
    cvig_baseline.py:265-266), so the channels are pre-encoded as
    (uv + 1) · 127.5, which that rescale maps back to uv in [-1, 1]."""

    def extend(x: torch.Tensor, view: str) -> torch.Tensor:
        b, h, w, _ = x.shape
        uv = torch.from_numpy(orientation_map(h, w, view)).to(x.device)
        uv = (uv + 1.0) * 127.5
        uv = uv.permute(1, 2, 0)[None].expand(b, h, w, 2)
        return torch.cat([x, uv.to(x.dtype)], dim=-1)

    return extend(surface, "surface"), extend(overhead, "overhead")
