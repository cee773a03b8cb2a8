"""Chord distance after orientation alignment, streaming form (port of
witw_tpu/match/distance.py; reference model/cvig_fov.py:318-363).

With corr [Bo, Bs, W]: <crop, s> = max_i corr, ||crop||^2 = the circular
sliding-window sum of the overhead map's per-column squared norms at the
argmax, and d = 2 (1 - <crop, s> / (||crop|| ||s||)).
"""

from __future__ import annotations

from typing import Tuple

import torch


def window_sq_norms(overhead_embed: torch.Tensor, window: int) -> torch.Tensor:
    """Squared L2 norm of every circular width-window of each overhead map.

    overhead_embed: [Bo, h, W, c]. Returns [Bo, W] where entry (b, i) is
    sum_{c,h} sum_{k<window} o[b, h, (i+k) % W, c]^2.
    """
    o = overhead_embed.to(torch.float32)
    col_sq = (o * o).sum(dim=(1, 3))  # [Bo, W]
    w = col_sq.shape[-1]
    if window > w:
        raise ValueError(f"window {window} exceeds width {w}")
    if window == w:
        return col_sq.sum(dim=-1, keepdim=True).repeat(1, w)
    ext = torch.cat([col_sq, col_sq[:, : window - 1]], dim=-1)
    csum = torch.cumsum(ext, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=-1)  # prefix sums
    return csum[:, window : window + w] - csum[:, :w]


def chord_distance(
    overhead_embed: torch.Tensor, surface_embed: torch.Tensor, corr: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chord distance 2(1 - cos) of each surface map against each overhead
    map aligned at its estimated orientation. Returns (distance [Bo, Bs],
    orientation int32 [Bo, Bs])."""
    sw = surface_embed.shape[2]
    orientation = torch.argmax(corr, dim=-1)
    corr_max = torch.amax(corr, dim=-1)
    wsq = window_sq_norms(overhead_embed, sw)
    crop_norm = torch.sqrt(torch.gather(wsq, 1, orientation))
    s = surface_embed.to(torch.float32)
    s_norm = torch.sqrt((s * s).sum(dim=(1, 2, 3)))
    # Degenerate all-zero windows or queries give a finite distance (2.0).
    cos = corr_max / (crop_norm.clamp_min(1e-10) * s_norm.clamp_min(1e-10)[None, :])
    return 2.0 * (1.0 - cos), orientation.to(torch.int32)
