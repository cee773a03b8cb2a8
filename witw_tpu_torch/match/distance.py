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


def _paired_from_corr(o: torch.Tensor, s: torch.Tensor,
                      corr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    orientation = torch.argmax(corr, dim=-1)
    corr_max = torch.amax(corr, dim=-1)
    wsq = window_sq_norms(o, s.shape[2])
    crop_norm = torch.sqrt(torch.gather(wsq, 1, orientation[:, None]))[:, 0]
    s_norm = torch.sqrt((s * s).sum(dim=(1, 2, 3)))
    cos = corr_max / (crop_norm * s_norm).clamp_min(1e-20)
    return 2.0 * (1.0 - cos), orientation.to(torch.int32)


def paired_chord_distance(
    overhead_embed: torch.Tensor, surface_embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chord distance of matching pairs only (the diagonal): overhead[i]
    against surface[i], O(B). Returns (distance [B], orientation int32
    [B])."""
    o = overhead_embed.to(torch.float32)
    s = surface_embed.to(torch.float32)
    w, sw = o.shape[2], s.shape[2]
    if sw > w:
        raise ValueError(f"surface width {sw} exceeds overhead width {w}")
    idx = (torch.arange(w, device=o.device)[:, None] + torch.arange(sw, device=o.device)[None]) % w
    windows = o[:, :, idx, :]  # [B, h, W, sw, c]
    corr = torch.einsum("bhwkc,bhkc->bw", windows, s)
    return _paired_from_corr(o, s, corr)


def paired_chord_distance_fft(
    overhead_embed: torch.Tensor, surface_embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFT form of :func:`paired_chord_distance` (O(B W log W), no window
    materialized): the independent-arithmetic cross-check."""
    o = overhead_embed.to(torch.float32)
    s = surface_embed.to(torch.float32)
    w, sw = o.shape[2], s.shape[2]
    if sw > w:
        raise ValueError(f"surface width {sw} exceeds overhead width {w}")
    s_pad = torch.nn.functional.pad(s, (0, 0, 0, w - sw)) if sw < w else s
    prod = torch.einsum("bhfc,bhfc->bf", torch.fft.rfft(o, dim=2),
                        torch.conj(torch.fft.rfft(s_pad, dim=2)))
    corr = torch.fft.irfft(prod, n=w, dim=-1)  # [B, W]
    return _paired_from_corr(o, s, corr)


def match_scores(distances: torch.Tensor, temperature: float = 10.0) -> torch.Tensor:
    """Heatmap similarity score from chord distance: exp(t (1 - d))
    (reference tools/heatmap/heatmap.py:177)."""
    return torch.exp(temperature * (1.0 - distances))
