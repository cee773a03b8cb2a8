"""Field-of-view crop with horizontal wraparound (port of witw_tpu/ops/fov.py).

A static-shape modular gather batched over per-sample start offsets
(reference model/cvig_fov.py:117-129).
"""

from __future__ import annotations

import torch


def random_fov_starts(
    generator: torch.Generator, batch: int, width_max: int, device=None
) -> torch.Tensor:
    """Per-sample random crop origins in [0, width_max), drawn from
    ``generator`` (on the generator's device) and returned on ``device``."""
    starts = torch.randint(
        0, width_max, (batch,), generator=generator, device=generator.device
    )
    return starts.to(device) if device is not None else starts


def fov_crop(surface: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """Crop a width-``width`` window starting at per-sample ``starts``,
    wrapping around the panorama seam.

    surface: [B, H, W_max, C] NHWC. starts: int [B]. Returns [B, H, width, C].
    """
    b, h, w_max, c = surface.shape
    ar = torch.arange(width, device=surface.device)
    cols = (starts.to(surface.device).long()[:, None] + ar[None, :]) % w_max
    index = cols[:, None, :, None].expand(b, h, width, c)
    return torch.gather(surface, 2, index)
