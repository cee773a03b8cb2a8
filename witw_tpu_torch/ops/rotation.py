"""Synced rotation augmentation of the baseline family (port of
witw_tpu/ops/rotation.py; reference model/cvig_baseline.py:97-160).

The overhead tile is rotated by a random angle per sample and, when the
surface photo is a panorama, the panorama is rolled by the matching number
of degrees, so that the two views keep their relative orientation. The
rotation is a batched nearest-neighbour gather through one flat index, on
the tensors' device. The angles come from an explicit ``torch.Generator``
in :func:`rotation_degrees`, the one place that draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rotation_degrees(generator: torch.Generator, b: int, quantized: bool = False) -> torch.Tensor:
    """The per-sample draw of :func:`synced_rotation`, on the generator's
    device: quarter-turn factors int64 [B] in [0, 4) with ``quantized``,
    else angles float32 [B] uniform in [0, 360)."""
    if quantized:
        return torch.randint(0, 4, (b,), generator=generator, device=generator.device)
    return torch.rand(b, generator=generator, device=generator.device) * 360.0


def horizontal_shift(img: torch.Tensor, degrees) -> torch.Tensor:
    """Shift a panorama as if the viewer turned clockwise by ``degrees``
    (reference cvig_baseline.py:97-112: roll by -round(deg * W / 360), half
    to even). ``img``: [..., H, W, C] with scalar degrees, or [B, H, W, C]
    with per-sample degrees [B]."""
    w = img.shape[-2]
    degrees = torch.as_tensor(degrees, dtype=torch.float32, device=img.device)
    # a tensor divisor: a true division on the GPU too, which multiplies by
    # the reciprocal of a Python number
    shift = -torch.round(degrees * w / torch.tensor(360.0, device=img.device)).to(torch.int64)
    if shift.ndim == 0:
        return torch.roll(img, int(shift), dims=img.ndim - 2)
    if img.ndim != 4:
        raise ValueError(f"per-sample degrees need a [B, H, W, C] img, got shape "
                         f"{tuple(img.shape)}")
    b, h, _, c = img.shape
    cols = (torch.arange(w, device=img.device)[None, :] - shift[:, None]) % w  # [B, W]
    return torch.gather(img, 2, cols[:, None, :, None].expand(b, h, w, c))


def quantized_rotation(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Rotate by factor x 90 degrees by transposes and flips, HWC or NHWC:
    exactly the reference's compositions (cvig_baseline.py:115-127), which
    turn the displayed image CLOCKWISE for factor 1 (top-left lands
    top-right), the opposite of the live path's torchvision rotation. Kept
    as the reference has it."""
    h_ax, w_ax = img.ndim - 3, img.ndim - 2
    f = factor % 4
    if f == 0:
        return img
    if f == 1:
        return torch.flip(img.transpose(h_ax, w_ax), dims=(w_ax,))
    if f == 2:
        return torch.flip(img, dims=(h_ax, w_ax))
    return torch.flip(img.transpose(h_ax, w_ax), dims=(h_ax,))


def _rotate_indices(h: int, w: int, degrees: torch.Tensor):
    """(valid, yi, xi), each [B, H, W]: the nearest source pixel of each
    output pixel under a counter-clockwise rotation by ``degrees`` [B] about
    the image centre (the inverse sampling map R(+theta), y pointing down),
    rounded half to even as ``jnp.round``."""
    theta = degrees.to(torch.float32) * (math.pi / 180.0)
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    cy = (h - 1) / 2.0
    cx = (w - 1) / 2.0
    ii, jj = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=degrees.device),
        torch.arange(w, dtype=torch.float32, device=degrees.device),
        indexing="ij",
    )
    dy = ii - cy
    dx = jj - cx
    src_x = cos_t * dx - sin_t * dy + cx
    src_y = sin_t * dx + cos_t * dy + cy
    xi = torch.round(src_x).to(torch.int64)
    yi = torch.round(src_y).to(torch.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    return valid, yi.clamp(0, h - 1), xi.clamp(0, w - 1)


def rotate_nearest(img: torch.Tensor, degrees) -> torch.Tensor:
    """Rotate image content counter-clockwise about the centre with
    nearest-neighbour sampling and zero fill (the torchvision ``rotate``
    defaults of the reference, cvig_baseline.py:142-143). ``img``: [H, W, C]
    with a scalar angle, or [B, H, W, C] with a scalar or per-sample [B]
    angles. The batch gathers through one flat [B·H·W] index into the
    [B·H·W, C] rows, as witw_tpu does."""
    if img.ndim == 3:
        return rotate_nearest(img[None], degrees)[0]
    b, h, w, c = img.shape
    degs = torch.as_tensor(degrees, dtype=torch.float32, device=img.device).expand(b)
    valid, yi, xi = _rotate_indices(h, w, degs)
    base = (torch.arange(b, device=img.device) * (h * w))[:, None, None]
    gidx = (yi * w + xi + base).reshape(-1)
    out = img.reshape(b * h * w, c)[gidx]
    out = torch.where(valid.reshape(-1, 1), out, torch.zeros((), dtype=img.dtype,
                                                              device=img.device))
    return out.reshape(b, h, w, c)


def synced_rotation(generator: torch.Generator, surface: torch.Tensor, overhead: torch.Tensor,
                    panorama: bool, quantized: bool = False,
                    draw: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random rotation per sample (:func:`rotation_degrees`, or ``draw``
    when the caller made it): the overhead [B, S, S, C] rotated, a panorama
    surface [B, H, W, C] rolled to match (reference
    cvig_baseline.py:130-160). Returns (surface, overhead).

    The quantized mode pairs the continuous mode's horizontal shift with
    :func:`quantized_rotation`'s clockwise compositions, so for factors 1
    and 3 the relative orientation differs from the continuous mode's: the
    reference's behaviour, reproduced bit for bit."""
    if draw is None:
        draw = rotation_degrees(generator, surface.shape[0], quantized)
    draw = draw.to(overhead.device)
    if quantized:
        degrees = draw.to(torch.float32) * 90.0
        overhead = torch.stack([quantized_rotation(overhead[i], int(f))
                                for i, f in enumerate(draw.tolist())])
    else:
        degrees = draw
        overhead = rotate_nearest(overhead, degrees)
    if panorama:
        surface = horizontal_shift(surface, degrees)
    return surface, overhead
