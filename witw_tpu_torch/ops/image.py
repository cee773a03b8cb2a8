"""Batched NHWC image normalization, bilinear resize and the baseline
family's row repeat (port of witw_tpu/ops/image.py)."""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# Normalization constant sets built since the last reset, one per new key
# (the card path's proof that a warm batch uploads nothing).
constant_uploads = 0


@functools.lru_cache(maxsize=None)
def _constants(
    c: int, scale_channels: int | None, mean: Tuple[float, ...], std: Tuple[float, ...],
    device: torch.device,
) -> Tuple[torch.Tensor, ...]:
    """(scale, mean_t, std_t, k, b) float32 on ``device``, built once per
    key: the per-channel scale (1/255 on the first ``scale_channels`` of the
    ``c`` channels, 1 on the rest), ``mean`` and ``std`` in one host-to-device
    copy, then ``k = scale / std_t`` and ``b = -mean_t / std_t`` there.
    Every call with the key shares them, so nothing writes them in place;
    they are built outside inference mode, so that a training step may save
    them for its backward pass."""
    global constant_uploads
    if scale_channels is None:
        scale_channels = c
    scale = [1.0 / 255.0 if i < scale_channels else 1.0 for i in range(c)]
    with torch.inference_mode(False):
        flat = torch.tensor(scale + list(mean) + list(std), dtype=torch.float32).to(device)
        scale_t, mean_t, std_t = flat.split([c, len(mean), len(std)])
        k = scale_t / std_t
        b = -mean_t / std_t
    constant_uploads += 1
    return scale_t, mean_t, std_t, k, b


def _constants_for(x: torch.Tensor, mean: Sequence[float], std: Sequence[float],
                   scale_channels: int | None = None) -> Tuple[torch.Tensor, ...]:
    """:func:`_constants` for ``x``'s channel count and device."""
    return _constants(x.shape[-1], scale_channels, tuple(float(v) for v in mean),
                      tuple(float(v) for v in std), x.device)


def normalize_images(
    x: torch.Tensor,
    mean: Sequence[float],
    std: Sequence[float],
    scale_channels: int | None = None,
) -> torch.Tensor:
    """Scale to [0,1] and standardize per channel. NHWC.

    ``scale_channels`` limits the /255 scaling to the first k channels: the
    semantic variant divides only RGB by 255 while the extra mask channels are
    standardized raw (reference cvig_semantic.py:173-176, a quirk kept for
    parity).
    """
    x = x.to(torch.float32)
    scale, mean_t, std_t, _, _ = _constants_for(x, mean, std, scale_channels)
    return (x * scale - mean_t) / std_t


def normalize_images_masked_bias(
    x: torch.Tensor,
    mean: Sequence[float],
    std: Sequence[float],
    bias_mask: torch.Tensor,
    scale_channels: int | None = None,
) -> torch.Tensor:
    """``x*k + b*mask`` instead of ``(x*k + b)*mask``: the polar-then-normalize
    path's correction at exact-boundary polar samples, where the gather
    weights are all zero and only the normalization bias must be masked
    (see witw_tpu/ops/image.py). bias_mask: [H, W] 0/1 float mask.
    """
    x = x.to(torch.float32)
    _, _, _, k, b = _constants_for(x, mean, std, scale_channels)
    mask = torch.as_tensor(bias_mask, dtype=torch.float32, device=x.device)
    return x * k + mask[..., None] * b


def denormalize_images(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Inverse of the standardization step (reference cvig_fov.py:151-154)."""
    _, mean_t, std_t, _, _ = _constants_for(x, mean, std)
    return x * std_t + mean_t


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of an NHWC batch or an HWC image with half-pixel
    centers and no antialiasing (torchvision's ``functional.resize`` as the
    reference uses it, e.g. cvig_fov.py:119,133), computed in f32. A float
    input keeps its dtype; any other comes back as float32."""
    if x.ndim not in (3, 4):
        raise ValueError(f"expected HWC or NHWC, got shape {tuple(x.shape)}")
    nchw = (x[None] if x.ndim == 3 else x).to(torch.float32).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(height, width), mode="bilinear", align_corners=False,
                        antialias=False).permute(0, 2, 3, 1)
    if x.ndim == 3:
        out = out[0]
    return out.to(x.dtype) if x.is_floating_point() else out


def repeat_rows(x: torch.Tensor, repeats: int = 2) -> torch.Tensor:
    """Repeat rows (the H axis) of an NHWC or HWC image: the baseline
    family's CVUSA surface resize (reference cvig_baseline.py:216-218)."""
    return torch.repeat_interleave(x, repeats, dim=x.ndim - 3)
