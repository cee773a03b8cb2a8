"""The public names of witw_tpu_torch.ops, as witw_tpu.ops exports them."""

from witw_tpu_torch.ops.image import (
    normalize_images,
    denormalize_images,
    resize_bilinear,
    repeat_rows,
)
from witw_tpu_torch.ops.polar import polar_grid, polar_transform
from witw_tpu_torch.ops.fov import fov_crop, random_fov_starts
from witw_tpu_torch.ops.rotation import (
    horizontal_shift,
    quantized_rotation,
    rotate_nearest,
    synced_rotation,
)

__all__ = [
    "normalize_images",
    "denormalize_images",
    "resize_bilinear",
    "repeat_rows",
    "polar_grid",
    "polar_transform",
    "fov_crop",
    "random_fov_starts",
    "horizontal_shift",
    "quantized_rotation",
    "rotate_nearest",
    "synced_rotation",
]
