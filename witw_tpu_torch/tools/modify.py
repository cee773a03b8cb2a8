"""Dataset modification: make aligned CVUSA panoramas look like ordinary photos
(port of witw_tpu/tools/modify.py).

Numpy re-implementation of reference tools/dataset_modification/modify.py,
with witw_tpu's ``np.random.Generator`` draws in the same order; the crops
are host array slices (no device work), and images are read and written
through PIL, imported when ``run`` is called.
Numbered options preserved (reference modify.py:60-105):

- 10: fixed 70-degree random-heading slice out of the panorama
- 20: random zoom (30-60 degree FOV) with an empirical aspect-ratio mixture
      model and vertical jitter around the horizon
- 40: 550^2 center crop of the overhead tile (accurate-geotag effect)
- 50: 550^2 random crop (inaccurate-geotag effect)
- 1 / 2: write the surface / overhead result

The panorama is extended 2x horizontally before slicing so crops wrap the
seam (reference modify.py:58).
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np

# Empirical (probability, height_factor, width_factor) photo aspect mixture
# (reference modify.py:42-48).
ASPECT_MODEL = np.array(
    [
        [0.02, 1.0, 9.0 / 16.0],
        [0.12, 1.0, 2.0 / 3.0],
        [0.13, 1.0, 3.0 / 4.0],
        [0.05, 1.0, 1.0],
        [0.30, 3.0 / 4.0, 1.0],
        [0.33, 2.0 / 3.0, 1.0],
        [0.05, 9.0 / 16.0, 1.0],
    ]
)
ASPECT_CUMSUM = np.cumsum(ASPECT_MODEL[:, 0])


def fov_slice(surface: np.ndarray, rng: np.random.Generator, fov: float = 70.0) -> np.ndarray:
    """Option 10: random-heading fixed-FOV slice (HWC)."""
    h, w = surface.shape[:2]
    width = round(fov / 360.0 * w)
    start = int(rng.integers(0, w))
    ext = np.concatenate([surface, surface], axis=1)
    return ext[:, start : start + width]


def random_zoom(
    surface: np.ndarray,
    rng: np.random.Generator,
    fov_min: float = 30.0,
    fov_max: float = 60.0,
) -> np.ndarray:
    """Option 20: random zoom/orientation/aspect crop with vertical jitter."""
    h, w = surface.shape[:2]
    aov_degrees = fov_min + (fov_max - fov_min) * rng.random()
    aov_pixels = aov_degrees / 360.0 * w
    aspect_index = int(np.argmax(ASPECT_CUMSUM > rng.random()))
    height = round(aov_pixels * ASPECT_MODEL[aspect_index, 1])
    width = round(aov_pixels * ASPECT_MODEL[aspect_index, 2])
    left = int(rng.integers(0, w))
    vert_center = (h - height) / 2.0
    vert_range = min(height / 3.0, h - height)
    top = round(vert_center + (rng.random() - 0.5) * vert_range)
    ext = np.concatenate([surface, surface], axis=1)
    top = max(0, top)
    return ext[top : top + height, left : left + width]


def center_crop(overhead: np.ndarray, size: int = 550) -> np.ndarray:
    """Option 40."""
    h, w = overhead.shape[:2]
    top = round((h - size) / 2)
    left = round((w - size) / 2)
    return overhead[top : top + size, left : left + size]


def random_crop(overhead: np.ndarray, rng: np.random.Generator, size: int = 550) -> np.ndarray:
    """Option 50."""
    h, w = overhead.shape[:2]
    top = int(rng.integers(0, h - size))
    left = int(rng.integers(0, w - size))
    return overhead[top : top + size, left : left + size]


def modify_pair(surface, overhead, options: Sequence[int], rng: np.random.Generator):
    original = surface
    if 10 in options:
        surface = fov_slice(original, rng)
    if 20 in options:
        # The reference crops BOTH options from the ORIGINAL extended
        # panorama (modify.py:61-84 always crop surface_extend): with 10 and
        # 20 together, 20 overrides 10 — it does not compose with 10's
        # slice (whose width would make aov_pixels a ~5-12 degree crop).
        surface = random_zoom(original, rng)
    if 40 in options:
        overhead = center_crop(overhead)
    if 50 in options:
        overhead = random_crop(overhead, rng)
    return surface, overhead


def run(options, surface_in, overhead_in, surface_out, overhead_out, seed=0):
    from PIL import Image

    names = sorted(set(os.listdir(surface_in)) & set(os.listdir(overhead_in)))
    os.makedirs(surface_out, exist_ok=True)
    os.makedirs(overhead_out, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in names:
        with Image.open(os.path.join(surface_in, name)) as im:
            surface = np.asarray(im)
        with Image.open(os.path.join(overhead_in, name)) as im:
            overhead = np.asarray(im)
        surface, overhead = modify_pair(surface, overhead, options, rng)
        if 1 in options:
            Image.fromarray(surface).save(os.path.join(surface_out, name))
        if 2 in options:
            Image.fromarray(overhead).save(os.path.join(overhead_out, name))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Modify dataset imagery")
    parser.add_argument("options", nargs="*", type=int, help="modification options")
    parser.add_argument("--surface_in", required=True)
    parser.add_argument("--overhead_in", required=True)
    parser.add_argument("--surface_out", required=True)
    parser.add_argument("--overhead_out", required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    run(args.options, args.surface_in, args.overhead_in,
        args.surface_out, args.overhead_out, args.seed)


if __name__ == "__main__":
    main()
