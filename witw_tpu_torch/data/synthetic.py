"""Synthetic paired data for the tests and the smoke run (port of
witw_tpu/data/synthetic.py: ``SyntheticPairs`` in memory and
``write_synthetic_dataset`` on disk).

Matched pairs share a low-frequency structure: a few random sinusoids over
the angle, which the surface image sees along x and the overhead tile along
its polar angle. The same seed writes the same files as witw_tpu's.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import numpy as np


def _pair(rng: np.random.Generator, surface_hw, overhead_hw, channels: int):
    h, w = surface_hw
    s = overhead_hw[0]
    n_modes = 4
    amps = rng.uniform(0.5, 1.0, (n_modes, channels))
    freqs = rng.integers(1, 6, n_modes)
    phases = rng.uniform(0, 2 * np.pi, n_modes)

    xs = np.linspace(0, 2 * np.pi, w, endpoint=False)
    surface = np.zeros((h, w, channels), np.float32)
    for a, f, p in zip(amps, freqs, phases):
        surface += np.sin(f * xs[None, :, None] + p) * a[None, None, :]

    yy, xx = np.mgrid[0:s, 0:s]
    theta = np.arctan2(-(xx - s / 2), (yy - s / 2))  # polar angle per pixel
    overhead = np.zeros((s, s, channels), np.float32)
    for a, f, p in zip(amps, freqs, phases):
        overhead += np.sin(f * theta[..., None] + p) * a[None, None, :]

    noise_s = rng.normal(0, 0.3, surface.shape).astype(np.float32)
    noise_o = rng.normal(0, 0.3, overhead.shape).astype(np.float32)
    surface = (surface + noise_s) * 30 + 127
    overhead = (overhead + noise_o) * 30 + 127
    return np.clip(surface, 0, 255), np.clip(overhead, 0, 255)


class SyntheticPairs:
    """In-memory dataset; iterates batches like ``loader.PairLoader``
    (float32 0-255 images, seeded shuffles as witw_tpu's)."""

    def __init__(
        self,
        n: int,
        batch_size: int,
        surface_hw: Tuple[int, int] = (128, 512),
        overhead_hw: Tuple[int, int] = (256, 256),
        channels: int = 3,
        seed: int = 0,
        shuffle: bool = False,
        drop_last: bool = False,
    ):
        rng = np.random.default_rng(seed)
        data = [_pair(rng, surface_hw, overhead_hw, channels) for _ in range(n)]
        self.surface = np.stack([s for s, _ in data])
        self.overhead = np.stack([o for _, o in data])
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.surface)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.surface)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                continue
            yield {"surface": self.surface[idx], "overhead": self.overhead[idx],
                   "idx": idx.astype(np.int32)}


def write_synthetic_dataset(
    directory: str,
    n: int = 16,
    schema: str = "cvusa",
    surface_hw: Tuple[int, int] = (128, 512),
    overhead_hw: Tuple[int, int] = (256, 256),
    channels: int = 3,
    seed: int = 0,
) -> str:
    """Write image files (JPEG surfaces, PNG tiles) and a CSV in a reference
    schema; returns the CSV path. cvusa: headerless, columns [overhead,
    surface] (reference cvig_fov.py:38-44); witw: a 17-column header with
    surface/overhead at columns 15/16 (cvig_fov.py:45-50)."""
    from PIL import Image

    if schema not in ("cvusa", "witw"):
        raise ValueError(schema)
    os.makedirs(os.path.join(directory, "surface"), exist_ok=True)
    os.makedirs(os.path.join(directory, "overhead"), exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        surface, overhead = _pair(rng, surface_hw, overhead_hw, channels)
        s_rel = f"surface/{i:05d}.jpg"
        o_rel = f"overhead/{i:05d}.png"
        Image.fromarray(surface[..., :3].astype(np.uint8)).save(
            os.path.join(directory, s_rel), quality=95
        )
        Image.fromarray(overhead[..., :3].astype(np.uint8)).save(os.path.join(directory, o_rel))
        rows.append((s_rel, o_rel))

    csv_path = os.path.join(directory, "pairs.csv")
    with open(csv_path, "w") as f:
        if schema == "cvusa":
            for s_rel, o_rel in rows:
                f.write(f"{o_rel},{s_rel}\n")
        else:
            cols = [f"col{i}" for i in range(15)] + ["surface_path", "overhead_path"]
            f.write(",".join(cols) + "\n")
            for s_rel, o_rel in rows:
                f.write(",".join([""] * 15 + [s_rel, o_rel]) + "\n")
    return csv_path
