"""Every draw of a run comes from ``--seed`` and a purpose: the same seed
gives the same weights, inputs and samples, whatever the order of the
draws. Any whole number is a seed (negative ones and ones past 64 bits
included)."""

from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose, e.g. ``derive(seed, "pixels", 3)``."""
    text = repr((int(seed),) + tuple(purpose)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def rng(seed: int, *purpose) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *purpose))
