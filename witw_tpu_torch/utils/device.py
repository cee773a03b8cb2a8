"""Device selection for the card path."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when no GPU is visible. The card
    path never falls back to the CPU silently."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is False)"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card
    (:func:`require_cuda`)."""
    return torch.device(device) if device is not None else require_cuda()
