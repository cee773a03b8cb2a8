"""Checks shared by the kernel wrappers: the inputs a launch takes, and the
CUDA error code it returns."""

from __future__ import annotations

import ctypes

import torch


def check_cuda_tensors(what: str, align: int = 16, **tensors) -> torch.device:
    """The one CUDA device that holds every tensor, all contiguous and
    ``align``-byte aligned; ValueError otherwise."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{what} needs all inputs on one CUDA device, got "
            + ", ".join(f"{n} on {t.device}" for n, t in tensors.items())
        )
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % align != 0:
            raise ValueError(f"{what}: {name} must be {align}-byte aligned")
    return next(iter(devices))


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a library's launch function returned a CUDA error code. The
    library must export ``witw_cuda_error_string``."""
    if err != 0:
        lib.witw_cuda_error_string.argtypes = [ctypes.c_int]
        lib.witw_cuda_error_string.restype = ctypes.c_char_p
        msg = lib.witw_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
