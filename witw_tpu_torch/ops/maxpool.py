"""2x2 / stride-2 max pool over NHWC.

Replaces the Pallas TPU kernel ``exp/pallas_maxpool.py:maxpool2x2`` with a
CUDA C++ kernel for Hopper (``csrc/maxpool.cu``): pools 1 and 3 of the
static-int8 towers. A trailing odd row or column is dropped (floor), as
``reduce_window`` VALID does. The kernel takes int8, bf16 and f32 and is
bound by device-memory bandwidth.

:func:`maxpool2x2` computes the plain PyTorch version
(:func:`maxpool2x2_plain`) on CPU tensors and launches the kernel, or
raises, on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch

# Kernel launches since the last reset (the card path's proof of use).
launches = 0

DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def maxpool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H // 2, W // 2, C]: amax over 2 x 2 windows."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, :2 * h2, :2 * w2].reshape(b, h2, 2, w2, 2, c).amax(dim=(2, 4))


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("maxpool")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.witw_maxpool2x2.argtypes = [ptr, ptr] + [i32] * 5 + [ptr]
    lib.witw_maxpool2x2.restype = i32
    return lib


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] int8, bf16 or f32 -> [B, H // 2, W // 2, C]. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise
    ValueError for an input it does not take."""
    global launches
    if x.device.type == "cpu":
        return maxpool2x2_plain(x)
    if x.dtype not in DTYPE_CODES or x.ndim != 4:
        raise ValueError(f"maxpool2x2 takes int8, bf16 or f32 [B, H, W, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    device = check_cuda_tensors("maxpool2x2", x=x)
    b, h, w, c = x.shape
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.witw_maxpool2x2(x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype],
                                  b, h, w, c, torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, "maxpool2x2")
    launches += 1
    return out
