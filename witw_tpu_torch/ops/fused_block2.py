"""VGG block 2 of the static-int8 towers in one pass: conv2_1 -> requant ->
conv2_2 -> requant -> 2x2 max pool, with conv2_1's output kept on chip.

Replaces the Pallas TPU kernels ``exp/fused_block2.py:fused_block2`` and
``exp/fused_block2_v2.py:fused_block2_v2`` with a CUDA C++ kernel for Hopper
(``csrc/fused_block2.cu``). Input: the pool-1 output, int8 [B, H, W, 64];
output: the pool-2 output, int8 [B, H // 2, W // 2, 128]. Weights are the
packed int8 [128, 3, 3, Cin] form (``ops.int8_conv.pack_weights``), biases
int32 [128], requant multipliers f32 [128]; both convs fold ReLU. Zero width
padding, or ``circular``: the JAX tower's block halo of 2 wrapped columns
followed by two width-VALID convs. Any H and W, even or odd.

:func:`fused_block2` computes the plain PyTorch version
(:func:`fused_block2_plain`: plain conv, plain conv, plain pool) on CPU
tensors and launches the kernel, or raises, on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.models.backbones.vgg16 import wrap_pad_width
from witw_tpu_torch.ops.int8_conv import conv3x3_int8_plain
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch
from witw_tpu_torch.ops.maxpool import maxpool2x2_plain

# Kernel launches since the last reset (the card path's proof of use).
launches = 0

C_IN, C_OUT = 64, 128
POOL_TILE = 8  # pool-2 outputs per block side, as kPoolTile in the source
GRID_LIMIT = 65535
SMEM_LIMIT_BYTES = 232448


def fused_block2_plain(x, w1, b1, m1, w2, b2, m2, circular: bool = False):
    """Plain PyTorch version of :func:`fused_block2`."""
    pad_w = 0 if circular else 1
    if circular:
        x = wrap_pad_width(x, 2, dim=2)
    y1 = conv3x3_int8_plain(x, w1, b1, m1, pad_w=pad_w)
    return maxpool2x2_plain(conv3x3_int8_plain(y1, w2, b2, m2, pad_w=pad_w))


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("fused_block2")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.witw_fused_block2.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.witw_fused_block2.restype = i32
    lib.witw_fused_block2_smem_bytes.argtypes = []
    lib.witw_fused_block2_smem_bytes.restype = ctypes.c_size_t
    if lib.witw_fused_block2_smem_bytes() > SMEM_LIMIT_BYTES:
        raise RuntimeError("fused_block2 was built with more shared memory than a block may use")
    return lib


def fused_block2(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, m1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, m2: torch.Tensor,
                 circular: bool = False) -> torch.Tensor:
    """int8 [B, H, W, 64] -> int8 [B, H // 2, W // 2, 128]. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise ValueError
    for an input it does not take."""
    global launches
    if x.device.type == "cpu":
        return fused_block2_plain(x, w1, b1, m1, w2, b2, m2, circular)
    expect = {
        "x": (x, torch.int8, None),
        "w1": (w1, torch.int8, (C_OUT, 3, 3, C_IN)),
        "b1": (b1, torch.int32, (C_OUT,)),
        "m1": (m1, torch.float32, (C_OUT,)),
        "w2": (w2, torch.int8, (C_OUT, 3, 3, C_OUT)),
        "b2": (b2, torch.int32, (C_OUT,)),
        "m2": (m2, torch.float32, (C_OUT,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"fused_block2: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x.ndim != 4 or x.shape[3] != C_IN:
        raise ValueError(f"fused_block2: x must be [B, H, W, {C_IN}], got {tuple(x.shape)}")
    b, h, w, _ = x.shape
    if circular and w < 2:
        raise ValueError(f"fused_block2: a circular width needs W >= 2, got {w}")
    if (h // 2 + POOL_TILE - 1) // POOL_TILE > GRID_LIMIT or b > GRID_LIMIT:
        raise ValueError(f"fused_block2: input {tuple(x.shape)} exceeds the launch grid")
    device = check_cuda_tensors("fused_block2", **{n: t for n, (t, _, _) in expect.items()})
    out = torch.empty((b, h // 2, w // 2, C_OUT), dtype=torch.int8, device=device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.witw_fused_block2(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), m1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), m2.data_ptr(), out.data_ptr(),
            b, h, w, int(circular), torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, "fused_block2")
    launches += 1
    return out
