"""VGG block 2 of the static-int8 towers in one pass: conv2_1 -> requant ->
conv2_2 -> requant -> 2x2 max pool, with conv2_1's output kept on chip.

Replaces the Pallas TPU kernels ``exp/fused_block2.py:fused_block2`` and
``exp/fused_block2_v2.py:fused_block2_v2`` with a CUDA C++ kernel for Hopper
on s8 ``wgmma`` (``csrc/fused_block2.cu``, kernel C). Input: the pool-1
output, int8 [B, H, W, 64]; output: the pool-2 output, int8 [B, H // 2,
W // 2, 128]. Biases int32 [128], requant multipliers f32 [128]; both convs
fold ReLU. Zero width padding, or ``circular``: the JAX tower's block halo of
2 wrapped columns followed by two width-VALID convs. Any H and W, even or
odd. Two weight tables describe each conv, as for
``ops.int8_conv.conv3x3_int8``: the packed int8 [128, 3, 3, Cin]
(``ops.int8_conv.pack_weights``), which the plain version reads, and
kernel A's ``pack_weights_wgmma`` table, which the kernel reads.

The kernel tiles the output into 16 x 16 conv2_2 outputs (8 x 8 pool
outputs) x 128 channels; per tile it computes conv2_1 on the 18 x 18 y1
tile as a flat GEMM over the 20-pixel pitch of its 20 x 20 input halo
(:func:`geometry`), keeps y1 in shared memory, and pools conv2_2 in
registers.

:func:`fused_block2` computes the plain PyTorch version
(:func:`fused_block2_plain`: plain conv, plain conv, plain pool) on CPU
tensors and launches the kernel, or raises, on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.models.backbones.vgg16 import wrap_pad_width
from witw_tpu_torch.ops.int8_conv import STEP, conv3x3_int8_plain
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch
from witw_tpu_torch.ops.maxpool import maxpool2x2_plain

# Kernel launches since the last reset (the card path's proof of use).
launches = 0

C_IN, C_OUT = 64, 128
# The kernel's tiling, as the constants of csrc/fused_block2.cu.
TILE = 16  # conv2_2 outputs per tile side (kTile)
POOL_TILE = TILE // 2
Y1_SIDE = TILE + 2  # y1 tile side (kY1)
HALO_PITCH = TILE + 4  # input halo side, and stage 1's row pitch (kX)
STAGE1_M = -(-((Y1_SIDE - 1) * HALO_PITCH + Y1_SIDE) // 64) * 64  # flat rows, m64 blocks (kM1)
STAGES = 4  # weight ring stages
CONSUMER_WARPS = 8
SMEM_LIMIT_BYTES = 232448


def smem_bytes() -> int:
    """Dynamic shared memory of one block (kSmemBytes): the weight ring, the
    input halo's 4 planes (sized for the junk rows' reads), y1's 8 planes,
    1 KB of epilogue staging per consumer warp, the four epilogue tables and
    the mbarriers."""
    ring = STAGES * 9 * STEP * C_OUT
    halo_plane = -(-(STAGE1_M + 2 * HALO_PITCH + 2) // 8) * 8 * 16
    y1 = (C_OUT // 16) * Y1_SIDE * Y1_SIDE * 16
    staging = CONSUMER_WARPS * POOL_TILE * C_OUT
    return ring + (C_IN // 16) * halo_plane + y1 + staging + 4 * C_OUT * 4 + 8 * (2 * STAGES + 2)


def geometry(b: int, h: int, w: int) -> dict:
    """The kernel's work for an input [b, h, w, 64]: tiles (each 8 x 8 pool
    outputs of one image), the halo pitch, stage 1's flat M per tile and
    the shared memory of a block."""
    tiles = b * -(-(h // 2) // POOL_TILE) * -(-(w // 2) // POOL_TILE)
    return {"tiles": tiles, "halo_pitch": HALO_PITCH, "stage1_m": STAGE1_M,
            "smem_bytes": smem_bytes()}


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
    if lib.witw_fused_block2_smem_bytes() != smem_bytes():
        raise RuntimeError(f"fused_block2 was built with {lib.witw_fused_block2_smem_bytes()} bytes "
                           f"of shared memory, not the {smem_bytes()} of ops/fused_block2.py")
    return lib


def fused_block2(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, m1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, m2: torch.Tensor, circular: bool = False,
                 w1_wgmma: Optional[torch.Tensor] = None,
                 w2_wgmma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 [B, H, W, 64] -> int8 [B, H // 2, W // 2, 128]. ``w1``, ``w2`` are
    :func:`~witw_tpu_torch.ops.int8_conv.pack_weights`' tables and
    ``w1_wgmma``, ``w2_wgmma`` ``pack_weights_wgmma``'s of the same weights.
    CPU tensors take the plain version (from ``w1``, ``w2``); CUDA tensors
    launch the kernel (on ``w1_wgmma``, ``w2_wgmma``) or raise ValueError
    for an input it does not take."""
    global launches
    if x.device.type == "cpu":
        return fused_block2_plain(x, w1, b1, m1, w2, b2, m2, circular)
    if w1_wgmma is None or w2_wgmma is None:
        raise ValueError("fused_block2 on CUDA tensors reads w1_wgmma and w2_wgmma "
                         "(pack_weights_wgmma's tables)")
    expect = {
        "x": (x, torch.int8, None),
        "w1": (w1, torch.int8, (C_OUT, 3, 3, C_IN)),
        "b1": (b1, torch.int32, (C_OUT,)),
        "m1": (m1, torch.float32, (C_OUT,)),
        "w2": (w2, torch.int8, (C_OUT, 3, 3, C_OUT)),
        "b2": (b2, torch.int32, (C_OUT,)),
        "m2": (m2, torch.float32, (C_OUT,)),
        "w1_wgmma": (w1_wgmma, torch.int8, (1, 9 * C_IN * C_OUT)),
        "w2_wgmma": (w2_wgmma, torch.int8, (1, 9 * C_OUT * C_OUT)),
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
    if geometry(b, h, w)["tiles"] >= 2 ** 31:
        raise ValueError(f"fused_block2: input {tuple(x.shape)} has too many tiles for the kernel")
    device = check_cuda_tensors("fused_block2", **{n: t for n, (t, _, _) in expect.items()})
    out = torch.empty((b, h // 2, w // 2, C_OUT), dtype=torch.int8, device=device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.witw_fused_block2(
            x.data_ptr(), w1_wgmma.data_ptr(), b1.data_ptr(), m1.data_ptr(),
            w2_wgmma.data_ptr(), b2.data_ptr(), m2.data_ptr(), out.data_ptr(),
            b, h, w, int(circular), torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, "fused_block2")
    launches += 1
    return out
