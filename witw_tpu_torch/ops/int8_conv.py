"""Int8 3x3 convolution with a fused requant or dequant epilogue.

Replaces the Pallas TPU kernels ``exp/int8_conv_pallas.py:conv3x3_int8``,
``exp/int8_conv_v2.py:conv3x3_int8_v2`` and
``exp/r4_conv_taps.py:conv3x3_int8_taps`` with a CUDA C++ kernel for Hopper
(``csrc/int8_conv.cu``, built by ``witw_tpu_torch.kernels.build``). It is
every int8 conv of the static-int8 towers outside VGG block 2:

    acc = conv(x, w) + bias_q                          (int32, exact)
    y   = clip(round(float(acc) * m), 0 or -127, 127)   -> int8   (conv3x3_int8)
    y   = float(conv(x, w)) * dequant + bias_f        -> f32    (conv3x3_int8_dequant)

x is int8 NHWC [B, H, W, Cin]; zero height padding 1, height stride 1 or 2,
width stride 1, width padding 1 (zeros) or 0 (width-VALID, on an input the
circular tower has wrap-haloed). Two weight tables describe the same conv:
``w``, the packed int8 [Co, 3, 3, Cin_p] of :func:`pack_weights` (Cin padded
to 4), which the plain versions read; and ``w_wgmma``, the kernel's (and
kernel C's) table (:func:`pack_weights_wgmma`: Cin padded to 32, Co to a
multiple of the channel tile, in the byte order that its ``wgmma`` B
descriptor reads), made once with the tower's tables.

The kernel is an implicit GEMM on Hopper's warpgroup tensor cores
(``wgmma`` m64nNk32, s8 in, s32 accumulate) over 256-pixel x N-channel tiles
(N 128, 64 or 16 by Co, :func:`tile_n`; the pixel tile's shape by the
output's height and width and the stride, :func:`tile_shape`).

The public functions compute the plain PyTorch version on CPU tensors and
launch the kernel, or raise, on CUDA tensors. The plain version computes the
int32 accumulator exactly as im2col patches times the weight matrix with
``torch._int_mm`` (K zero-padded to a multiple of 8), which runs on the CPU
and the GPU, then the same epilogue in torch ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch

# Kernel launches since the last reset (the card path's proof of use).
launches = 0

TILE_PIX = 256  # output pixels of one tile
STEP = 32  # input channels per kernel step (one k32 of s8 wgmma)
CO_MAX = 4096  # the kernel stages the epilogue's two tables of Co words in shared memory


def padded_channels(c: int) -> int:
    """Cin rounded up to a multiple of 4 (one int32 word of 4 channels)."""
    return (c + 3) // 4 * 4


def wgmma_channels(c: int) -> int:
    """Cin rounded up to a multiple of 32 (one kernel step)."""
    return (c + STEP - 1) // STEP * STEP


def tile_n(co: int) -> int:
    """Output channels per tile: 128 for Co > 64, 64 for 16 < Co <= 64
    (conv1_x, conv_25), 16 otherwise (conv_27)."""
    return 128 if co > 64 else 64 if co > 16 else 16


def tile_shape(ho: int, wo: int, stride_h: int = 1) -> tuple:
    """(rows, cols) of the 256-pixel output tile, cols in {8, 16, 32}: the
    fewest padded output pixels at this Ho, Wo, ties to the smallest input
    halo ((rows - 1) stride_h + 3 rows of cols + 2 pixels)."""
    def cost(cols):
        rows = TILE_PIX // cols
        padded = -(-ho // rows) * rows * (-(-wo // cols) * cols)
        return padded, ((rows - 1) * stride_h + 3) * (cols + 2)
    cols = min((16, 8, 32), key=cost)
    return TILE_PIX // cols, cols


def pack_weights(kernel_q: np.ndarray) -> np.ndarray:
    """HWIO int8 [3, 3, Cin, Co] -> int8 [Co, 3, 3, Cin_p], Cin zero-padded
    to a multiple of 4: the plain versions' form."""
    k = _check_hwio(kernel_q)
    cin = k.shape[2]
    k = np.pad(k, ((0, 0), (0, 0), (0, padded_channels(cin) - cin), (0, 0)))
    return np.ascontiguousarray(np.transpose(k, (3, 0, 1, 2)))


def pack_weights_wgmma(kernel_q: np.ndarray) -> np.ndarray:
    """HWIO int8 [3, 3, Cin, Co] -> the kernel's int8 [Co tiles, 9 Cin_p N]
    (N = :func:`tile_n`; Co zero-padded to a multiple of N, Cin to one of
    32). Per channel tile and per 32-channel step, in the order the kernel
    copies into shared memory: [tap (dy, dx)][N / 8 groups][2 k halves][8
    channels][16 k], each 8 x 16 block one 128-byte core matrix of the
    no-swizzle K-major ``wgmma`` B descriptor."""
    k = _check_hwio(kernel_q)
    cin, co = k.shape[2:]
    n, cin_p = tile_n(co), wgmma_channels(cin)
    ct = -(-co // n)
    k = np.pad(k, ((0, 0), (0, 0), (0, cin_p - cin), (0, ct * n - co)))
    k = np.transpose(k.reshape(9, cin_p, ct * n), (2, 1, 0))  # [Co_p, Cin_p, tap]
    k = k.reshape(ct, n // 8, 8, cin_p // STEP, 2, 16, 9)  # [ct, ng, r, step, kg, k, tap]
    return np.ascontiguousarray(np.transpose(k, (0, 3, 6, 1, 4, 2, 5)).reshape(ct, -1))


def unpack_weights_wgmma(packed: np.ndarray, cin: int, co: int) -> np.ndarray:
    """The inverse of :func:`pack_weights_wgmma`: HWIO int8 [3, 3, Cin, Co]."""
    n, cin_p = tile_n(co), wgmma_channels(cin)
    ct = packed.shape[0]
    # [ct, step, tap, ng, kg, r, k]
    k = np.asarray(packed).reshape(ct, cin_p // STEP, 9, n // 8, 2, 8, 16)
    k = np.transpose(k, (2, 1, 4, 6, 0, 3, 5)).reshape(9, cin_p, ct * n)
    return np.ascontiguousarray(k[:, :cin, :co].reshape(3, 3, cin, co))


def _check_hwio(kernel_q) -> np.ndarray:
    k = np.asarray(kernel_q)
    if k.dtype != np.int8 or k.ndim != 4 or k.shape[:2] != (3, 3):
        raise ValueError(f"expected an int8 [3, 3, Cin, Co] kernel, got {k.dtype} {k.shape}")
    return k


def output_hw(h: int, w: int, stride_h: int, pad_w: int):
    return (h - 1) // stride_h + 1, w + 2 * pad_w - 2


def requant(acc: torch.Tensor, m: torch.Tensor, relu: bool) -> torch.Tensor:
    """models/quantize._requant in torch: int32 accumulator -> int8,
    ReLU folded into the clip's lower bound."""
    y = torch.round(acc.to(torch.float32) * m)
    return torch.clamp(y, 0.0 if relu else -127.0, 127.0).to(torch.int8)


def conv3x3_int8_acc_plain(x: torch.Tensor, w: torch.Tensor, stride_h: int = 1,
                           pad_w: int = 1) -> torch.Tensor:
    """Exact int32 accumulator [B, Ho, Wo, Co] of the conv (no bias), by
    im2col + ``torch._int_mm``."""
    b, h, wd, c = x.shape
    co, _, _, cin_p = w.shape
    ho, wo = output_hw(h, wd, stride_h, pad_w)
    xp = F.pad(x, (0, cin_p - c, pad_w, pad_w, 1, 1))
    taps = [xp[:, dy:dy + stride_h * (ho - 1) + 1:stride_h, dx:dx + wo, :]
            for dy in range(3) for dx in range(3)]
    k = 9 * cin_p
    k8 = (k + 7) // 8 * 8
    patches = torch.cat(taps + [xp.new_zeros(b, ho, wo, k8 - k)], dim=-1).reshape(-1, k8)
    m = patches.shape[0]
    if m <= 16:  # cuBLAS's int8 GEMM takes more than 16 rows
        patches = torch.cat([patches, patches.new_zeros(17 - m, k8)])
    # [Co8, K8], Co zero-padded to a multiple of 8 as cuBLAS's int8 GEMM
    # takes: its transpose is column-major
    wmat = F.pad(w.reshape(co, k), (0, k8 - k, 0, -co % 8))
    acc = torch._int_mm(patches, wmat.t())
    return acc[:m, :co].reshape(b, ho, wo, co)


def conv3x3_int8_plain(x, w, bias_q, requant_m, stride_h=1, pad_w=1, relu=True):
    """Plain PyTorch version of :func:`conv3x3_int8`."""
    acc = conv3x3_int8_acc_plain(x, w, stride_h, pad_w) + bias_q
    return requant(acc, requant_m, relu)


def conv3x3_int8_dequant_plain(x, w, dequant, bias_f, stride_h=1, pad_w=1):
    """Plain PyTorch version of :func:`conv3x3_int8_dequant`."""
    acc = conv3x3_int8_acc_plain(x, w, stride_h, pad_w)
    return acc.to(torch.float32) * dequant + bias_f


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("int8_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.witw_conv3x3_int8.argtypes = [ptr] * 5 + [i32] * 11 + [ptr]
    lib.witw_conv3x3_int8.restype = i32
    lib.witw_conv3x3_int8_dequant.argtypes = [ptr] * 5 + [i32] * 10 + [ptr]
    lib.witw_conv3x3_int8_dequant.restype = i32
    return lib


def _launch(entry: str, x, w, w_wgmma, tables, stride_h, pad_w, out_dtype, *flags) -> torch.Tensor:
    """Validate and launch ``entry``, one of the library's two epilogues:
    ``tables`` maps each per-channel table's name to (tensor, dtype);
    ``flags`` are the int arguments after the tile's shape. ValueError for
    an input the kernel does not take."""
    global launches
    if w_wgmma is None:
        raise ValueError(f"{entry} on CUDA tensors reads w_wgmma (pack_weights_wgmma's table)")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or w_wgmma.dtype != torch.int8:
        raise ValueError(f"x, w and w_wgmma must be int8, got {x.dtype}, {w.dtype} and "
                         f"{w_wgmma.dtype}")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[1:3]) != (3, 3):
        raise ValueError(f"expected x [B, H, W, Cin] and w [Co, 3, 3, Cin_p], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, h, wd, c = x.shape
    co, n, cin_p = w.shape[0], tile_n(w.shape[0]), wgmma_channels(c)
    if w.shape[3] != padded_channels(c) or co % 4 != 0 or co > CO_MAX:
        raise ValueError(f"w {tuple(w.shape)} does not fit x {tuple(x.shape)}: Cin_p must be "
                         f"Cin rounded up to a multiple of 4 and Co a multiple of 4 up to {CO_MAX}")
    if tuple(w_wgmma.shape) != (-(-co // n), 9 * cin_p * n):
        raise ValueError(f"w_wgmma {tuple(w_wgmma.shape)} does not fit x {tuple(x.shape)} and "
                         f"Co={co}: expected pack_weights_wgmma's [Co tiles, 9 Cin_p N] = "
                         f"{(-(-co // n), 9 * cin_p * n)}")
    if stride_h not in (1, 2) or pad_w not in (0, 1):
        raise ValueError(f"stride_h must be 1 or 2 and pad_w 0 or 1, got {stride_h}, {pad_w}")
    for name, (t, dtype) in tables.items():
        if t.dtype != dtype or tuple(t.shape) != (co,):
            raise ValueError(f"{name} must be {dtype} [{co}], got {t.dtype} {tuple(t.shape)}")
    ho, wo = output_hw(h, wd, stride_h, pad_w)
    if ho < 1 or wo < 1:
        raise ValueError(f"input {tuple(x.shape)} gives an empty output")
    rows, cols = tile_shape(ho, wo, stride_h)
    if b * h * wd >= 2 ** 31 or -(-co // n) * -(-ho // rows) * -(-wo // cols) * b >= 2 ** 31:
        raise ValueError(f"input {tuple(x.shape)} has too many pixels or tiles for the kernel")
    t1, t2 = (t for t, _ in tables.values())
    device = check_cuda_tensors(entry, x=x, w=w, w_wgmma=w_wgmma,
                                **{n: t for n, (t, _) in tables.items()})
    out = torch.empty((b, ho, wo, co), dtype=out_dtype, device=device)
    if b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        err = getattr(lib, f"witw_{entry}")(
            x.data_ptr(), w_wgmma.data_ptr(), t1.data_ptr(), t2.data_ptr(), out.data_ptr(),
            b, h, wd, c, cin_p, co, stride_h, pad_w, n, cols.bit_length() - 1, *flags,
            torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, entry)
    launches += 1
    return out


def conv3x3_int8(x: torch.Tensor, w: torch.Tensor, bias_q: torch.Tensor,
                 requant_m: torch.Tensor, stride_h: int = 1, pad_w: int = 1,
                 relu: bool = True, w_wgmma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 [B, H, W, Cin] -> int8 [B, Ho, Wo, Co] with the requant
    epilogue; ``w`` is :func:`pack_weights`' table and ``w_wgmma``
    :func:`pack_weights_wgmma`'s of the same weights. CPU tensors take the
    plain version (from ``w``); CUDA tensors launch the kernel (on
    ``w_wgmma``) or raise ValueError for an input it does not take."""
    if x.device.type == "cpu":
        return conv3x3_int8_plain(x, w, bias_q, requant_m, stride_h, pad_w, relu)
    return _launch("conv3x3_int8", x, w, w_wgmma, {"bias_q": (bias_q, torch.int32),
                                                   "requant_m": (requant_m, torch.float32)},
                   stride_h, pad_w, torch.int8, int(relu))


def conv3x3_int8_dequant(x: torch.Tensor, w: torch.Tensor, dequant: torch.Tensor,
                         bias_f: torch.Tensor, stride_h: int = 1, pad_w: int = 1,
                         w_wgmma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 [B, H, W, Cin] -> f32 [B, Ho, Wo, Co] = float(acc) * dequant +
    bias_f (the tower's last conv); weights as :func:`conv3x3_int8`. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return conv3x3_int8_dequant_plain(x, w, dequant, bias_f, stride_h, pad_w)
    return _launch("conv3x3_int8_dequant", x, w, w_wgmma,
                   {"dequant": (dequant, torch.float32), "bias_f": (bias_f, torch.float32)},
                   stride_h, pad_w, torch.float32)
