"""Kernel A of the static-int8 towers, decomposed into its stages: the port
of ``exp/int8_isolate.py``.

    python3 -m witw_tpu_torch.exp.int8_isolate

The TPU script ran its int8 conv kernel with stages removed, to see where
its time went. Those stages (DMA, patch build, one big dot) do not exist on
Hopper, so the port decomposes its own kernel A (``csrc/int8_conv.cu``:
persistent, warp-specialised, a producer warpgroup filling a ring of
32-channel steps, two consumer warpgroups on s8 ``wgmma`` over the halo's
tap-shifted descriptors, the requant epilogue), the same way, in
``csrc/conv_like.cu`` (replacing the Pallas TPU kernel
``exp/int8_isolate.py:conv_like``): kernel A's design over 16 x 16-pixel x
N-channel tiles, specialised to the probe's pre-padded input. For xp int8
[B, H + 2, WP8, C] (columns >= W + 2 unused), wmat int8 [9C, N] (row (3 dy
+ dx) C + c) and m f32 [1, N], C and N multiples of 32:

  full     — y[b, h, w, n] = clip(round(float(sum_{dy, dx, c} xp[b, h + dy, w + dx, c]
             * wmat[(3 dy + dx) C + c, n]) * m[n]), 0, 127): the whole kernel;
  nodma    — the producers copy no halo from device memory (zero planes; the
             weights still arrive): full - nodma is the cost of the input's
             copies;
  nopatch  — the halo is copied in, but every tap's ``wgmma`` reads one
             resident zero tile in place of the tap-shifted halo: full -
             nopatch is what the shifted implicit-GEMM operand costs over a
             resident one;
  torch_mm — ``torch._int_mm`` + the requant in torch ops at [65536 x 1152 x
             128], the cuBLAS GEMM yardstick (plain PyTorch, no kernel).

Both stripped modes compute zeros, here and in the plain version (the TPU's
were undefined: they read uninitialized scratch). CPU tensors take the plain
version; CUDA tensors launch the kernel or raise ValueError for an input it
does not take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from witw_tpu_torch.exp import card
from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.ops import int8_conv
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch
from witw_tpu_torch.utils.profiling import cuda_ms

# The TPU script's shapes: one step is a [32, 64, 256] x 128 -> 128 conv.
B, H, W, C, N = 32, 64, 256, 128, 128
WP8 = -(-(W + 2) // 32) * 32
STEPS = 2
FL = 2 * 9 * C * N * B * H * W  # operations per step
M2 = 65536  # rows of the torch_mm yardstick

MODES = ("full", "nopatch", "nodma")  # the kernel's mode argument is the index

# Kernel launches since the last reset, per mode (the card path's proof of use).
launches = {mode: 0 for mode in MODES}

# Output tile of one block (kTile in conv_like.cu) and its channels
# (int8_conv.tile_n of N: 128 or 64).
TILE_ROWS = TILE_COLS = 16
CO_MAX = int8_conv.CO_MAX  # the kernel stages m, Co floats, in shared memory
INDEX_LIMIT = 2 ** 31  # the kernel's int pixel and tile indices


def pack_wmat(wmat: torch.Tensor) -> torch.Tensor:
    """wmat int8 [9C, N] -> kernel A's packed int8 [N, 3, 3, C]."""
    c = wmat.shape[0] // 9
    return wmat.reshape(3, 3, c, wmat.shape[1]).permute(3, 0, 1, 2).contiguous()


def conv_like_plain(xp: torch.Tensor, wmat: torch.Tensor, m: torch.Tensor, mode: str,
                    width: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv_like`: kernel A's plain
    accumulator (im2col + ``torch._int_mm``) on the first width + 2 columns,
    width-VALID, its two zero-padded border rows dropped; then the requant
    with ReLU's clip. Zeros for the stripped modes."""
    b, hp = xp.shape[:2]
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode != "full":
        return torch.zeros(b, hp - 2, width, wmat.shape[1], dtype=torch.int8, device=xp.device)
    acc = int8_conv.conv3x3_int8_acc_plain(xp[:, :, :width + 2], pack_wmat(wmat), 1, 0)
    return int8_conv.requant(acc[:, 1:-1], m.reshape(-1), relu=True)


def pack_wmat_wgmma(wmat: torch.Tensor) -> torch.Tensor:
    """wmat int8 [9C, N] (C a multiple of 32) -> the kernel's weight table,
    ``ops/int8_conv.pack_weights_wgmma`` of the same weights in torch ops
    (on wmat's device): [N tiles, 9 C tile_n], N zero-padded to a multiple
    of tile_n, per 32-channel step in the order the B descriptor reads."""
    if wmat.ndim != 2 or wmat.shape[0] % (9 * int8_conv.STEP) or wmat.shape[1] % 32:
        raise ValueError(f"expected wmat [9C, N] with C and N multiples of 32, got "
                         f"{tuple(wmat.shape)}")
    c, co = wmat.shape[0] // 9, wmat.shape[1]
    n = int8_conv.tile_n(co)
    ct = -(-co // n)
    k = torch.zeros((9, c, ct * n), dtype=wmat.dtype, device=wmat.device)
    k[:, :, :co] = wmat.reshape(9, c, co)
    k = k.permute(2, 1, 0).reshape(ct, n // 8, 8, c // int8_conv.STEP, 2, 16, 9)
    return k.permute(0, 3, 6, 1, 4, 2, 5).reshape(ct, -1).contiguous()


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("conv_like")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.witw_conv_like.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    lib.witw_conv_like.restype = i32
    return lib


def conv_like_kernel(xp: torch.Tensor, w_wgmma: torch.Tensor, m: torch.Tensor, mode: str,
                     width: int) -> torch.Tensor:
    """Launch the kernel: xp int8 [B, H + 2, WP, C], w_wgmma int8
    (:func:`pack_wmat_wgmma`), m f32 [1, N] -> int8 [B, H, width, N].
    ValueError for an input the kernel does not take."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if xp.dtype != torch.int8 or w_wgmma.dtype != torch.int8 or m.dtype != torch.float32:
        raise ValueError(f"xp and w_wgmma must be int8 and m float32, got {xp.dtype}, "
                         f"{w_wgmma.dtype} and {m.dtype}")
    if xp.ndim != 4:
        raise ValueError(f"expected xp [B, H + 2, WP, C], got {tuple(xp.shape)}")
    b, hp, wp, c = xp.shape
    n = m.numel()
    if c % 32 or n % 32 or not 0 < n <= CO_MAX or c == 0:
        raise ValueError(f"C and N must be positive multiples of 32 (N <= {CO_MAX}), got "
                         f"C={c} N={n}")
    tile_n = int8_conv.tile_n(n)
    if tuple(w_wgmma.shape) != (-(-n // tile_n), 9 * c * tile_n):
        raise ValueError(f"w_wgmma {tuple(w_wgmma.shape)} does not fit C={c} N={n}: expected "
                         f"{(-(-n // tile_n), 9 * c * tile_n)} (pack_wmat_wgmma)")
    if hp < 3 or not 1 <= width <= wp - 2:
        raise ValueError(f"xp {tuple(xp.shape)} does not hold a padded [H, {width}] input")
    tiles = -(-n // tile_n) * -(-(hp - 2) // TILE_ROWS) * -(-width // TILE_COLS) * b
    if b * hp * wp >= INDEX_LIMIT or tiles >= INDEX_LIMIT:
        raise ValueError(f"xp {tuple(xp.shape)} has too many pixels or tiles for the kernel")
    device = check_cuda_tensors("conv_like", xp=xp, w_wgmma=w_wgmma, m=m)
    out = torch.empty((b, hp - 2, width, n), dtype=torch.int8, device=device)
    if b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.witw_conv_like(xp.data_ptr(), w_wgmma.data_ptr(), m.data_ptr(), out.data_ptr(),
                                 b, hp - 2, wp, c, n, width, tile_n, MODES.index(mode),
                                 torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, "conv_like")
    launches[mode] += 1
    return out


def conv_like(xp: torch.Tensor, wmat: torch.Tensor, m: torch.Tensor, mode: str,
              width: int) -> torch.Tensor:
    """int8 xp [B, H + 2, WP, C] (pre-padded), wmat [9C, N], m f32 [1, N] ->
    int8 [B, H, width, N] (``mode`` full, nopatch or nodma)."""
    if xp.device.type == "cpu":
        return conv_like_plain(xp, wmat, m, mode, width)
    if wmat.ndim != 2 or wmat.shape[0] != 9 * xp.shape[-1] or wmat.shape[1] != m.numel():
        raise ValueError(f"wmat {tuple(wmat.shape)} does not fit xp {tuple(xp.shape)} and m "
                         f"{tuple(m.shape)}: expected [9C, N]")
    return conv_like_kernel(xp, pack_wmat_wgmma(wmat), m, mode, width)


def torch_mm(x2d: torch.Tensor, wmat_t: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The GEMM yardstick: int8 [M, 9C] x wmat (given as wmat^T [N, 9C], so
    that cuBLAS reads it column-major), then the requant in torch ops."""
    return int8_conv.requant(torch._int_mm(x2d, wmat_t.t()), m.reshape(-1), relu=True)


def step_ms(fn, inputs) -> float:
    """Median device ms per step of ``fn`` over the STEPS inputs in turn."""
    step = iter(range(10 ** 9))
    return cuda_ms(lambda: fn(inputs[next(step) % len(inputs)]), len(inputs), 5)


def run(device: Optional[torch.device] = None) -> Dict[str, float]:
    """The TPU script's report on the card: ms per step of each mode and of
    the torch GEMM, {'full': ms, 'nopatch': ms, 'nodma': ms, 'torch_mm': ms}."""
    device = card(device)
    gen = torch.Generator(device=device).manual_seed(0)
    xs = torch.randint(-127, 128, (STEPS, B, H + 2, WP8, C), generator=gen, device=device,
                       dtype=torch.int8)
    wmat = torch.randint(-20, 21, (9 * C, N), generator=gen, device=device, dtype=torch.int8)
    m = torch.full((1, N), 0.001, dtype=torch.float32, device=device)
    w_wgmma = pack_wmat_wgmma(wmat)
    out = {}
    for mode in MODES:
        out[mode] = step_ms(lambda x: conv_like_kernel(x, w_wgmma, m, mode, W), xs)
        print(f"kernel {mode:8s}: {out[mode]:7.3f} ms/step  {FL / out[mode] / 1e9:6.1f} TOPS",
              flush=True)
    del xs
    x2 = torch.randint(-127, 128, (STEPS, M2, 9 * C), generator=gen, device=device,
                       dtype=torch.int8)
    wmat_t = wmat.t().contiguous()
    out["torch_mm"] = step_ms(lambda x: torch_mm(x, wmat_t, m), x2)
    fl2 = 2 * M2 * 9 * C * N
    print(f"torch s8 gemm [{M2}x{9 * C}x{N}]: {out['torch_mm']:7.3f} ms/step  "
          f"{fl2 / out['torch_mm'] / 1e9:6.1f} TOPS", flush=True)
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
