"""Kernel A of the static-int8 towers, decomposed into its stages: the port
of ``exp/int8_isolate.py``.

    python3 -m witw_tpu_torch.exp.int8_isolate

The TPU script ran its int8 conv kernel with stages removed, to see where
its time went. Those stages (DMA, patch build, one big dot) do not exist on
Hopper, so the port decomposes the design of its first kernel A, a ``__dp4a``
loop on the CUDA cores over 8 x 16-pixel x 64-channel tiles (since replaced
in ``csrc/int8_conv.cu`` by s8 ``wgmma``), the same way, in
``csrc/conv_like.cu`` (replacing the Pallas TPU kernel
``exp/int8_isolate.py:conv_like``). For xp int8 [B, H + 2, WP8, C] (the
input pre-padded; columns >= W + 2 unused), wmat int8 [9C, N] (row
(3 dy + dx) C + c) and m f32 [1, N]:

  full     — y[b, h, w, n] = clip(round(float(sum_{dy, dx, c} xp[b, h + dy, w + dx, c]
             * wmat[(3 dy + dx) C + c, n]) * m[n]), 0, 127): the whole kernel;
  nodma    — the input halo is never read from device memory (zero slab):
             full - nodma is the cost of the input's copies;
  nopatch  — the halo is copied in, but the dp4a loop reads its x operands
             once per chunk from a zero buffer, not per tap: full - nopatch
             is the cost of the shifted shared-memory reads;
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

# Output tile of one block, as kTileRows and kTileCo (int8_common.cuh) in
# conv_like.cu, and the limit of the launch grid's y and z.
TILE_ROWS, TILE_CO = 8, 64
GRID_LIMIT = 65535


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


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("conv_like")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.witw_conv_like.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.witw_conv_like.restype = i32
    return lib


@functools.lru_cache(maxsize=8)
def _zero_bias(n: int, device: torch.device) -> torch.Tensor:
    """Kernel A's epilogue adds bias_q; conv_like has none."""
    return torch.zeros(n, dtype=torch.int32, device=device)


def conv_like_kernel(xp: torch.Tensor, w_packed: torch.Tensor, m: torch.Tensor, mode: str,
                     width: int) -> torch.Tensor:
    """Launch the kernel: xp int8 [B, H + 2, WP, C], w_packed int8 [N, 3, 3, C]
    (:func:`pack_wmat`), m f32 [1, N] -> int8 [B, H, width, N]. ValueError
    for an input the kernel does not take."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if xp.dtype != torch.int8 or w_packed.dtype != torch.int8 or m.dtype != torch.float32:
        raise ValueError(f"xp and w must be int8 and m float32, got {xp.dtype}, "
                         f"{w_packed.dtype} and {m.dtype}")
    if xp.ndim != 4 or w_packed.ndim != 4 or tuple(w_packed.shape[1:3]) != (3, 3):
        raise ValueError(f"expected xp [B, H + 2, WP, C] and w [N, 3, 3, C], got "
                         f"{tuple(xp.shape)} and {tuple(w_packed.shape)}")
    b, hp, wp, c = xp.shape
    n = w_packed.shape[0]
    if w_packed.shape[3] != c or c % 4 or n % 4 or m.numel() != n:
        raise ValueError(f"w {tuple(w_packed.shape)} and m {tuple(m.shape)} do not fit xp "
                         f"{tuple(xp.shape)}: C and N must agree and be multiples of 4")
    if hp < 3 or not 1 <= width <= wp - 2:
        raise ValueError(f"xp {tuple(xp.shape)} does not hold a padded [H, {width}] input")
    if -(-(hp - 2) // TILE_ROWS) > GRID_LIMIT or b * -(-n // TILE_CO) > GRID_LIMIT:
        raise ValueError(f"xp {tuple(xp.shape)} with N={n} exceeds the launch grid")
    device = check_cuda_tensors("conv_like", xp=xp, w=w_packed, m=m)
    out = torch.empty((b, hp - 2, width, n), dtype=torch.int8, device=device)
    if b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.witw_conv_like(xp.data_ptr(), w_packed.data_ptr(), _zero_bias(n, device).data_ptr(),
                                 m.data_ptr(), out.data_ptr(), b, hp - 2, wp, c, n, width,
                                 MODES.index(mode), torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, "conv_like")
    launches[mode] += 1
    return out


def conv_like(xp: torch.Tensor, wmat: torch.Tensor, m: torch.Tensor, mode: str,
              width: int) -> torch.Tensor:
    """int8 xp [B, H + 2, WP, C] (pre-padded), wmat [9C, N], m f32 [1, N] ->
    int8 [B, H, width, N] (``mode`` full, nopatch or nodma)."""
    if xp.device.type == "cpu":
        return conv_like_plain(xp, wmat, m, mode, width)
    if wmat.ndim != 2 or wmat.shape[0] != 9 * xp.shape[-1]:
        raise ValueError(f"wmat {tuple(wmat.shape)} does not fit xp {tuple(xp.shape)}: "
                         f"expected [9C, N]")
    return conv_like_kernel(xp, pack_wmat(wmat), m, mode, width)


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
    w_packed = pack_wmat(wmat)
    out = {}
    for mode in MODES:
        out[mode] = step_ms(lambda x: conv_like_kernel(x, w_packed, m, mode, W), xs)
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
