"""The s8 and bf16 matmul rate that a hand-written ``wgmma`` loop reaches
on the card: the port of ``exp/int8_mm_probe.py``.

    python3 -m witw_tpu_torch.exp.int8_mm_probe

Replaces the Pallas TPU kernels ``exp/int8_mm_probe.py:mm`` (s8 x s8 ->
int32) and ``:mmf`` (bf16 x bf16 -> f32), and ``exp/mosaic_caps.py:t3`` (an
s8 dot with N = 64, which is ``mm`` with reps = 1), with one CUDA C++ kernel
for Hopper (``csrc/mm_probe.cu``, built by ``witw_tpu_torch.kernels.build``).
The TPU kernels keep both operands resident in VMEM and add ``reps`` dots
into one accumulator; so does this one, with a in registers, b in shared
memory and the accumulator in registers:

    mm(a, b, reps)  = reps * (a @ b)    int32, mod 2^32 (the TPU's int32 sum wraps)
    mmf(a, b, reps) = the f32 sum of reps copies of a @ b

a is [M, K], b is [K, N]; the kernel reads b as b^T [N, K] (K contiguous),
which :func:`pack_b` builds once. The kernel's blocks each take 64 rows, 2 x
``tile_n`` columns and one slice of at most 288 bytes of K (:func:`geometry`);
with more than one slice a second kernel adds the slices' partial products
in order. M and N must be multiples of 64 and K of 32 bytes. CPU tensors
take the plain version; CUDA tensors launch the kernel or raise ValueError
for an input it does not take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from witw_tpu_torch.exp import card
from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch
from witw_tpu_torch.utils.profiling import cuda_ms, graph_ms

# Kernel launches since the last reset, per kernel (the card path's proof of use).
launches = {"mm": 0, "mmf": 0}

ROWS = 64  # rows of a per block: one wgmma M
STEP_BYTES = 32  # bytes of K per wgmma (k32 of s8, k16 of bf16)
STEPS = 9  # k-steps of a K slice, held in registers (kSteps in the source)
GRID_LIMIT = (2 ** 31 - 1, 65535, 65535)

# The TPU script's shapes and rep counts (rate() differences two of them).
M, K, N, N2 = 2048, 1152, 128, 512
REPS_S8 = (256, 2048)
REPS_S8_N2 = (64, 512)
REPS_BF16 = (128, 1024)


def pack_b(b: torch.Tensor) -> torch.Tensor:
    """b [K, N] -> the kernel's b^T [N, K], K contiguous."""
    return b.t().contiguous()


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), as the TPU's int32
    accumulator wraps; torch's own int32 overflow is not defined."""
    return ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def mm_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`mm`: one exact int32 product
    (``torch._int_mm``, b column-major as cuBLAS takes it), times reps in
    int64, wrapped to int32."""
    return wrap_int32(torch._int_mm(a, pack_b(b).t()).to(torch.int64) * reps)


def mmf_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`mmf`: the f32 product of the bf16
    inputs, then reps additions in order, as the TPU kernel adds whole dots."""
    d = a.float() @ b.float()
    acc = torch.zeros_like(d)
    for _ in range(reps):
        acc += d
    return acc


def geometry(m: int, n: int, k_bytes: int, s8: bool = True) -> dict:
    """The kernel's tiling of an [m x k_bytes] x [k_bytes x n] product:
    ``tile_n`` columns per warpgroup, two warpgroups a block (the largest of
    256 (s8 only), 128, 64 and 32 whose double divides n), ``slices``, the
    fewest K slices of at most :data:`STEPS` k-steps, and the launch
    ``grid`` (row tiles, column tiles, slices). ValueError for a shape the
    kernel does not take."""
    if m <= 0 or n <= 0 or k_bytes <= 0 or m % ROWS or n % 64 or k_bytes % STEP_BYTES:
        raise ValueError(f"M and N must be positive multiples of 64 and K of {STEP_BYTES} bytes, "
                         f"got M={m} N={n} and {k_bytes} bytes of K")
    steps = k_bytes // STEP_BYTES
    tile_n = next(t for t in ((256, 128, 64, 32) if s8 else (128, 64, 32)) if n % (2 * t) == 0)
    slices = -(-steps // STEPS)
    grid = (m // ROWS, n // (2 * tile_n), slices)
    if any(g > limit for g, limit in zip(grid, GRID_LIMIT)):
        raise ValueError(f"M={m} N={n} and {k_bytes} bytes of K exceed the launch grid")
    return {"tile_n": tile_n, "slices": slices, "grid": grid}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("mm_probe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.witw_mm_s8.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.witw_mm_bf16.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    for entry in (lib.witw_mm_s8, lib.witw_mm_bf16):
        entry.restype = i32
    return lib


def mm_kernel(a: torch.Tensor, bt: torch.Tensor, reps: int,
              whole_dots: bool = True) -> torch.Tensor:
    """Launch the kernel: a [M, K] and bt [N, K] (:func:`pack_b`), both int8
    (-> int32 [M, N]) or both bfloat16 (-> float32). ValueError for an input
    the kernel does not take. bf16 only: ``whole_dots`` adds each rep's dot
    to the accumulator with one round to nearest, as the TPU adds whole
    dots; False accumulates straight in the tensor core's f32 sum, which
    truncates."""
    kinds = {torch.int8: ("mm", "witw_mm_s8", torch.int32),
             torch.bfloat16: ("mmf", "witw_mm_bf16", torch.float32)}
    if a.dtype != bt.dtype or a.dtype not in kinds:
        raise ValueError(f"a and bt must be both int8 or both bfloat16, got {a.dtype} and {bt.dtype}")
    name, entry, out_dtype = kinds[a.dtype]
    if a.ndim != 2 or bt.ndim != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(f"expected a [M, K] and bt [N, K], got {tuple(a.shape)} and {tuple(bt.shape)}")
    m, k = a.shape
    n = bt.shape[0]
    plan = geometry(m, n, k * a.element_size(), name == "mm")
    if not isinstance(reps, int) or reps < 1:
        raise ValueError(f"reps must be a positive int, got {reps!r}")
    device = check_cuda_tensors(entry, a=a, bt=bt)
    lib = _lib()
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    # the slices' partial products, summed in slice order by a second kernel
    work = (torch.empty((plan["slices"], m, n), dtype=out_dtype, device=device)
            if plan["slices"] > 1 else out)
    with torch.cuda.device(device):
        extra = (int(whole_dots),) if name == "mmf" else ()
        err = getattr(lib, entry)(a.data_ptr(), bt.data_ptr(), out.data_ptr(), work.data_ptr(),
                                  m, n, k, reps, *extra, plan["tile_n"], plan["slices"],
                                  torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, entry)
    launches[name] += 1
    return out


def mm(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """int8 a [M, K] @ b [K, N], reps times -> int32 [M, N] mod 2^32."""
    if a.device.type == "cpu":
        return mm_plain(a, b, reps)
    return mm_kernel(a, pack_b(b), reps)


def mmf(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """bfloat16 a [M, K] @ b [K, N], reps times -> float32 [M, N]."""
    if a.device.type == "cpu":
        return mmf_plain(a, b, reps)
    return mm_kernel(a, pack_b(b), reps)


def rate(a: torch.Tensor, bt: torch.Tensor, r_lo: int, r_hi: int,
         whole_dots: bool = True) -> float:
    """Tera-operations per second from the difference of two rep counts
    (as the TPU script, where it cancelled the dispatch and fetch)."""
    t_lo = cuda_ms(lambda: mm_kernel(a, bt, r_lo, whole_dots), 1, 5)
    t_hi = cuda_ms(lambda: mm_kernel(a, bt, r_hi, whole_dots), 1, 5)
    ops = 2.0 * a.shape[0] * a.shape[1] * bt.shape[0] * (r_hi - r_lo)
    return ops / max(t_hi - t_lo, 1e-9) / 1e9


def library_ms(a: torch.Tensor, bt: torch.Tensor) -> float:
    """Device ms of one cuBLAS product a @ bt^T (``torch._int_mm`` for int8,
    bf16 ``torch.matmul`` with f32 accumulation and a bf16 result otherwise),
    from a CUDA graph: one such product takes less device time than the host
    takes to launch it."""
    lib_mm = torch._int_mm if a.dtype == torch.int8 else torch.matmul
    return graph_ms(lambda: lib_mm(a, bt.t()))


def run(device: Optional[torch.device] = None) -> Dict[str, float]:
    """The TPU script's three rates on the card, each beside cuBLAS's, and
    the bf16 rate without the whole-dot pass: {'s8 [MxKxN]': TOP/s, ...,
    'library s8 [MxKxN]': TOP/s, ..., 'bf16 [MxKxN] tensor-core
    accumulation': TFLOP/s}."""
    device = card(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def s8(rows, cols):
        return torch.randint(-127, 128, (rows, cols), generator=gen, device=device,
                             dtype=torch.int8)

    a = s8(M, K)
    bt, bt2 = pack_b(s8(K, N)), pack_b(s8(K, N2))
    cases = [("s8", a, bt, REPS_S8, "TOPS"), ("s8", a, bt2, REPS_S8_N2, "TOPS"),
             ("bf16", a.to(torch.bfloat16), bt.to(torch.bfloat16), REPS_BF16, "TFLOPS")]
    out = {}
    for kind, x, y, (r_lo, r_hi), unit in cases:
        key = f"{kind} [{x.shape[0]}x{x.shape[1]}x{y.shape[0]}]"
        out[key] = rate(x, y, r_lo, r_hi)
        out[f"library {key}"] = 2.0 * x.shape[0] * x.shape[1] * y.shape[0] / library_ms(x, y) / 1e9
        print(f"{kind} mm [{x.shape[0]}x{x.shape[1]}x{y.shape[0]}]: {out[key]:.1f} {unit}  "
              f"(library {out[f'library {key}']:.1f} {unit})", flush=True)
    # The bf16 kernel without its whole-dot pass: the rate, and how far the
    # tensor core's truncating f32 sum lands from whole dots added in order.
    _, x, y, reps_bf16, unit = cases[2]
    key = f"bf16 [{M}x{K}x{N}] tensor-core accumulation"
    out[key] = rate(x, y, *reps_bf16, whole_dots=False)
    reps = reps_bf16[1]
    want = mmf_plain(x, y.t(), reps)
    err = [float((mm_kernel(x, y, reps, wd) - want).abs().max()) for wd in (True, False)]
    print(f"bf16 mm [{M}x{K}x{N}] accumulated in the tensor core: {out[key]:.1f} {unit}  "
          f"(max error at reps {reps}: {err[1]:.4e}; whole dots {err[0]:.4e}; tolerance "
          f"{reps * 2.0 ** -24 * float(want.abs().max()):.4e})", flush=True)
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
