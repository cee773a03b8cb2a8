"""The layout probes of the fused int8 block kernels: the port of
``exp/mosaic_caps.py``, named after the TPU compiler (Mosaic) whose
capabilities that script probed. On this card it probes the same four
functions, each a kernel that must build, launch and agree with numpy:

    python3 -m witw_tpu_torch.exp.mosaic_caps

- T1 ``t1``: int32 sum of a row's two 64-lane halves,     int8 [R, 128] -> int32 [R, 64];
- T2 ``t2``: the two halves swapped,                       int8 [R, 128] -> int8 [R, 128];
- T3 ``t3``: an s8 dot with N = 64,                        int8 [R, 128] x [128, 64] -> int32;
- T4 ``t4``: the parity patch build, concat of the halves of [R, W, 128] reshaped to
  [R*W, 64] each, which is row for row x.reshape(R*W, 128): a copy.

``t1``, ``t2`` and ``t4`` run on ``csrc/caps.cu`` (replacing the Pallas TPU
kernels ``exp/mosaic_caps.py:t1``, ``t2``, ``t4``), whose bytes move by the
Tensor Memory Accelerator: TMA tensor-map loads of each half's box into
shared memory and TMA stores back, one box of rows a block (:func:`geometry`
gives the boxes and the grid); the kernels launch with programmatic
dependent launch unless ``pdl=False``. The TPU question "does the compiler
lower 64-lane slices and concats" becomes "does the TMA move boxes of half a
row at a column offset of half a row, and 3D boxes stored as 2D" (t4). ``t3``
is ``int8_mm_probe.mm(x, w, 1)`` on ``csrc/mm_probe.cu``. CPU tensors take
the plain version; CUDA tensors launch the kernel or raise ValueError for an
input it does not take: int8 rows of a multiple of 32 bytes, contiguous and
16-byte aligned, no dimension of a tensor map past 2^32 elements.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from witw_tpu_torch.exp import card, int8_mm_probe
from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch

# Kernel launches since the last reset, per kernel (the card path's proof of
# use; t3's are int8_mm_probe.launches["mm"]).
launches = {"t1": 0, "t2": 0, "t4": 0}


def t1_plain(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return x[:, :h].to(torch.int32) + x[:, h:].to(torch.int32)


def t2_plain(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([x[:, h:], x[:, :h]], dim=1)


def t4_plain(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([x[..., :h].reshape(-1, h), x[..., h:].reshape(-1, h)], dim=1)


MAX_BOX = 256  # elements in one dimension of a TMA box
MAX_DIM = 2 ** 32  # elements in one dimension of a tensor map
HALF_BOX_BYTES = {"t1": 4096, "t2": 8192, "t4": 8192}  # one half's box at most
SPREAD = 8  # units a small input is cut into at least, where its rows allow
ENTRIES = {"t1": "witw_caps_half_sum", "t2": "witw_caps_swap_halves", "t4": "witw_caps_patches"}


def geometry(name: str, shape) -> dict:
    """``caps.cu``'s tiling of probe ``name`` ("t1", "t2" or "t4") on an
    int8 input of ``shape`` ([R, C]; t4 [R, W, C]). A unit is a box of
    ``box_rows`` rows (t4: rows of ``width`` pixels) by ``chunk`` columns of
    each half, and one block takes one unit (``units`` is the grid).
    ``chunk`` is the widest multiple of 16 that divides C / 2 and fits a box
    dimension (256). t4 folds W into rows where W is past 256 or its boxes
    would pass :data:`HALF_BOX_BYTES`: ``width`` is W's widest divisor that
    fits, ``rows`` R * W / width. ``box_rows`` is the most rows whose
    half-box holds :data:`HALF_BOX_BYTES` (t4: at most 256 / width), and at
    most 1 / :data:`SPREAD` of the rows, so that a small input still spreads
    over several SMs. ValueError for a shape the kernel does not take."""
    if name not in ENTRIES:
        raise ValueError(f"no caps kernel {name!r}")
    dims = 3 if name == "t4" else 2
    if len(shape) != dims:
        raise ValueError(f"{name} takes int8 [{'R, W, C' if dims == 3 else 'R, C'}], got {tuple(shape)}")
    rows, width, cols = (shape[0], 1, shape[1]) if dims == 2 else tuple(shape)
    if cols <= 0 or cols % 32:
        raise ValueError(f"{name} takes int8 rows of a multiple of 32 bytes, got {tuple(shape)}")
    if rows <= 0 or width <= 0:
        raise ValueError(f"{name}: nothing to move in {tuple(shape)}")
    h = cols // 2
    chunk = max(c for c in range(16, min(h, MAX_BOX) + 1, 16) if h % c == 0)
    fold = max(d for d in range(1, min(width, MAX_BOX) + 1)
               if width % d == 0 and d * chunk <= HALF_BOX_BYTES[name])
    rows, width = rows * (width // fold), fold
    box_rows = max(1, min(MAX_BOX // width, HALF_BOX_BYTES[name] // (width * chunk), -(-rows // SPREAD)))
    units = -(-rows // box_rows) * (h // chunk)
    if max(cols, rows * width) >= MAX_DIM or units >= 2 ** 31:
        raise ValueError(f"{name}: {tuple(shape)} has a dimension past a tensor map's 2^32")
    return {"rows": rows, "width": width, "chunk": chunk, "chunks": h // chunk,
            "box_rows": box_rows, "units": units}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("caps")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry in (lib.witw_caps_half_sum, lib.witw_caps_swap_halves):
        entry.argtypes = [ptr, ptr, i64] + [i32] * 4 + [ptr]
        entry.restype = i32
    lib.witw_caps_patches.argtypes = [ptr, ptr, i64] + [i32] * 5 + [ptr]
    lib.witw_caps_patches.restype = i32
    return lib


@functools.lru_cache(maxsize=256)
def _entry_args(name: str, shape) -> tuple:
    """The library entry's size and tiling arguments for this input shape
    (cached: the wrapper's host time is most of a call at the probes' sizes)."""
    plan = geometry(name, shape)
    return ((plan["rows"],) + ((plan["width"],) if name == "t4" else ())
            + (shape[-1], plan["chunk"], plan["box_rows"]))


def _launch(name: str, x: torch.Tensor, out_shape, out_dtype, pdl: bool) -> torch.Tensor:
    if x.dtype != torch.int8:
        raise ValueError(f"{name} takes int8, got {x.dtype}")
    device = check_cuda_tensors(name, x=x)
    out = torch.empty(out_shape, dtype=out_dtype, device=device)
    if x.numel() == 0 and x.shape[-1] > 0 and x.shape[-1] % 32 == 0:  # nothing to move: no launch
        return out
    args = _entry_args(name, tuple(x.shape))
    lib = _lib()
    with torch.cuda.device(device):
        err = getattr(lib, ENTRIES[name])(x.data_ptr(), out.data_ptr(), *args, int(pdl),
                                          torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, name)
    launches[name] += 1
    return out


def t1(x: torch.Tensor, pdl: bool = True) -> torch.Tensor:
    """int8 [R, C] -> int32 [R, C/2] = x[:, :C/2] + x[:, C/2:]."""
    if x.device.type == "cpu":
        return t1_plain(x)
    if x.ndim != 2:
        raise ValueError(f"t1 takes int8 [R, C], got {tuple(x.shape)}")
    r, c = x.shape
    return _launch("t1", x, (r, c // 2), torch.int32, pdl)


def t2(x: torch.Tensor, pdl: bool = True) -> torch.Tensor:
    """int8 [R, C] -> int8 [R, C], the two halves of each row swapped."""
    if x.device.type == "cpu":
        return t2_plain(x)
    if x.ndim != 2:
        raise ValueError(f"t2 takes int8 [R, C], got {tuple(x.shape)}")
    return _launch("t2", x, tuple(x.shape), torch.int8, pdl)


def t3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [R, K] @ int8 [K, N] -> int32 [R, N]."""
    return int8_mm_probe.mm(x, w, 1)


def t4(x: torch.Tensor, pdl: bool = True) -> torch.Tensor:
    """int8 [R, W, C] -> int8 [R*W, C]: the halves of every pixel's channels,
    each gathered to [R*W, C/2], concatenated again."""
    if x.device.type == "cpu":
        return t4_plain(x)
    if x.ndim != 3:
        raise ValueError(f"t4 takes int8 [R, W, C], got {tuple(x.shape)}")
    r, w, c = x.shape
    return _launch("t4", x, (r * w, c), torch.int8, pdl)


def probe(name: str, fn, *args, want: np.ndarray) -> bool:
    """The TPU script's report line: ``COMPILES, correct=...`` when the kernel
    built and launched ("compiles" on this card), else ``FAIL ...`` and the
    exception propagates."""
    try:
        got = fn(*args).cpu().numpy()
    except Exception as e:
        print(f"{name}: FAIL {type(e).__name__}: {str(e)[:160]}", flush=True)
        raise
    ok = bool(np.array_equal(got, want))
    print(f"{name}: COMPILES, correct={ok}", flush=True)
    return ok


def run(device: Optional[torch.device] = None) -> Dict[str, bool]:
    """The four probes of the TPU script on its inputs (numpy, seed 0):
    {probe name: output equal to numpy's}."""
    device = card(device)
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (256, 128), dtype=np.int64).astype(np.int8)
    xt = torch.from_numpy(x).to(device)
    w = rng.integers(-20, 21, (128, 64), dtype=np.int64).astype(np.int8)
    slab = rng.integers(-127, 128, (8, 64, 128), dtype=np.int64).astype(np.int8)
    cases = [
        ("T1 lane-half slice s8", t1, (xt,), x[:, :64].astype(np.int32) + x[:, 64:].astype(np.int32)),
        ("T2 lane concat of halves", t2, (xt,), np.concatenate([x[:, 64:], x[:, :64]], axis=1)),
        ("T3 s8 dot N=64", t3, (xt, torch.from_numpy(w).to(device)),
         x.astype(np.int32) @ w.astype(np.int32)),
        ("T4 parity patch build", t4, (torch.from_numpy(slab).to(device),),
         np.concatenate([slab[:, :, :64].reshape(512, 64), slab[:, :, 64:].reshape(512, 64)],
                        axis=1)),
    ]
    return {name: probe(name, fn, *args, want=want) for name, fn, args, want in cases}


def main() -> None:
    if not all(run().values()):
        raise SystemExit("a probe disagrees with numpy")


if __name__ == "__main__":
    main()
