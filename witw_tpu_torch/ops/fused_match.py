"""Fused circular correlation + orientation-aligned chord distance.

Replaces ``witw_tpu/ops/pallas/fused_match.py:fused_corr_distance``, the
Pallas TPU kernel, with a CUDA C++ kernel for Hopper (``csrc/fused_match.cu``,
built by ``witw_tpu_torch.kernels.build``). For every gallery map g and
query q it computes

    corr[q, i] = sum_k <o_g[(i+k) mod W], s_q[k]>
    orient     = argmax_i corr           (first index on ties)
    d[g, q]    = 2 (1 - max corr * rsqrt(max(wsq[orient], 1e-20)) / max(||s_q||, 1e-10))

and writes only d and orient; the [G, Q, W] correlation never reaches device
memory. It is bound by f32 FMA throughput: W * sw * hc = 262k multiply-adds
per (g, q) pair at CVUSA shapes (W = sw = 64, hc = h*c = 4*16), on the CUDA
cores, without TF32 or tensor cores.

``fused_chord_distance_nhwc`` is the public entry point. On CPU tensors it
computes the plain PyTorch version (``fused_chord_distance_plain``); on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.match.correlation import circular_correlation
from witw_tpu_torch.match.distance import chord_distance, window_sq_norms
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch

# Kernel launches since the last reset (the card path's proof of use).
launches = 0

# Queries per block, as kQTile in csrc/fused_match.cu.
Q_TILE = 64
# Shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232448


def smem_bytes(w: int, hc: int) -> int:
    """Shared memory of one block: the gallery map and one query column
    tile, rows padded to hc+1 floats, plus the query norms. The kernel takes
    this size as an argument and lays its buffers out the same way."""
    return 4 * ((w + Q_TILE) * (hc + 1) + Q_TILE)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("fused_match")
    ptr = ctypes.c_void_p
    lib.witw_fused_corr_distance.argtypes = [
        ptr, ptr, ptr, ptr, ptr,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_size_t, ptr,
    ]
    lib.witw_fused_corr_distance.restype = ctypes.c_int
    return lib


def fused_corr_distance(
    o_flat: torch.Tensor, s_swqh: torch.Tensor, wsq: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.

    o_flat: [G, W, hc] f32; s_swqh: [sw, Q, hc] f32 (queries laid out by
    width column); wsq: [G, W] window squared norms
    (:func:`witw_tpu_torch.match.distance.window_sq_norms`). All contiguous
    and on one CUDA device. Returns (d [G, Q] f32, orient [G, Q] int32).
    Raises ValueError for any input the kernel does not take.
    """
    global launches
    tensors = {"o_flat": o_flat, "s_swqh": s_swqh, "wsq": wsq}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if o_flat.ndim != 3 or s_swqh.ndim != 3 or wsq.ndim != 2:
        raise ValueError(
            f"expected o_flat [G, W, hc], s_swqh [sw, Q, hc], wsq [G, W]; got "
            f"{tuple(o_flat.shape)}, {tuple(s_swqh.shape)}, {tuple(wsq.shape)}"
        )
    g, w, hc = o_flat.shape
    sw, q, s_hc = s_swqh.shape
    if s_hc != hc or tuple(wsq.shape) != (g, w):
        raise ValueError(
            f"shape mismatch: o_flat {tuple(o_flat.shape)}, s_swqh "
            f"{tuple(s_swqh.shape)}, wsq {tuple(wsq.shape)}"
        )
    if not 1 <= sw <= w:
        raise ValueError(f"query width {sw} must be in [1, gallery width {w}]")
    smem = smem_bytes(w, hc)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"W={w}, hc={hc} needs {smem} bytes of shared memory "
            f"per block, over the {SMEM_LIMIT_BYTES}-byte limit"
        )
    device = check_cuda_tensors("fused_corr_distance", align=4, **tensors)

    d = torch.empty((g, q), dtype=torch.float32, device=device)
    orient = torch.empty((g, q), dtype=torch.int32, device=device)
    if g == 0 or q == 0:
        return d, orient
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.witw_fused_corr_distance(
            o_flat.data_ptr(), s_swqh.data_ptr(), wsq.data_ptr(),
            d.data_ptr(), orient.data_ptr(),
            g, w, hc, q, sw, smem,
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(lib, err, "fused_corr_distance")
    launches += 1
    return d, orient


def fused_chord_distance_plain(
    overhead_embed: torch.Tensor, surface_embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``circular_correlation`` (matmul
    form) + ``chord_distance``. [G, h, W, c] x [Q, h, sw, c] ->
    (d [G, Q], orient [G, Q] int32)."""
    corr = circular_correlation(overhead_embed, surface_embed)
    return chord_distance(overhead_embed, surface_embed, corr)


def fused_chord_distance_nhwc(
    overhead_embed: torch.Tensor, surface_embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[G, h, W, c] x [Q, h, sw, c] -> (d [G, Q] f32, orient [G, Q] int32).

    CPU tensors take the plain version; anything else goes to the CUDA
    kernel, which launches or raises. Folds h into the channels.
    """
    if overhead_embed.device.type == "cpu" and surface_embed.device.type == "cpu":
        return fused_chord_distance_plain(overhead_embed, surface_embed)
    g, h, w, c = overhead_embed.shape
    q, sh, sw, sc = surface_embed.shape
    if (sh, sc) != (h, c):
        raise ValueError(
            f"surface {tuple(surface_embed.shape)} does not match overhead "
            f"{tuple(overhead_embed.shape)} in height and channels"
        )
    o = overhead_embed.to(torch.float32)
    o_flat = o.permute(0, 2, 1, 3).reshape(g, w, h * c).contiguous()
    s_swqh = surface_embed.to(torch.float32).permute(2, 0, 1, 3).reshape(sw, q, h * c)
    wsq = window_sq_norms(o, sw).contiguous()
    return fused_corr_distance(o_flat, s_swqh.contiguous(), wsq)
