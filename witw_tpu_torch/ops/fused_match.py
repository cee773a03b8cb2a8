"""Fused circular correlation + orientation-aligned chord distance.

Replaces ``witw_tpu/ops/pallas/fused_match.py:fused_corr_distance``, the
Pallas TPU kernel, with a CUDA C++ kernel for Hopper (``csrc/fused_match.cu``,
built by ``witw_tpu_torch.kernels.build``). For every gallery map g and
query q it computes

    corr[q, i] = sum_k <o_g[(i+k) mod W], s_q[k]>
    orient     = argmax_i corr           (first index on ties)
    d[g, q]    = 2 (1 - max corr * rsqrt(max(wsq[orient], 1e-20)) / max(||s_q||, 1e-10))

and writes only d and orient; the [G, Q, W] correlation never reaches device
memory. The multiply-adds bound it: W * sw * hc = 262k per (g, q) pair at
CVUSA shapes (W = sw = 64, hc = h*c = 4*16). They run on the tensor cores as
3xTF32 ``wgmma`` (each f32 split into two tf32 parts, three products), which
keeps f32 accuracy. Each block holds windows of two gallery maps in shared
memory, split: the rows that a pass of 64 shifts reads over a window of
``kcols`` query columns, kcols + 63 rows wrapping past the map's end, so
that a circular shift is an offset of the ``wgmma`` descriptor. It streams
64 queries' width columns past them, one bulk copy a column
(:func:`geometry`), and refills the windows per pass, window and channel
chunk. The channels run in chunks of at most 64: one where hc <= 64 and a
window of all sw columns fits in 227 KB of shared memory beside two ring
stages (sw <= 127 at hc = 64), more for a larger hc or sw. Past sw = 1720,
where even 8-channel chunks of all sw columns do not fit, kcols is the most
columns that do. So the kernel takes any hc and W.

``fused_chord_distance_nhwc`` is the public entry point. On CPU tensors it
computes the plain PyTorch version (``fused_chord_distance_plain``); on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.match.correlation import circular_correlation
from witw_tpu_torch.match.distance import chord_distance, window_sq_norms
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch

# Kernel launches since the last reset (the card path's proof of use).
launches = 0

# As kQTile, kMaps and kShifts in csrc/fused_match.cu: queries per block
# (the M of wgmma), gallery maps per block (one per consumer warpgroup) and
# shifts per pass (the N of wgmma).
Q_TILE = 64
MAPS = 2
SHIFTS = 64
# 8-channel steps of a chunk of the channels (h * c): the kernel's
# fragments of a query column's chunk stay in registers, at most 8 steps.
MAX_STEPS = 8
# Ring stages of query columns: as many as fit, up to MAX_STAGES; fewer
# than MIN_STAGES is not taken.
MAX_STAGES = 4
MIN_STAGES = 2
# Shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232448


def _chunking(steps: int, most: int):
    """Channel chunks of at most ``most`` 8-channel steps: (chunks, hc_pad,
    the query rows' pitch in floats, the bytes of a ring stage)."""
    chunks = -(-steps // most)
    hc_pad = 8 * -(-steps // chunks)  # the fewest steps for that many chunks
    # Query rows `pitch` floats apart put a warp's 8-byte fragment loads
    # (rows g, channels 2t) on 32 distinct banks: pitch % 32 in (8, 24).
    pitch = hc_pad if hc_pad % 32 in (8, 24) else hc_pad + 8
    return chunks, hc_pad, pitch, Q_TILE * pitch * 4 + 16  # a stage with its two barriers


def geometry(g: int, q: int, w: int, hc: int, sw: Optional[int] = None) -> dict:
    """The kernel's layout for o [g, w, hc] and s [sw, q, hc] (sw = w when
    None): the rows of a gallery map's window in shared memory, the channel
    chunks and the channels of one (hc_pad, a multiple of 8), the query rows'
    pitch in floats, the maps per block, the ring stages, the shared memory
    of a block, the grid, and kcols, the query columns of a window (see the
    module's docstring). One window of all sw columns (kcols = sw) in the
    fewest chunks that leave room for MIN_STAGES ring stages beside it; where
    even 8-channel chunks leave none, 8-step chunks and windows of the most
    columns that do."""
    sw = w if sw is None else sw
    steps = max(1, -(-hc // 8))

    def layout(most):
        chunks, hc_pad, pitch, stage = _chunking(steps, most)
        row_bytes = MAPS * 2 * hc_pad * 4  # a row of both maps, big and small copies
        fit = (SMEM_LIMIT_BYTES - MIN_STAGES * stage) // row_bytes - (SHIFTS - 1)
        return chunks, hc_pad, pitch, stage, row_bytes, fit

    layouts = [layout(most) for most in range(min(MAX_STEPS, steps), 0, -1)]
    fits = [lay for lay in layouts if lay[-1] >= sw]
    chunks, hc_pad, pitch, stage, row_bytes, fit = fits[0] if fits else layouts[0]
    kcols = min(sw, fit)
    rows = kcols + SHIFTS - 1
    maps = row_bytes * rows
    stages = min(MAX_STAGES, (SMEM_LIMIT_BYTES - maps) // stage)
    return {"rows": rows, "chunks": chunks, "hc_pad": hc_pad, "pitch": pitch, "maps": MAPS,
            "stages": stages, "smem_bytes": maps + stages * stage,
            "grid": (-(-g // MAPS), -(-q // Q_TILE)), "kcols": kcols}


def smem_bytes(w: int, hc: int, sw: Optional[int] = None) -> int:
    """Shared memory of one block (:func:`geometry`); the kernel takes it
    as an argument and checks it against the same layout."""
    return geometry(1, 1, w, hc, sw)["smem_bytes"]


def query_columns(s_swqh: torch.Tensor, geo: dict) -> torch.Tensor:
    """s [sw, Q, hc] as the kernel reads it, [sw, chunks, Q, pitch]: each
    chunk of a query row `pitch` floats apart and zero past hc, so that one
    bulk copy brings a chunk of a column of 64 queries into shared memory.
    The copies need it 16-byte aligned: s itself where it already is all
    that, else a new tensor."""
    sw, q, hc = s_swqh.shape
    chunks, hc_pad, pitch = geo["chunks"], geo["hc_pad"], geo["pitch"]
    if chunks == 1 and pitch == hc and s_swqh.is_contiguous() and s_swqh.data_ptr() % 16 == 0:
        return s_swqh.view(sw, 1, q, hc)
    s = F.pad(s_swqh, (0, chunks * hc_pad - hc)).reshape(sw, q, chunks, hc_pad)
    return F.pad(s, (0, pitch - hc_pad)).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("fused_match")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.witw_fused_corr_distance.argtypes = [ptr] * 5 + [i32] * 10 + [ctypes.c_size_t, ptr]
    lib.witw_fused_corr_distance.restype = i32
    return lib


def fused_corr_distance(
    o_flat: torch.Tensor, s_swqh: torch.Tensor, wsq: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.

    o_flat: [G, W, hc] f32; s_swqh: [sw, Q, hc] f32 (queries laid out by
    width column); wsq: [G, W] window squared norms
    (:func:`witw_tpu_torch.match.distance.window_sq_norms`). All contiguous,
    4-byte aligned and on one CUDA device. Returns (d [G, Q] f32, orient
    [G, Q] int32). Raises ValueError for any input the kernel does not take.
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
    if hc < 1 or -(-q // Q_TILE) > 65535:
        raise ValueError(f"hc {hc} must be positive and Q {q} at most {65535 * Q_TILE}")
    geo = geometry(g, q, w, hc, sw)
    # o and wsq are read by the kernel's scalar loads (o by 16-byte loads
    # only where it is so aligned); s goes to the bulk copies as s_pad below.
    device = check_cuda_tensors("fused_corr_distance", align=4, **tensors)

    d = torch.empty((g, q), dtype=torch.float32, device=device)
    orient = torch.empty((g, q), dtype=torch.int32, device=device)
    if g == 0 or q == 0:
        return d, orient
    s_pad = query_columns(s_swqh, geo)
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.witw_fused_corr_distance(
            o_flat.data_ptr(), s_pad.data_ptr(), wsq.data_ptr(),
            d.data_ptr(), orient.data_ptr(),
            g, w, hc, geo["hc_pad"], geo["chunks"], geo["pitch"], q, sw, geo["stages"], geo["kcols"],
            geo["smem_bytes"],
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
