"""Circular cross-correlation over the width (orientation) axis (port of
witw_tpu/match/correlation.py; reference model/cvig_fov.py:297-315):

    corr[bo, bs, i] = sum_{c,h,k} o[bo, h, (i+k) mod W, c] * s[bs, h, k, c]

Two forms, numerically equal: ``matmul`` materializes the W circular windows
of each overhead map and contracts (s_w, h, c) in one GEMM; ``fft``
multiplies width-rFFTs and inverts. Layout is NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _check_shapes(o: torch.Tensor, s: torch.Tensor) -> None:
    _, h, w, c = o.shape
    _, sh, sw, sc = s.shape
    if (sh, sc) != (h, c):
        raise ValueError(f"shape mismatch: {tuple(o.shape)} vs {tuple(s.shape)}")
    if sw > w:
        raise ValueError(f"surface width {sw} exceeds overhead width {w}")


def circular_correlation(
    overhead_embed: torch.Tensor, surface_embed: torch.Tensor, method: str = "matmul"
) -> torch.Tensor:
    """overhead_embed: [Bo, h, W, c]; surface_embed: [Bs, h, s_w, c] with
    s_w <= W. Returns corr [Bo, Bs, W] float32."""
    _check_shapes(overhead_embed, surface_embed)
    bo, h, w, c = overhead_embed.shape
    bs, _, sw, _ = surface_embed.shape
    o = overhead_embed.to(torch.float32)
    s = surface_embed.to(torch.float32)

    if method == "matmul":
        dev = o.device
        idx = (torch.arange(w, device=dev)[:, None] + torch.arange(sw, device=dev)[None, :]) % w
        windows = o.permute(0, 2, 1, 3)[:, idx]  # [Bo, W, s_w, h, c]
        s_mat = s.permute(0, 2, 1, 3).reshape(bs, sw * h * c)
        corr = windows.reshape(bo * w, sw * h * c) @ s_mat.T  # [Bo*W, Bs]
        return corr.reshape(bo, w, bs).permute(0, 2, 1)
    if method == "fft":
        if sw < w:
            s = F.pad(s, (0, 0, 0, w - sw))
        fo = torch.fft.rfft(o, dim=2)
        fs = torch.fft.rfft(s, dim=2)
        prod = torch.einsum("ahfc,bhfc->abf", fo, fs.conj_physical())
        return torch.fft.irfft(prod, n=w, dim=-1)
    raise ValueError(f"unknown correlation method: {method}")


def orientation_estimate(corr: torch.Tensor) -> torch.Tensor:
    """Argmax over width, the first maximum on ties: the estimated relative
    orientation of each pair (reference cvig_fov.py:312-313). corr
    [Bo, Bs, W] -> int32 [Bo, Bs]."""
    return torch.argmax(corr, dim=-1).to(torch.int32)
