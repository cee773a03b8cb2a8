"""FFT correlation + chord distance for gallery-scale matching (port of
witw_tpu/match/fft_matcher.py).

Circular width-correlation of overhead maps against query maps through the
rFFT, a stacked-real frequency product, and the inverse DFT as one matmul;
then argmax orientation and the crop-free chord distance. Callers differ only
in which batch axes the frequency product pairs.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def query_fft(s: torch.Tensor, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query maps [Q, h, sw, c] -> (rFFT of the zero-padded maps
    [Q, h, wf, c], L2 norms [Q]) for gallery width ``w``."""
    s = s.to(torch.float32)
    sw = s.shape[2]
    if sw > w:
        raise ValueError(f"query width {sw} exceeds gallery width {w}")
    s_pad = F.pad(s, (0, 0, 0, w - sw)) if sw < w else s
    fs = torch.fft.rfft(s_pad, dim=2)
    s_norm = torch.sqrt((s * s).sum(dim=(1, 2, 3)))
    return fs, s_norm


def chord_scores(
    corr: torch.Tensor, wsq: torch.Tensor, s_norm: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distances + orientations from correlation values.

    corr: [..., w]; wsq: window squared norms, broadcastable to corr;
    s_norm: query norms, broadcastable to corr[..., 0]. Orientation is the
    argmax of the unnormalized correlation (reference cvig_fov.py:312-313).
    Returns (d, orient int32)."""
    corr_max = torch.amax(corr, dim=-1)
    orient = torch.argmax(corr, dim=-1)
    wsq_at = torch.gather(wsq.expand(corr.shape), -1, orient[..., None])[..., 0]
    cos = corr_max * torch.rsqrt(wsq_at.clamp_min(1e-20)) / s_norm.clamp_min(1e-10)
    return 2.0 * (1.0 - cos), orient.to(torch.int32)


def _bf16_rounded(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _freq_product(fo: torch.Tensor, fs: torch.Tensor, sub: str, fast: bool = False):
    """``einsum(sub, fo, conj(fs))`` contracted over (h, c), as a (re, im)
    tuple of stacked-real products: Re = [Re fo; Im fo].[Re fs; Im fs],
    Im = [Im fo; -Re fo].[Re fs; Im fs].

    ``fast`` (an opt-in approximation): the operands rounded to bf16 and
    contracted in f32, as witw_tpu's bf16 einsum with an f32 result
    (``preferred_element_type``); a bf16 einsum in torch would also round
    its output to bf16. A product of two bf16 values is exact in f32 (and in
    TF32), so only the summation order differs from witw_tpu's."""
    fs_cat = torch.cat([fs.real, fs.imag], dim=-1)
    fo_re_cat = torch.cat([fo.real, fo.imag], dim=-1)
    fo_im_cat = torch.cat([fo.imag, -fo.real], dim=-1)
    if fast:
        fs_cat, fo_re_cat, fo_im_cat = (_bf16_rounded(t) for t in (fs_cat, fo_re_cat, fo_im_cat))
    return torch.einsum(sub, fo_re_cat, fs_cat), torch.einsum(sub, fo_im_cat, fs_cat)


@functools.lru_cache(maxsize=8)
def _irdft_mats(w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse-rDFT matrices (f64-built, f32-cast): for Hermitian rFFT
    coefficients P[..., wf], irfft(P, n=w) == Re(P) @ C + Im(P) @ S with
    C[f, n] = m_f cos(2pi f n / w) / w, S[f, n] = -m_f sin(2pi f n / w) / w,
    m_0 = m_{w/2} = 1 and m_f = 2 otherwise. Numpy copy of
    witw_tpu.match.fft_matcher._irdft_mats (tests pin the two equal)."""
    f = np.arange(w // 2 + 1, dtype=np.float64)
    n = np.arange(w, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(f, n) / w
    scale = np.full(w // 2 + 1, 2.0)
    scale[0] = 1.0
    if w % 2 == 0:
        scale[-1] = 1.0
    c = np.cos(ang) * scale[:, None] / w
    s = -np.sin(ang) * scale[:, None] / w
    return c.astype(np.float32), s.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _irdft_stack(w: int, device: torch.device) -> torch.Tensor:
    c, s = _irdft_mats(w)
    return torch.from_numpy(np.concatenate([c, s], axis=0)).to(device)  # [2*wf, w]


def _irfft_small(prod, w: int) -> torch.Tensor:
    """Inverse rFFT along the last axis of a (re, im) frequency product as
    one real matmul against the [C; S]-stacked inverse-DFT matrices."""
    re, im = prod
    stack = torch.cat([re, im], dim=-1)  # [..., 2*wf]
    return stack @ _irdft_stack(w, stack.device)


def gallery_vs_queries(
    fo: torch.Tensor, wsq: torch.Tensor, fs: torch.Tensor, s_norm: torch.Tensor, w: int,
    fast: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All pairs: gallery FFTs [G, h, wf, c] x query FFTs [Q, h, wf, c] ->
    (distances [G, Q], orientations [G, Q]). wsq: [G, w], s_norm: [Q].
    ``fast``: bf16 frequency product (see _freq_product)."""
    corr = _irfft_small(_freq_product(fo, fs, "ghfc,qhfc->gqf", fast), w)  # [G, Q, w]
    return chord_scores(corr, wsq[:, None, :], s_norm[None, :])


def candidates_vs_queries(
    fo: torch.Tensor, wsq: torch.Tensor, fs: torch.Tensor, s_norm: torch.Tensor, w: int,
    fast: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query q against its own M candidates. fo: [Q, M, h, wf, c],
    wsq: [Q, M, w], fs: [Q, h, wf, c], s_norm: [Q] -> (distances [Q, M],
    orientations [Q, M]). ``fast``: bf16 frequency product."""
    corr = _irfft_small(_freq_product(fo, fs, "qmhfc,qhfc->qmf", fast), w)  # [Q, M, w]
    return chord_scores(corr, wsq, s_norm[:, None])
