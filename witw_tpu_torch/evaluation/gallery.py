"""Full-gallery retrieval evaluation on one device (port of the single-device
path of witw_tpu/evaluation/gallery.py: ``FovGalleryEvaluator`` for the
FOV family's feature maps and ``euclidean_ranks`` for the SAFA family's
embedding vectors).

- One paired O(N) pass gives every query's true-match distance (the rank
  threshold), through the FFT matcher's arithmetic.
- A blockwise sweep runs each block of queries against the gallery in
  chunks, through the FFT matcher (default) or the fused CUDA kernel
  (``use_fused``), and counts the gallery items at or under the threshold.

Rank definition (ties count): rank(q) = #{g : d(g, q) <= d(q, q)}
(reference cvig_fov.py:552). The true match is excluded from the sweep and
counted as +1, so kernel-batching roundoff cannot drop it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from witw_tpu_torch.match.distance import window_sq_norms
from witw_tpu_torch.match.fft_matcher import (
    candidates_vs_queries,
    gallery_vs_queries,
    query_fft,
)
from witw_tpu_torch.ops.fused_match import fused_chord_distance_nhwc
from witw_tpu_torch.utils.device import require_cuda


def _paired_distance_batched(overhead: torch.Tensor, surface: torch.Tensor,
                             fast: bool = False) -> torch.Tensor:
    """True-match distances [N] through the same fft_matcher arithmetic as
    the FFT sweep (query_fft padding + chord_scores' rsqrt/epsilon guards);
    ``fast`` as the sweep's, so that a bf16 sweep meets a bf16 threshold."""
    w = overhead.shape[2]
    sw = surface.shape[2]
    fs, s_norm = query_fft(surface, w)
    fo = torch.fft.rfft(overhead.to(torch.float32), dim=2)[:, None]
    wsq = window_sq_norms(overhead, sw)[:, None]
    d, _ = candidates_vs_queries(fo, wsq, fs, s_norm, w, fast=fast)
    return d[:, 0]


class FovGalleryEvaluator:
    """Rank computation for the FOV-DSM orientation-aligned chord distance.

    Gallery (overhead) and query (surface) embeddings: [N, h, w(|sw), c]
    NHWC, numpy or tensors. ``use_fused`` runs the sweep through the fused
    correlation + distance kernel (witw_tpu_torch.ops.fused_match), which
    never materializes the [G, Q, W] correlation. ``fast_matmul`` (FFT
    path only; witw_tpu's ``--fast-eval``) computes the frequency products
    in bf16 with f32 sums, an opt-in approximation: near-threshold ranks can
    flip. ``device`` is where the sweep runs; None keeps tensors where they
    are and puts numpy on the CUDA device (RuntimeError without one): the
    CPU only when asked for.
    """

    def __init__(
        self,
        query_block: int = 128,
        gallery_chunk: int = 1024,
        use_fused: bool = False,
        device: Optional[torch.device] = None,
        fast_matmul: bool = False,
    ):
        if use_fused and fast_matmul:
            raise ValueError("fast_matmul applies to the FFT sweep only; the fused match kernel "
                             "has no bf16 frequency-product variant")
        self.query_block = query_block
        self.gallery_chunk = gallery_chunk
        self.use_fused = use_fused
        self.device = device
        self.fast_matmul = fast_matmul

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device or x.device, torch.float32)
        device = self.device if self.device is not None else require_cuda()
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    @torch.no_grad()
    def ranks(self, overhead_embeds, surface_embeds,
              true_match: Optional[np.ndarray] = None) -> np.ndarray:
        """Rank of each query's true match in the gallery (ties count).
        ``true_match``: gallery index of each query's true match [Q]; None =
        arange (paired test sets, Q == G). Returns int32 [Q]."""
        gal = self._tensor(overhead_embeds)
        s_all = self._tensor(surface_embeds).to(gal.device)
        n = s_all.shape[0]
        n_gal = gal.shape[0]
        if true_match is None:
            if n_gal != n:
                raise ValueError("asymmetric query/gallery requires explicit true_match indices")
            tm = torch.arange(n, device=gal.device)
            tm_rows = gal
        else:
            tm = torch.as_tensor(np.asarray(true_match), dtype=torch.int64, device=gal.device)
            tm_rows = gal[tm]
        d_true = _paired_distance_batched(tm_rows, s_all, self.fast_matmul)

        w = gal.shape[2]
        sw = s_all.shape[2]
        if not self.use_fused:
            fo = torch.fft.rfft(gal, dim=2)  # [Ng, h, wf, c]
            wsq = window_sq_norms(gal, sw)  # [Ng, w]
        gal_idx = torch.arange(n_gal, device=gal.device)
        counts = torch.zeros(n, dtype=torch.int64, device=gal.device)
        for q0 in range(0, n, self.query_block):
            q1 = min(q0 + self.query_block, n)
            s_block = s_all[q0:q1]
            if not self.use_fused:
                fs, s_norm = query_fft(s_block, w)
            for c0 in range(0, n_gal, self.gallery_chunk):
                c1 = min(c0 + self.gallery_chunk, n_gal)
                if self.use_fused:
                    d, _ = fused_chord_distance_nhwc(gal[c0:c1], s_block)
                else:
                    d, _ = gallery_vs_queries(fo[c0:c1], wsq[c0:c1], fs, s_norm, w,
                                              fast=self.fast_matmul)
                le = (d <= d_true[None, q0:q1]) & (gal_idx[c0:c1, None] != tm[None, q0:q1])
                counts[q0:q1] += le.sum(dim=0)
        return (counts + 1).cpu().numpy().astype(np.int32)


@contextlib.contextmanager
def full_precision_matmul():
    """f32 matmuls without TF32 inside the block, whatever the global flag
    says (restored on exit)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sq_distances(g: torch.Tensor, q: torch.Tensor, g_sq: torch.Tensor) -> torch.Tensor:
    """[G, Q] squared Euclidean distances, g² + q² − 2 g·qᵀ in f32 (one
    GEMM); ``g_sq``: the gallery's squared norms [G]."""
    q_sq = (q * q).sum(dim=1)
    return g_sq[:, None] + q_sq[None, :] - 2.0 * (g @ q.T)


@torch.no_grad()
def euclidean_ranks(gallery_embeds, query_embeds, block: int = 1024,
                    true_match: Optional[np.ndarray] = None, mesh=None,
                    device: Optional[torch.device] = None) -> np.ndarray:
    """Ranks under plain Euclidean distance on embedding vectors, the SAFA
    family's eval (reference cvig_baseline.py:456-460); squared distances
    rank as the reference's sqrt distances do. Rank(q) = 1 + #{g != tm(q) :
    d(g, q) <= d(tm(q), q)}, the true match's distance read off the same
    matrix, so its own tie is exact.

    Gallery [G, D] and queries [Q, D]: numpy (put on ``device``, the card
    when None) or tensors (kept where they are unless ``device`` says).
    ``true_match``: the gallery index of each query's match [Q]; None =
    arange (Q == G). The products run in f32 with TF32 off. ``mesh`` (the
    gallery sharded over devices) waits for the multi-GPU port. Returns int32
    [Q]."""
    if mesh is not None:
        raise NotImplementedError("euclidean_ranks(mesh=...) shards the gallery over devices, "
                                  "which comes with the multi-GPU port")

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x.to(device or x.device, torch.float32)
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device if device is not None else require_cuda())

    g = tensor(gallery_embeds)
    q_all = tensor(query_embeds).to(g.device)
    nq, ng = q_all.shape[0], g.shape[0]
    if true_match is None:
        if ng != nq:
            raise ValueError("asymmetric query/gallery requires explicit true_match indices")
        tm = torch.arange(nq, device=g.device)
    else:
        tm = torch.as_tensor(np.asarray(true_match), dtype=torch.int64, device=g.device)
        if tm.shape != (nq,):
            raise ValueError(f"true_match has shape {tuple(tm.shape)}, expected ({nq},)")
    idx = torch.arange(ng, device=g.device)
    g_sq = (g * g).sum(dim=1)
    counts = torch.empty(nq, dtype=torch.int64, device=g.device)
    with full_precision_matmul():
        for q0 in range(0, nq, block):
            q1 = min(q0 + block, nq)
            d2 = sq_distances(g, q_all[q0:q1], g_sq)  # [G, Qb]
            is_tm = idx[:, None] == tm[None, q0:q1]
            d_true = torch.where(is_tm, d2, torch.zeros((), device=g.device)).sum(dim=0)
            counts[q0:q1] = ((d2 <= d_true[None, :]) & ~is_tm).sum(dim=0)
    return (counts + 1).cpu().numpy().astype(np.int32)


def metrics_from_ranks(ranks: np.ndarray) -> Dict[str, float]:
    """Reference metric suite (cvig_fov.py:553-567)."""
    count = len(ranks)
    return {
        "top_1": float(np.sum(ranks <= 1) / count * 100.0),
        "top_5": float(np.sum(ranks <= 5) / count * 100.0),
        "top_10": float(np.sum(ranks <= 10) / count * 100.0),
        "top_percent": float(np.sum(ranks * 100 <= count) / count * 100.0),
        "avg_rank": float(np.mean(ranks)),
        "med_rank": float(np.median(ranks)),
        "locations": count,
    }
