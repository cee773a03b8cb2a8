"""Full-gallery retrieval evaluation, on one device or sharded over a device
mesh (port of witw_tpu/evaluation/gallery.py: ``FovGalleryEvaluator`` for
the FOV family's feature maps and ``euclidean_ranks`` for the SAFA and
baseline families' embedding vectors).

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
from witw_tpu_torch.parallel.collectives import all_reduce_sum
from witw_tpu_torch.parallel.mesh import Mesh, Shard, gallery_shards, placement, replicate
from witw_tpu_torch.utils.device import full_precision_matmul, require_cuda
from witw_tpu_torch.utils.profiling import span, spanned


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

    ``mesh`` (a ``parallel.Mesh``) deals the query blocks over its devices,
    block b on ``mesh.devices[b % mesh.size]``, with the gallery replicated
    to each. ``shard_gallery`` (requires ``mesh``) keeps the gallery
    resident instead, split into ``mesh.size`` shards (witw_tpu's chunk
    arithmetic: ``chunk = min(gallery_chunk, ceil(N / size))``, each shard
    a whole number of chunks): each device transforms and sweeps only its
    own shard against every query block, and the per-shard integer counts
    are summed once at the end, so the ranks equal one device's. Either way
    the per-device work is the single-device block loop (the fused kernel
    under ``use_fused``), every shard's work is issued before any count is
    gathered, and the true-match threshold comes from one paired pass on
    the first mesh device (or ``device``). ``last_gallery_placement``
    records the resident shards (``parallel.placement``). Across processes
    every process passes the whole gallery and query set, sweeps only the
    blocks or shards of its own mesh positions, and the integer counts are
    summed over the processes once: every process returns the same ranks.
    """

    def __init__(
        self,
        query_block: int = 128,
        gallery_chunk: int = 1024,
        use_fused: bool = False,
        device: Optional[torch.device] = None,
        fast_matmul: bool = False,
        mesh: Optional[Mesh] = None,
        shard_gallery: bool = False,
    ):
        if use_fused and fast_matmul:
            raise ValueError("fast_matmul applies to the FFT sweep only; the fused match kernel "
                             "has no bf16 frequency-product variant")
        if shard_gallery and mesh is None:
            raise ValueError("shard_gallery requires a mesh")
        self.query_block = query_block
        self.gallery_chunk = gallery_chunk
        self.use_fused = use_fused
        self.device = device
        self.fast_matmul = fast_matmul
        self.mesh = mesh
        self.shard_gallery = shard_gallery
        self.last_gallery_placement = None

    def _tensor(self, x) -> torch.Tensor:
        device = self.device
        if device is None and self.mesh is not None:
            device = self.mesh.home
        if isinstance(x, torch.Tensor):
            return x.to(device or x.device, torch.float32)
        device = device if device is not None else require_cuda()
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    def _tables(self, gal: torch.Tensor, sw: int):
        """What a device sweeps: the maps (fused) or their rFFT and window
        norms (FFT)."""
        if self.use_fused:
            return gal, None, None
        return gal, torch.fft.rfft(gal, dim=2), window_sq_norms(gal, sw)

    def _block_counts(self, tables, idx: torch.Tensor, mask: Optional[torch.Tensor],
                      chunk: int, s_block: torch.Tensor, d_true: torch.Tensor,
                      tm: torch.Tensor) -> torch.Tensor:
        """Gallery items other than the true match at or under each query's
        threshold: one query block against one device's gallery (``idx``:
        its global indices; ``mask``: its real rows, None = all), chunk by
        chunk. Returns int64 [Qb] on that device."""
        gal, fo, wsq = tables
        w = gal.shape[2]
        if not self.use_fused:
            fs, s_norm = query_fft(s_block, w)
        counts = torch.zeros(s_block.shape[0], dtype=torch.int64, device=gal.device)
        for c0 in range(0, gal.shape[0], chunk):
            c1 = min(c0 + chunk, gal.shape[0])
            if self.use_fused:
                d, _ = fused_chord_distance_nhwc(gal[c0:c1], s_block)
            else:
                d, _ = gallery_vs_queries(fo[c0:c1], wsq[c0:c1], fs, s_norm, w,
                                          fast=self.fast_matmul)
            le = (d <= d_true[None, :]) & (idx[c0:c1, None] != tm[None, :])
            if mask is not None:  # padded rows: finite distances, never counted
                le &= mask[c0:c1, None]
            counts += le.sum(dim=0)
        return counts

    @torch.no_grad()
    @spanned("rank", stretch=True)
    def ranks(self, overhead_embeds, surface_embeds,
              true_match: Optional[np.ndarray] = None) -> np.ndarray:
        """Rank of each query's true match in the gallery (ties count).
        ``true_match``: gallery index of each query's true match [Q]; None =
        arange (paired test sets, Q == G). Returns int32 [Q]. Spans: ``rank``
        with ``rank.true``, one ``rank.block`` a query block (on one device)
        and ``rank.fetch``."""
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
        with span("rank.true"):
            d_true = _paired_distance_batched(tm_rows, s_all, self.fast_matmul)
        sw = s_all.shape[2]
        blocks = [(q0, min(q0 + self.query_block, n)) for q0 in range(0, n, self.query_block)]

        if self.mesh is None:
            tables = self._tables(gal, sw)
            idx = torch.arange(n_gal, device=gal.device)
            parts = []
            for q0, q1 in blocks:
                with span("rank.block"):
                    parts.append(self._block_counts(tables, idx, None, self.gallery_chunk,
                                                    s_all[q0:q1], d_true[q0:q1], tm[q0:q1]))
            counts = torch.cat(parts)
        elif not self.shard_gallery:
            counts = self._query_sharded(gal, sw, blocks, s_all, d_true, tm)
        else:
            counts = self._gallery_sharded(gal, sw, blocks, s_all, d_true, tm)
        with span("rank.fetch"):
            return (counts + 1).cpu().numpy().astype(np.int32)

    def metrics(self, overhead_embeds, surface_embeds,
                true_match: Optional[np.ndarray] = None) -> Dict[str, float]:
        """The reference metric suite of :meth:`ranks`."""
        return metrics_from_ranks(self.ranks(overhead_embeds, surface_embeds, true_match))

    def _query_sharded(self, gal, sw, blocks, s_all, d_true, tm) -> torch.Tensor:
        """Query blocks dealt over the mesh positions, the gallery tables
        replicated to each of this process's devices (one copy per distinct
        device); each process's blocks' counts, summed over the processes."""
        mesh = self.mesh
        home = gal.device
        tables = self._tables(gal, sw)
        on_device = {}
        for device in mesh.local_devices:
            if device not in on_device:
                on_device[device] = (tuple(None if t is None else t.to(device) for t in tables),
                                     torch.arange(gal.shape[0], device=device))
        parts = []
        for b, (q0, q1) in enumerate(blocks):
            if b % mesh.size not in mesh.local_positions:
                continue
            device = mesh.devices[b % mesh.size]
            dev_tables, idx = on_device[device]
            parts.append((q0, q1, self._block_counts(
                dev_tables, idx, None, self.gallery_chunk, s_all[q0:q1].to(device),
                d_true[q0:q1].to(device), tm[q0:q1].to(device))))
        counts = torch.zeros(s_all.shape[0], dtype=torch.int64, device=home)
        for q0, q1, part in parts:
            counts[q0:q1] = part.to(home)
        return all_reduce_sum(counts)

    def _gallery_sharded(self, gal, sw, blocks, s_all, d_true, tm) -> torch.Tensor:
        """The gallery resident in mesh.size shards, each transformed and
        swept on its own device against every (replicated) query block; the
        per-shard counts summed once, at the end, over the shards and the
        processes."""
        mesh = self.mesh
        home = gal.device
        n_gal = gal.shape[0]
        chunk = min(self.gallery_chunk, -(-n_gal // mesh.size))
        per_dev_chunks = -(-n_gal // (mesh.size * chunk))
        shards = gallery_shards(gal, mesh, rows=per_dev_chunks * chunk)
        self.last_gallery_placement = placement(shards)
        queries = [replicate(t, mesh) for t in (s_all, d_true, tm)]
        parts = []
        for d, shard in enumerate(shards):
            tables = self._tables(shard.data, sw)
            idx = torch.arange(shard.start, shard.start + shard.data.shape[0],
                               device=shard.device)
            s_rep, dt_rep, tm_rep = (q[d] for q in queries)
            parts.append(torch.cat([
                self._block_counts(tables, idx, shard.mask, chunk, s_rep[q0:q1], dt_rep[q0:q1],
                                   tm_rep[q0:q1]) for q0, q1 in blocks]))
        return all_reduce_sum(sum(p.to(home) for p in parts))


def sq_distances(g: torch.Tensor, q: torch.Tensor, g_sq: torch.Tensor) -> torch.Tensor:
    """[G, Q] squared Euclidean distances, g² + q² − 2 g·qᵀ in f32 (one
    GEMM); ``g_sq``: the gallery's squared norms [G]."""
    q_sq = (q * q).sum(dim=1)
    return g_sq[:, None] + q_sq[None, :] - 2.0 * (g @ q.T)


@torch.no_grad()
@spanned("rank", stretch=True)
def euclidean_ranks(gallery_embeds, query_embeds, block: int = 1024,
                    true_match: Optional[np.ndarray] = None, mesh: Optional[Mesh] = None,
                    device: Optional[torch.device] = None) -> np.ndarray:
    """Ranks under plain Euclidean distance on embedding vectors, the SAFA
    and baseline families' eval (reference cvig_baseline.py:456-460);
    squared distances rank as the reference's sqrt distances do. Rank(q) =
    1 + #{g != tm(q) : d(g, q) <= d(tm(q), q)}, the true match's distance
    read off the same matrix, so its own tie is exact.

    Gallery [G, D] and queries [Q, D]: numpy (put on ``device``, the card
    when None) or tensors (kept where they are unless ``device`` says).
    ``true_match``: the gallery index of each query's match [Q]; None =
    arange (Q == G). The products run in f32 with TF32 off. ``mesh`` keeps
    the gallery resident in mesh.size shards: each device computes its
    shard's GEMM against the replicated query block, the true match's
    distance is read off the shard that holds it, and the per-shard counts
    are summed, so the ranks equal one device's. Returns int32 [Q]. Spans:
    ``rank`` with one ``rank.block`` a query block (in it ``rank.true``, the
    true matches' distances read off the block) and ``rank.fetch``."""

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x.to(device or x.device, torch.float32)
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device if device is not None else require_cuda())

    if mesh is not None and device is None:
        device = mesh.home
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
    if mesh is None:
        shards = [Shard(g, None, 0, ng)]
        queries, tms = [q_all], [tm]
    else:
        shards = gallery_shards(g, mesh)
        queries, tms = replicate(q_all, mesh), replicate(tm, mesh)
    tables = [(torch.arange(s.start, s.start + s.data.shape[0], device=s.device),
               (s.data * s.data).sum(dim=1)) for s in shards]
    counts = []
    with full_precision_matmul():
        for q0 in range(0, nq, block):
            q1 = min(q0 + block, nq)
            with span("rank.block"):
                d2s, is_tms, d_true = [], [], 0
                for shard, (idx, g_sq), q, t in zip(shards, tables, queries, tms):
                    d2 = sq_distances(shard.data, q[q0:q1], g_sq)  # [G(shard), Qb]
                    is_tm = idx[:, None] == t[None, q0:q1]
                    d2s.append(d2)
                    is_tms.append(is_tm)
                    # exactly one shard holds each true match; the others add 0
                    with span("rank.true"):
                        d_true = d_true + torch.where(is_tm, d2, torch.zeros(
                            (), device=d2.device)).sum(dim=0).to(g.device)
                if mesh is not None:
                    d_true = all_reduce_sum(d_true)
                count = 0
                for shard, d2, is_tm in zip(shards, d2s, is_tms):
                    le = (d2 <= d_true.to(d2.device)[None, :]) & ~is_tm
                    if shard.mask is not None:
                        le &= shard.mask[:, None]
                    count = count + le.sum(dim=0).to(g.device)
                counts.append(count if mesh is None else all_reduce_sum(count))
    with span("rank.fetch"):
        return (torch.cat(counts) + 1).cpu().numpy().astype(np.int32)


@spanned("recall")
def metrics_from_ranks(ranks: np.ndarray) -> Dict[str, float]:
    """Reference metric suite (cvig_fov.py:553-567); span ``recall``."""
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
