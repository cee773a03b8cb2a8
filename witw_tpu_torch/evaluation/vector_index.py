"""Flat-vector gallery index: persistence and top-k Euclidean retrieval, on one
device or resident-sharded over a device mesh (port of
witw_tpu/evaluation/vector_index.py).

The SAFA towers emit flat unit vectors matched with plain Euclidean
distance, so their gallery is [N, D] (the FOV family's ``GalleryIndex``
holds [N, h, w, c] maps). Distances are true Euclidean (sqrt); a SAFA
embedding is a unit vector, so they lie in [0, 2] like the FOV chord
distance. The gallery and its squared norms stay resident on the device
once searched:

- ``search``: top-k per query in one pass, the [Q, N] distances one GEMM;
  equal distances keep the lower index first, as ``jax.lax.top_k`` does;
- ``score_all``: every item's distance to every query (the heatmap's need),
  from the resident gallery or streamed from the host in chunks;
- ``place_sharded``, ``search_sharded``, ``score_all_sharded``: the gallery
  split over a ``parallel.Mesh`` (GalleryIndex's placement and merge).

The npz layout is witw_tpu's (``embeds`` and ``meta_<key>``), so either
package loads the other's index.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from witw_tpu_torch.evaluation.index import (_smallest_k, merge_process_topk, merge_shard_topk,
                                            placed, shard_layout)
from witw_tpu_torch.parallel.collectives import allgather_rows
from witw_tpu_torch.parallel.mesh import Mesh, gallery_shards, placement, replicate
from witw_tpu_torch.utils.device import require_cuda


def _chunk_dists(gal: torch.Tensor, g2: torch.Tensor, q: torch.Tensor,
                 q2: torch.Tensor) -> torch.Tensor:
    """[Q, G] Euclidean distances of a gallery chunk: one GEMM plus norms."""
    d2 = q2[:, None] + g2[None, :] - 2.0 * (q @ gal.T)
    return torch.sqrt(d2.clamp_min(0.0))


class VectorIndex:
    """Embedded gallery of flat vectors [N, D] float32 (the SAFA family).

    meta: optional per-item metadata (e.g. tile centres) plus the
    provenance keys the serving daemon checks (``precision``, ``family``,
    ``params_sha``). device: where the searches run and the gallery lives:
    the CUDA device when None (RuntimeError without one); the CPU only when
    asked for.
    """

    # Bound on the resident gallery (score_all's auto mode): 3/8 of an
    # H100's 80 GB, as GalleryIndex's. A 100k-tile SAFA index holds
    # 100,000 x 4096 f32 values = 1.64 GB.
    RESIDENT_BYTES_MAX = 30 * 10**9
    # Gallery rows squared at a time for the norms: the [chunk, D] product
    # is a transient, not a second copy of the gallery.
    NORM_CHUNK = 8192

    def __init__(self, embeds: np.ndarray, meta: Optional[Dict[str, np.ndarray]] = None,
                 device=None):
        self.embeds = np.asarray(embeds, np.float32)
        if self.embeds.ndim != 2:
            raise ValueError(f"VectorIndex holds [N, D] vectors, got shape {self.embeds.shape}: "
                             "[N, h, w, c] feature maps belong in GalleryIndex (the FOV "
                             "family's FFT index)")
        self.meta = {k: np.asarray(v) for k, v in (meta or {}).items()}
        self.device = torch.device(device) if device is not None else require_cuda()
        self._gal: Optional[torch.Tensor] = None
        self._g2: Optional[torch.Tensor] = None
        self._sharded: Optional[Dict] = None
        self.last_gallery_placement = None

    def __len__(self) -> int:
        return len(self.embeds)

    # ---- persistence (GalleryIndex's npz contract) ----

    @staticmethod
    def _npz_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        arrays = {"embeds": self.embeds}
        arrays.update({f"meta_{k}": v for k, v in self.meta.items()})
        np.savez_compressed(self._npz_path(path), **arrays)

    @classmethod
    def load(cls, path: str, device=None) -> "VectorIndex":
        with np.load(cls._npz_path(path)) as data:
            embeds = data["embeds"]
            if embeds.ndim != 2:
                raise ValueError(f"{path}: embeds are {embeds.ndim}-D — this file holds an "
                                 "FOV-family GalleryIndex; load it with GalleryIndex.load")
            meta = {k[len("meta_"):]: data[k] for k in data.files if k.startswith("meta_")}
            return cls(embeds, meta, device)

    # ---- retrieval ----

    def _gallery(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._gal is None:
            self._gal = torch.from_numpy(self.embeds).to(self.device)
            self._g2 = torch.cat([(c * c).sum(dim=1) for c in self._gal.split(self.NORM_CHUNK)])
        return self._gal, self._g2

    def _queries(self, query_embeds) -> Tuple[torch.Tensor, torch.Tensor]:
        q = torch.as_tensor(np.asarray(query_embeds, np.float32), device=self.device)
        return q, (q * q).sum(dim=1)

    @torch.no_grad()
    def search(self, query_embeds: np.ndarray, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k nearest gallery items per query. query_embeds: [Q, D].
        Returns (indices [Q, k] int64, distances [Q, k] float32) by
        ascending distance, equal distances by ascending index; only those
        come back from the device."""
        q, q2 = self._queries(query_embeds)
        gal, g2 = self._gallery()
        d, i = _smallest_k(_chunk_dists(gal, g2, q, q2), min(k, len(self.embeds)))
        return i.cpu().numpy().astype(np.int64), d.cpu().numpy().astype(np.float32)

    @torch.no_grad()
    def score_all(self, query_embeds: np.ndarray, gallery_chunk: int = 8192,
                  resident: Optional[bool] = None) -> np.ndarray:
        """Distances of every gallery item to every query, [N, Q] float32.
        ``resident`` (default: auto, by RESIDENT_BYTES_MAX) scores the
        resident gallery that search() also uses in one GEMM;
        ``resident=False`` streams chunks of ``gallery_chunk`` items from the
        host with O(gallery_chunk) device memory."""
        n = len(self.embeds)
        if resident is None:
            resident = self.embeds.nbytes <= self.RESIDENT_BYTES_MAX
        q, q2 = self._queries(query_embeds)
        if resident:
            gal, g2 = self._gallery()
            return _chunk_dists(gal, g2, q, q2).T.contiguous().cpu().numpy()
        out = np.empty((n, q.shape[0]), np.float32)
        for a in range(0, n, gallery_chunk):
            gal = torch.from_numpy(self.embeds[a:a + gallery_chunk]).to(self.device)
            out[a:a + len(gal)] = _chunk_dists(gal, (gal * gal).sum(dim=1), q, q2).T.cpu().numpy()
        return out

    # ---- mesh-resident sharded retrieval ----

    def place_sharded(self, mesh: Mesh, gallery_chunk: int = 8192, max_k: int = 128) -> None:
        """Keep the gallery and its squared norms resident in mesh.size
        shards, shard d on ``mesh.devices[d]``; GalleryIndex.place_sharded's
        layout (``evaluation.index.shard_layout``) and ``max_k`` bound."""
        layout = shard_layout(len(self.embeds), mesh, gallery_chunk, max_k)
        shards = gallery_shards(self.embeds, mesh, rows=layout["n_local"])
        norms = [torch.cat([(c * c).sum(dim=1) for c in s.data.split(self.NORM_CHUNK)])
                 for s in shards]
        self._sharded = dict(layout, mesh=mesh, shards=shards, g2=norms)
        self.last_gallery_placement = placement(shards)

    def _shard_chunks(self, st: Dict, query_embeds: np.ndarray):
        """Per shard, per chunk: (chunk's first local row, its distances
        [Q, chunk]) against the queries replicated to the shard's device;
        every shard's work is issued before any result is read."""
        queries = replicate(np.asarray(query_embeds, np.float32), st["mesh"])
        chunk = st["chunk"]
        out = []
        for shard, g2, q in zip(st["shards"], st["g2"], queries):
            q2 = (q * q).sum(dim=1)
            out.append([(a, _chunk_dists(shard.data[a:a + chunk], g2[a:a + chunk], q, q2))
                        for a in range(0, shard.data.shape[0], chunk)])
        return out

    @torch.no_grad()
    def search_sharded(self, query_embeds: np.ndarray, k: int = 10, mesh: Optional[Mesh] = None,
                       gallery_chunk: int = 8192) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`search` with the gallery resident-sharded (call
        :meth:`place_sharded` first, or pass ``mesh``): each device keeps
        the k best of each chunk, then of its shard (padded rows at +inf),
        and the [Q, k] lists are merged by (distance, global index), as
        :meth:`search` orders them. k must not exceed ``max_k``."""
        st = placed(self, mesh, gallery_chunk)
        k = min(k, len(self.embeds))
        if k > st["max_k"]:
            raise ValueError(f"k={k} exceeds place_sharded max_k={st['max_k']}; re-place the "
                             "index with a larger max_k")
        k_local = min(k, st["n_local"])
        lists = []
        for shard, chunks in zip(st["shards"], self._shard_chunks(st, query_embeds)):
            parts = []
            for a, d in chunks:
                d = torch.where(shard.mask[None, a:a + d.shape[1]], d, torch.inf)
                top_d, top_i = _smallest_k(d, k_local)
                parts.append((top_d, top_i + (shard.start + a)))
            lists.append(merge_shard_topk(parts, k_local, shard.device))
        home = st["shards"][0].device
        top_d, top_i = merge_process_topk(merge_shard_topk(lists, k, home), k, home)
        return top_i.cpu().numpy().astype(np.int64), top_d.cpu().numpy().astype(np.float32)

    @torch.no_grad()
    def score_all_sharded(self, query_embeds: np.ndarray, mesh: Optional[Mesh] = None,
                          gallery_chunk: int = 8192) -> np.ndarray:
        """:meth:`score_all` with the gallery resident-sharded (call
        :meth:`place_sharded` first, or pass ``mesh``): each device scores
        only its own shard. Returns [N, Q] float32."""
        st = placed(self, mesh, gallery_chunk)
        parts = [torch.cat([d for _, d in chunks], dim=1)[:, :shard.valid].T.cpu()
                 for shard, chunks in zip(st["shards"], self._shard_chunks(st, query_embeds))]
        return allgather_rows(torch.cat(parts)).numpy().astype(np.float32)
