"""Gallery embedding index: persistence and top-k retrieval, on one device
or resident-sharded over a device mesh (port of
witw_tpu/evaluation/index.py).

An index holds the embedded overhead gallery [N, h, W, c] on the host and,
once searched, its rFFT and window norms on its device. Searches score
through the FFT matcher (``match.fft_matcher``), chunk by chunk:

- ``search``: top-k per query, a per-chunk top-k merged on the device;
- ``score_all``: every item's distance and orientation (the heatmap's
  need), from the resident tables or streamed from the host;
- ``search_approx``: a pooled-cosine prefilter, then the exact rerank of
  its candidates;
- ``place_sharded``, ``search_sharded``, ``score_all_sharded``: the
  gallery split over a ``parallel.Mesh``, each device scoring only its
  own shard; the per-shard top-k lists are merged at the end. Across
  processes each process holds and scores the shards of its own mesh
  positions, and the lists (or the scores) are gathered over the
  processes, so every process returns one process's answer.

The npz layout is witw_tpu's (``embeds`` and ``meta_<key>``), so either
package loads the other's index.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from witw_tpu_torch.match.distance import window_sq_norms
from witw_tpu_torch.match.fft_matcher import candidates_vs_queries, gallery_vs_queries, query_fft
from witw_tpu_torch.parallel.collectives import allgather_rows, process_allgather
from witw_tpu_torch.parallel.mesh import Mesh, gallery_shards, placement, replicate
from witw_tpu_torch.utils.device import require_cuda


def _smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest values of each row of d and their column indices,
    ascending; equal values keep the lower index first (jax.lax.top_k's
    rule, which torch.topk does not promise on the card)."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def shard_layout(n: int, mesh: Mesh, gallery_chunk: int, max_k: int) -> Dict[str, int]:
    """witw_tpu's placement arithmetic: ``n_local`` rows per device, a
    whole number ``per_dev_chunks`` of chunks of ``chunk`` rows, the chunk
    at least ``max_k`` (or the shard) wide, since each chunk keeps its own
    top k."""
    n_local = -(-n // mesh.size)
    chunk = min(gallery_chunk, n_local)
    chunk = max(chunk, min(max_k, n_local))
    per_dev_chunks = -(-n_local // chunk)
    return {"chunk": chunk, "per_dev_chunks": per_dev_chunks,
            "n_local": per_dev_chunks * chunk, "max_k": max_k}


def merge_shard_topk(lists, k: int, home: torch.device):
    """The k best of per-shard candidate lists, each (distances [Q, k_l],
    global indices [Q, k_l], extras...) ordered by (distance, index):
    concatenated in mesh order (shards hold ascending index ranges) before a
    stable sort, so that equal distances keep ascending global index.
    Returns the merged tensors on ``home``."""
    cols = [torch.cat([part[j].to(home) for part in lists], dim=1) for j in range(len(lists[0]))]
    top_d, sel = _smallest_k(cols[0], k)
    return (top_d,) + tuple(torch.gather(c, 1, sel) for c in cols[1:])


def merge_process_topk(merged, k: int, home: torch.device):
    """Every process's merged list (:func:`merge_shard_topk`) merged again
    in process order, which is mesh order; the list itself in one
    process."""
    every = [process_allgather(t) for t in merged]
    if every[0].shape[0] == 1:
        return merged
    return merge_shard_topk([tuple(t[r] for t in every) for r in range(every[0].shape[0])],
                            k, home)


def placed(index, mesh: Optional[Mesh], gallery_chunk: int) -> Dict:
    """An index's sharded placement: the current one, or a new one on
    ``mesh`` when it names another mesh (ValueError when there is none)."""
    if index._sharded is None or (mesh is not None and index._sharded["mesh"] != mesh):
        if mesh is None:
            raise ValueError("call place_sharded(mesh) first or pass mesh=")
        index.place_sharded(mesh, gallery_chunk)
    return index._sharded


class GalleryIndex:
    """Embedded overhead gallery with precomputed correlation quantities.

    embeds: [N, h, W, c] overhead (polar-tower) feature maps, kept on the
    host as float32. meta: optional per-item metadata (e.g. tile centres).
    device: where the searches run and the tables live: the CUDA device
    when None (RuntimeError without one); the CPU only when asked for.
    """

    # Bound on the resident tables (score_all's auto mode): witw_tpu keeps
    # them under 6 GiB of a v5e's 16 GiB, 3/8 of the chip; the same 3/8 of an
    # H100's 80 GB is 30 GB. A 100k-tile FOV index [100000, 4, 64, 16] needs
    # 1.72 GB of them (see _resident_bytes), so about 1.7M tiles stay
    # resident; past that, score_all streams chunks from the host.
    RESIDENT_BYTES_MAX = 30 * 10**9
    # Tiles uploaded and transformed at a time when the tables are built.
    TABLE_CHUNK = 8192

    def __init__(self, embeds: np.ndarray, meta: Optional[Dict[str, np.ndarray]] = None,
                 device=None):
        self.embeds = np.asarray(embeds, np.float32)
        self.meta = {k: np.asarray(v) for k, v in (meta or {}).items()}
        self.device = torch.device(device) if device is not None else require_cuda()
        self._fo: Optional[torch.Tensor] = None
        self._wsq: Dict[int, torch.Tensor] = {}
        self._pool: Dict[Tuple[int, int], torch.Tensor] = {}
        self._sharded: Optional[Dict] = None
        self.last_gallery_placement = None

    def __len__(self) -> int:
        return len(self.embeds)

    # ---- persistence ----

    @staticmethod
    def _npz_path(path: str) -> str:
        # np.savez_compressed appends '.npz' to extension-less paths
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        arrays = {"embeds": self.embeds}
        arrays.update({f"meta_{k}": v for k, v in self.meta.items()})
        np.savez_compressed(self._npz_path(path), **arrays)

    @classmethod
    def load(cls, path: str, device=None) -> "GalleryIndex":
        with np.load(cls._npz_path(path)) as data:
            meta = {k[len("meta_"):]: data[k] for k in data.files if k.startswith("meta_")}
            return cls(data["embeds"], meta, device)

    # ---- retrieval ----

    def _gallery_fft(self, sw: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The resident tables: the gallery's rFFT [N, h, W // 2 + 1, c]
        and its window norms [N, W] at query width sw. The gallery goes up
        TABLE_CHUNK tiles at a time, each upload feeding both tables, so the
        f32 gallery is never whole on the device."""
        if self._fo is None or sw not in self._wsq:
            n, h, w, c = self.embeds.shape
            fo = self._fo
            if fo is None:
                fo = torch.empty((n, h, w // 2 + 1, c), dtype=torch.complex64, device=self.device)
            wsq = torch.empty((n, w), dtype=torch.float32, device=self.device)
            for a in range(0, n, self.TABLE_CHUNK):
                gal = torch.from_numpy(self.embeds[a:a + self.TABLE_CHUNK]).to(self.device)
                if self._fo is None:
                    fo[a:a + len(gal)] = torch.fft.rfft(gal, dim=2)
                wsq[a:a + len(gal)] = window_sq_norms(gal, sw)
            self._fo, self._wsq[sw] = fo, wsq
        return self._fo, self._wsq[sw]

    def _resident_bytes(self) -> int:
        """Device bytes of the resident tables: the complex64 rFFT table and
        the window norms of one query width (the chunks that build them and
        the searches' chunks are transients of a few hundred MB)."""
        n, h, w, c = self.embeds.shape
        return n * h * (w // 2 + 1) * c * 8 + n * w * 4

    def _queries(self, surface_embeds) -> torch.Tensor:
        return torch.as_tensor(np.asarray(surface_embeds, np.float32), device=self.device)

    @staticmethod
    def _chunks(n: int, gallery_chunk: int, least: int = 1):
        """Balanced chunks of the gallery axis, each at least ``least``."""
        chunk = max(min(gallery_chunk, n), least)
        n_chunks = -(-n // chunk)
        chunk = max(-(-n // n_chunks), least)
        return [(start, min(start + chunk, n)) for start in range(0, n, chunk)]

    @torch.no_grad()
    def score_all(
        self, surface_embeds: np.ndarray, gallery_chunk: int = 2048,
        fast: bool = False, resident: Optional[bool] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Distances and orientations of every gallery item against every
        query: ([N, Q] float32, [N, Q] int32). ``resident`` (default: auto,
        by RESIDENT_BYTES_MAX) scores the resident tables that search()
        also uses; ``resident=False`` streams chunk FFTs from the host with
        O(gallery_chunk) device memory. ``fast``: bf16 frequency product
        (opt-in approximation)."""
        n = len(self.embeds)
        sw = surface_embeds.shape[2]
        w = self.embeds.shape[2]
        if resident is None:
            resident = self._resident_bytes() <= self.RESIDENT_BYTES_MAX
        fs, s_norm = query_fft(self._queries(surface_embeds), w)
        parts_d, parts_o = [], []
        if resident:
            fo, wsq = self._gallery_fft(sw)
            for a, b in self._chunks(n, gallery_chunk):
                d, o = gallery_vs_queries(fo[a:b], wsq[a:b], fs, s_norm, w, fast)
                parts_d.append(d)
                parts_o.append(o)
            return (torch.cat(parts_d).cpu().numpy().astype(np.float32),
                    torch.cat(parts_o).cpu().numpy().astype(np.int32))
        out_d = np.empty((n, fs.shape[0]), np.float32)
        out_o = np.empty((n, fs.shape[0]), np.int32)
        for a in range(0, n, gallery_chunk):
            b = min(a + gallery_chunk, n)
            gal = torch.from_numpy(self.embeds[a:b]).to(self.device)
            d, o = gallery_vs_queries(torch.fft.rfft(gal, dim=2), window_sq_norms(gal, sw),
                                      fs, s_norm, w, fast)
            out_d[a:b] = d.cpu().numpy()
            out_o[a:b] = o.cpu().numpy()
        return out_d, out_o

    # ---- approximate two-stage retrieval ----

    def _pooled(self, sw: Optional[int] = None) -> torch.Tensor:
        """L2-normalized pooled gallery descriptors [N, S, h*c] on the
        device, built on the host. Full-width queries (sw None or >= W): the
        width mean, one descriptor (S = 1). Narrow queries: cyclic sw-wide
        window means at stride sw // 2 (S = ceil(W / stride)), so that a
        FOV crop's mean has a comparable gallery descriptor (witw_tpu's
        measured candidate recall: ~0.89 with the full-width mean against
        1.00 with these)."""
        w = self.embeds.shape[2]
        if sw is None or sw >= w:
            sw = w
        stride = w if sw == w else max(1, sw // 2)
        key = (sw, stride)
        if key not in self._pool:
            x = self.embeds
            if sw == w:
                d = np.mean(x, axis=2)[:, None]  # [N, 1, h, c]
            else:
                xx = np.concatenate([x, x[:, :, : sw - 1]], axis=2)
                cum = np.cumsum(xx, axis=2, dtype=np.float32)
                cum = np.concatenate([np.zeros_like(cum[:, :, :1]), cum], axis=2)
                wm = (cum[:, :, sw:] - cum[:, :, :-sw]) / sw  # [N, h, w, c]
                d = np.moveaxis(wm[:, :, ::stride], 2, 1)  # [N, S, h, c]
            d = d.reshape(len(self.embeds), d.shape[1], -1)
            d = d / np.maximum(np.linalg.norm(d, axis=2, keepdims=True), 1e-10)
            self._pool[key] = torch.from_numpy(np.ascontiguousarray(d, np.float32)).to(self.device)
        return self._pool[key]

    @torch.no_grad()
    def search_approx(
        self,
        surface_embeds: np.ndarray,
        k: int = 10,
        candidates: int = 256,
        query_block: int = 16,
        fast: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Two-stage top-k: a pooled-cosine prefilter picks ``candidates``
        gallery items per query (the max cosine over the S window shifts),
        then the exact FFT correlation and chord distance rerank only those.
        Same return contract as search(); with ``candidates >= len(index)``
        it equals the exact search."""
        n = len(self.embeds)
        m = min(max(candidates, k), n)  # the rerank pool always covers top-k
        k = min(k, m)
        q = surface_embeds.shape[0]
        sw = surface_embeds.shape[2]
        w = self.embeds.shape[2]

        s = self._queries(surface_embeds)
        sp = s.mean(dim=2).reshape(q, -1)
        sp = sp / sp.norm(dim=1, keepdim=True).clamp_min(1e-10)
        pooled = self._pooled(sw)  # [N, S, hc]
        # The [Q, chunk, S] similarity transient is capped at 64 MB.
        chunk_n = int(min(n, max(256, (1 << 24) // max(1, q * pooled.shape[1]))))
        sims = np.empty((q, n), np.float32)
        for n0 in range(0, n, chunk_n):
            n1 = min(n0 + chunk_n, n)
            block = torch.einsum("qd,nsd->qns", sp, pooled[n0:n1]).amax(dim=2)
            sims[:, n0:n1] = block.cpu().numpy()
        cand = np.argpartition(-sims, m - 1, axis=1)[:, :m]  # [Q, M]

        fs_all, s_norm_all = query_fft(s, w)
        out_i = np.empty((q, k), np.int64)
        out_d = np.empty((q, k), np.float32)
        out_o = np.empty((q, k), np.int32)
        for q0 in range(0, q, query_block):
            q1 = min(q0 + query_block, q)
            idx = cand[q0:q1]  # [qb, M]
            gal = torch.from_numpy(self.embeds[idx]).to(self.device)  # [qb, M, h, w, c]
            fo = torch.fft.rfft(gal, dim=3)
            wsq = window_sq_norms(gal.reshape((q1 - q0) * m, *gal.shape[2:]), sw).reshape(q1 - q0, m, -1)
            d, orient = candidates_vs_queries(fo, wsq, fs_all[q0:q1], s_norm_all[q0:q1], w, fast)
            d = d.cpu().numpy()
            orient = orient.cpu().numpy()
            sel = np.argpartition(d, k - 1, axis=1)[:, :k]
            rows = np.arange(q1 - q0)[:, None]
            dd = d[rows, sel]
            order = np.argsort(dd, axis=1)
            out_d[q0:q1] = dd[rows, order]
            out_i[q0:q1] = idx[rows, sel][rows, order]
            out_o[q0:q1] = orient[rows, sel][rows, order]
        return out_i, out_d, out_o

    @torch.no_grad()
    def search(
        self,
        surface_embeds: np.ndarray,
        k: int = 10,
        gallery_chunk: int = 2048,
        fast: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k most similar gallery items per query.

        surface_embeds: [Q, h, sw, c]. Returns (indices [Q, k] int64,
        distances [Q, k] float32, orientations [Q, k] int32), by ascending
        chord distance, equal distances by ascending index. Each chunk of
        the resident tables gives its k best; the merge of the chunks' lists
        runs on the device, and only the [Q, k] results come back."""
        n = len(self.embeds)
        sw = surface_embeds.shape[2]
        w = self.embeds.shape[2]
        k = min(k, n)
        fo, wsq = self._gallery_fft(sw)
        fs, s_norm = query_fft(self._queries(surface_embeds), w)
        ds, idxs, os_ = [], [], []
        for a, b in self._chunks(n, gallery_chunk, least=k):
            d, o = gallery_vs_queries(fo[a:b], wsq[a:b], fs, s_norm, w, fast)  # [G, Q]
            top_d, top_i = _smallest_k(d.T, min(k, b - a))
            ds.append(top_d)
            idxs.append(top_i + a)
            os_.append(torch.gather(o.T, 1, top_i))
        # Chunk by chunk, each list by (distance, index): equal distances
        # meet the stable sort in ascending index order.
        top_d, sel = _smallest_k(torch.cat(ds, dim=1), k)
        return (
            torch.gather(torch.cat(idxs, dim=1), 1, sel).cpu().numpy().astype(np.int64),
            top_d.cpu().numpy().astype(np.float32),
            torch.gather(torch.cat(os_, dim=1), 1, sel).cpu().numpy().astype(np.int32),
        )

    # ---- mesh-resident sharded retrieval ----

    def place_sharded(self, mesh: Mesh, gallery_chunk: int = 2048, max_k: int = 128) -> None:
        """Keep the gallery resident in mesh.size shards, shard d on
        ``mesh.devices[d]`` (the rank evaluator's gallery-resident
        placement), each a whole number of chunks; its rFFT and window norms
        are built on its device at the first sharded search. ``max_k``
        bounds the per-shard top-k width, so a sharded search takes
        k <= max_k. ``last_gallery_placement`` records the shards."""
        layout = shard_layout(len(self.embeds), mesh, gallery_chunk, max_k)
        shards = gallery_shards(self.embeds, mesh, rows=layout["n_local"])
        self._sharded = dict(layout, mesh=mesh, shards=shards, fo=[None] * len(shards), wsq={})
        self.last_gallery_placement = placement(shards)

    def _shard_tables(self, st: Dict, d: int, sw: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard d's rFFT and its window norms at query width sw, built on
        the shard's device on first use."""
        gal = st["shards"][d].data
        if st["fo"][d] is None:
            st["fo"][d] = torch.fft.rfft(gal, dim=2)
        key = (d, sw)
        if key not in st["wsq"]:
            st["wsq"][key] = window_sq_norms(gal, sw)
        return st["fo"][d], st["wsq"][key]

    def _shard_chunks(self, st: Dict, surface_embeds: np.ndarray, fast: bool):
        """Per shard, per chunk: (chunk's first local row, its distances
        [G, Q] and orientations [G, Q]) against the queries replicated to
        the shard's device; every shard's work is issued before any result
        is read."""
        sw = surface_embeds.shape[2]
        w = self.embeds.shape[2]
        queries = replicate(np.asarray(surface_embeds, np.float32), st["mesh"])
        ffts = {}
        out = []
        for d, (shard, q) in enumerate(zip(st["shards"], queries)):
            if shard.device not in ffts:
                ffts[shard.device] = query_fft(q, w)
            fs, s_norm = ffts[shard.device]
            fo, wsq = self._shard_tables(st, d, sw)
            chunk = st["chunk"]
            out.append([(a,) + gallery_vs_queries(fo[a:a + chunk], wsq[a:a + chunk], fs, s_norm,
                                                  w, fast)
                        for a in range(0, shard.data.shape[0], chunk)])
        return out

    @torch.no_grad()
    def search_sharded(
        self, surface_embeds: np.ndarray, k: int = 10, mesh: Optional[Mesh] = None,
        gallery_chunk: int = 2048, fast: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """:meth:`search` with the gallery resident-sharded (call
        :meth:`place_sharded` first, or pass ``mesh``): each device keeps
        the k best of each of its chunks, then of its shard (padded rows at
        +inf), and only those [Q, k] lists meet, merged by (distance,
        global index) as :meth:`search` orders them. Same contract as
        :meth:`search`; k must not exceed the placement's ``max_k``."""
        st = placed(self, mesh, gallery_chunk)
        k = min(k, len(self.embeds))
        if k > st["max_k"]:
            raise ValueError(f"k={k} exceeds place_sharded max_k={st['max_k']}; re-place the "
                             "index with a larger max_k")
        k_local = min(k, st["n_local"])
        lists = []
        for shard, chunks in zip(st["shards"], self._shard_chunks(st, surface_embeds, fast)):
            parts = []
            for a, d, o in chunks:
                d = torch.where(shard.mask[a:a + d.shape[0], None], d, torch.inf)
                top_d, top_i = _smallest_k(d.T, k_local)
                parts.append((top_d, top_i + (shard.start + a), torch.gather(o.T, 1, top_i)))
            lists.append(merge_shard_topk(parts, k_local, shard.device))
        home = st["shards"][0].device
        top_d, top_i, top_o = merge_process_topk(merge_shard_topk(lists, k, home), k, home)
        return (top_i.cpu().numpy().astype(np.int64), top_d.cpu().numpy().astype(np.float32),
                top_o.cpu().numpy().astype(np.int32))

    @torch.no_grad()
    def score_all_sharded(
        self, surface_embeds: np.ndarray, mesh: Optional[Mesh] = None,
        gallery_chunk: int = 2048, fast: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`score_all` with the gallery resident-sharded (call
        :meth:`place_sharded` first, or pass ``mesh``): each device scores
        only its own shard. ([N, Q] float32, [N, Q] int32); distances agree
        with :meth:`score_all` to f32 roundoff (the chunks batch the
        products differently)."""
        st = placed(self, mesh, gallery_chunk)
        parts = [(torch.cat([d for _, d, _ in chunks])[:shard.valid].cpu(),
                  torch.cat([o for _, _, o in chunks])[:shard.valid].cpu())
                 for shard, chunks in zip(st["shards"], self._shard_chunks(st, surface_embeds, fast))]
        return (allgather_rows(torch.cat([d for d, _ in parts])).numpy().astype(np.float32),
                allgather_rows(torch.cat([o for _, o in parts])).numpy().astype(np.int32))
