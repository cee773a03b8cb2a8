"""Geolocalization serving daemon: an HTTP endpoint over a prebuilt tile
index (port of witw_tpu/tools/serve.py, FOV, SAFA and baseline families,
on one device or with the gallery sharded over a device mesh).

The daemon loads the towers once, loads an index (built by
``tools.build_index``, by either package) and answers:

    POST /geolocate?k=5[&candidates=256]   body: JPEG/PNG photo bytes
        -> {"results": [{"x", "y", "tile", "distance", "orientation_deg",
            "score"}, ...]}  (the top-k tiles by orientation-aligned chord
        distance; ``candidates`` switches to the two-stage approximate
        search: a pooled-cosine prefilter, then the exact rerank of that
        many tiles)
    GET  /healthz            -> {"status": "ok", "gallery_size": N,
        "sharded_devices": the mesh's size (1 without a mesh), ...}
    GET  /stats              -> request/dispatch/error counters, uptime and
        mean requests per device dispatch (micro-batching occupancy)

Run: ``python -m witw_tpu_torch.tools.serve --index tiles.npz --weights
./weights --tag fov_70_witw --fov 70 [--family safa|baseline] [--int8]
[--max-batch 8] [--shard-gallery] [--port 8000]``

``--shard-gallery`` (a host with more than one GPU) keeps the gallery
resident in one shard per GPU (``place_sharded``): exact searches take
``search_sharded``, with k clamped to its ``max_k``; approximate requests
stay on the one-device two-stage search. The photo is embedded on the
index's device.

``--family safa`` serves VGG16+SAFA towers against a VectorIndex (plain
Euclidean distance on unit embeddings): results carry ``orientation_deg:
null`` (the global embedding has no orientation axis), every request is
searched exactly (``candidates`` has no effect: the search is one GEMM), and
``--fast-eval`` has no effect. The score is exp(10 (1 - d)) in both
families (d in [0, 2]). ``--family baseline`` serves the 7-conv GeM towers
against a VectorIndex the same way, with the baseline's photo geometry
(``cli.common.host_geometry``: WITW 500 x 500, CVUSA 224 x 1232 with its
rows repeated on the device), raw pixels (no normalization), and the score
exp(-d): its f / ||f||^0.5 vectors are not unit ones, so d is unbounded.

The query photo is embedded by the surface tower: bf16 (its stride-1 convs
on the conv3x3_bf16 kernel; the baseline's strided convs on cuDNN) or, with
``--int8``, the static-int8 tower (kernels A, B and C; the baseline's on
im2col + ``torch._int_mm``), calibrated on the first real photo (the
baseline's after its rows are repeated). ``--max-batch N``
(N >= 2) groups concurrent requests into one embed and one search;
``--batch-workers`` threads drain the queue, so that one group's search and
fetch overlap the next group's embed. Groups are padded to power-of-two
sizes and k to power-of-two buckets, as witw_tpu pads them for its
compiled shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from witw_tpu_torch.cli.common import host_geometry
from witw_tpu_torch.data.loader import decode_image_bytes, resize_host
from witw_tpu_torch.evaluation.index import GalleryIndex
from witw_tpu_torch.evaluation.vector_index import VectorIndex
from witw_tpu_torch.models.baseline import BaselineEncoder
from witw_tpu_torch.models.fov_dsm import FovDsm
from witw_tpu_torch.models.safa import VggSafa
from witw_tpu_torch.ops.image import normalize_images, repeat_rows
from witw_tpu_torch.parallel.mesh import make_mesh
from witw_tpu_torch.tools.build_index import (FAMILIES, VECTOR_FAMILIES, check_family,
                                              family_config, int8_tower, load_params)
from witw_tpu_torch.utils.hashing import params_fingerprint
from witw_tpu_torch.utils.profiling import span, spanned


class _Pending:
    """One queued request awaiting a batched dispatch."""

    __slots__ = ("img", "k", "candidates", "done", "result", "error")

    def __init__(self, img, k: int, candidates: int):
        self.img = img
        self.k = k
        self.candidates = candidates
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


def _check_index_matches_towers(index, params, int8: bool, family: str = "fov") -> None:
    """Fail fast when the index was built by another tower family, at
    another precision or by other weights than the serving towers. Indexes
    without the recorded keys (hand-built index objects) pass unchecked."""
    got_family = index.meta.get("family")
    if got_family is not None and str(got_family) != family:
        raise ValueError(
            f"index was built by the {str(got_family)!r} towers but the daemon serves the "
            f"{family!r} family — rebuild the index with --family {family} (or pass "
            f"allow_mismatch=True / --allow-mismatch to score anyway)"
        )
    want = "int8" if int8 else "f32"
    got = index.meta.get("precision")
    if got is not None and str(got) != want:
        raise ValueError(
            f"index was built at precision {got!r} but the daemon would embed "
            f"queries at {want!r} — rebuild the index with "
            f"{'--int8' if int8 else 'no --int8'} (or pass "
            f"allow_mismatch=True / --allow-mismatch to score anyway)"
        )
    recorded = index.meta.get("params_sha")
    if recorded is not None:
        current = params_fingerprint(params["overhead"])
        if str(recorded) != current:
            raise ValueError(
                "index gallery embeddings were produced by a different "
                f"checkpoint (index params_sha {str(recorded)[:12]}..., "
                f"serving towers {current[:12]}...) — rebuild the index from "
                "this checkpoint (or pass allow_mismatch=True / "
                "--allow-mismatch to score anyway)"
            )


class GeolocateService:
    """Embed a query photo, then top-k search a gallery index.

    ``family`` pairs the towers with the index: ``"fov"`` embeds with the
    FOV-DSM surface tower and searches a GalleryIndex (orientation-aligned
    chord distance); ``"safa"`` embeds with the VGG16+SAFA surface tower and
    searches a VectorIndex (Euclidean distance, no orientation axis, so
    results carry ``orientation_deg: None``, and every request is searched
    exactly); ``"baseline"`` does the same with the 7-conv GeM surface tower
    on raw photos at its own geometry, scored exp(-d).

    ``params``: the towers' params ``{"surface": sd, "overhead": sd}`` (or a
    TrainState), moved to the index's device, where the embeds run.
    ``max_batch`` >= 2 enables micro-batching: ``batch_workers`` threads
    each drain up to ``max_batch`` concurrent requests (waiting at most
    ``batch_window_ms`` after the first) and run one embed and one search
    per group. Exact and approximate requests are searched separately, each
    keeping its contract; an approximate group's candidate pool is the
    group's largest (never smaller than any request asked for). ``fast``:
    the bf16 frequency product in the searches (an opt-in approximation).
    ``int8``: the static-int8 surface tower, calibrated on the first real
    photo.

    ``mesh`` (a ``parallel.Mesh`` of more than one entry; one entry counts
    as none) keeps the gallery resident-sharded over it
    (``index.place_sharded``): exact searches take ``search_sharded``, k
    clamped to the placement's ``max_k``, while approximate requests
    (``candidates`` > 0) stay on the one-device search and keep their k."""

    def __init__(self, index, cfg, params, int8: bool = False,
                 fast: bool = False, max_batch: int = 0, batch_window_ms: float = 3.0,
                 allow_mismatch: bool = False, batch_workers: int = 2,
                 max_candidates: int = 65536, family: str = "fov", mesh=None):
        check_family(family, cfg)
        self._vector = family in VECTOR_FAMILIES
        self._baseline = family == "baseline"
        # the index type must match the family: scoring feature maps as flat
        # vectors (or the reverse) would not fail loudly on its own
        if self._vector != (index.embeds.ndim == 2):
            raise ValueError(
                f"family {family!r} needs a {'VectorIndex' if self._vector else 'GalleryIndex'} "
                f"but the index embeds are {index.embeds.ndim}-D — rebuild the index with the "
                f"matching --family")
        params = getattr(params, "params", params)
        if not allow_mismatch:
            _check_index_matches_towers(index, params, int8, family)
        if fast and self._vector:
            warnings.warn(f"--fast-eval has no effect for family {family!r}: the vector search "
                          "is a single exact GEMM (no bf16 frequency-product variant); running "
                          "exact search", stacklevel=2)
            fast = False
        self.index = index
        self.cfg = cfg
        self.family = family
        self._int8 = int8
        self._fast = fast
        self.device = index.device
        self._mesh = mesh if (mesh is not None and mesh.size > 1) else None
        if self._mesh is not None:
            index.place_sharded(self._mesh)
        # the baseline's photo geometry is the dataset's (WITW 500 x 500, CVUSA
        # 224 x 1232, rows repeated on the device)
        self._surface_hw = (host_geometry(cfg)[0] if self._baseline
                            else (cfg.data.surface_height, cfg.data.surface_width))
        self._repeat_rows = self._baseline and cfg.data.dataset.name == "cvusa"
        # A tower of its own holding the weights: the batch workers call it
        # concurrently, which functional_call's parameter swap would race
        # (and the baseline's, in eval mode, writes no buffer).
        if self._baseline:
            self._tower = BaselineEncoder(cfg.model)
        elif self._vector:
            self._tower = VggSafa(cfg.model, self._surface_hw, circ_padding=False)
        else:
            self._tower = FovDsm(cfg.model, circ_padding=False)
        self._tower = self._tower.to(self.device).eval()
        self._tower.load_state_dict(params["surface"])
        self._surface = dict(self._tower.state_dict())
        self._sq = None  # calibrated on the first real photo, so that the
        self._sq_lock = threading.Lock()  # scales match traffic, not a probe

        self.max_batch = int(max_batch)
        # bound on an approximate request's rerank pool: the rerank gathers
        # that many gallery items per query onto the device
        self.max_candidates = int(max_candidates)
        self.started_at = time.time()
        self.stats = {"requests": 0, "dispatches": 0, "errors": 0,
                      "exact_searches": 0, "approx_searches": 0}
        # bumped from concurrent request threads; += drops counts without a lock
        self._stats_lock = threading.Lock()
        self._lifecycle = threading.Lock()  # geolocate enqueue vs close()
        self._queue: Optional[queue.Queue] = None
        self._workers: list = []
        if self.max_batch >= 2:
            self._window = batch_window_ms / 1000.0
            self._queue = queue.Queue()
            self._workers = [
                threading.Thread(target=self._batch_loop, daemon=True, name=f"geolocate-batcher-{i}")
                for i in range(max(1, int(batch_workers)))
            ]
            for t in self._workers:
                t.start()

    def _tower_input(self, x: torch.Tensor) -> torch.Tensor:
        """Photos on the device -> the surface tower's input: normalized, or
        for the baseline family raw, its CVUSA rows repeated."""
        if self._baseline:
            return repeat_rows(x, 2) if self._repeat_rows else x
        d = self.cfg.data
        return normalize_images(x, d.img_mean, d.img_std)

    @torch.no_grad()
    def _embed(self, imgs: np.ndarray) -> np.ndarray:
        """Photos [B, h, w, 3] (0-255) -> surface embeddings: FOV maps
        [B, h', sw', c], SAFA or baseline vectors [B, D]."""
        x = self._tower_input(torch.from_numpy(imgs).to(self.device))
        if not self._int8:
            emb = self._tower(x)
        else:
            fold, forward, _ = int8_tower(self.cfg)
            with self._sq_lock:
                if self._sq is None:
                    self._sq = fold(self._surface, [x], False)
            emb = forward(self._sq, x, False)
        return emb.cpu().numpy()

    @spanned("serve.decode")
    def _decode(self, image_bytes: bytes) -> np.ndarray:
        return resize_host(decode_image_bytes(image_bytes), *self._surface_hw)

    def geolocate(self, image_bytes: bytes, k: int = 5, candidates: int = 0):
        # Decode and resize on the request thread even when batching: host
        # image work runs in parallel across request threads; only the
        # device work goes through the batcher.
        img = self._decode(image_bytes)
        k = max(1, min(int(k), len(self.index)))
        candidates = int(candidates)
        if self._mesh is not None and (candidates <= 0 or self._vector):
            # a sharded search answers from per-shard top-k lists of the
            # placed width; approximate requests never take it
            k = min(k, self.index._sharded["max_k"])
        req = _Pending(img, k, candidates)
        # inline when batching is off or the batcher was closed; the
        # lifecycle lock closes the check-then-put race against close()
        with self._lifecycle:
            batching = self._queue is not None and bool(self._workers)
            if batching:
                self._queue.put(req)
        if not batching:
            self._run_group([req])
        else:
            req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self) -> None:
        """Stop the batcher threads (idempotent; no-op without batching).
        In-flight requests finish; requests racing the shutdown are served
        inline by their own thread."""
        with self._lifecycle:
            workers, self._workers = self._workers, []
            for _ in workers:
                self._queue.put(None)
        if not workers:
            return
        for worker in workers:
            worker.join(timeout=30)
        if any(w.is_alive() for w in workers):
            return  # a long dispatch still drains the queue; it owns a sentinel
        while True:  # serve anything that slipped in behind the sentinels
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                self._run_group([req])

    def _k_bucket(self, k_max: int) -> int:
        """The k a search runs at: clamped to the gallery (and to the
        sharded placement's width) and rounded up to a power of two, so that
        client k values map onto few search shapes. Shared by _run_group and
        warmup."""
        cap = len(self.index)
        if self._mesh is not None:
            cap = min(cap, self.index._sharded["max_k"])
        kb = max(1, min(int(k_max), cap))
        return min(1 << (kb - 1).bit_length(), cap)

    def warmup(self, ks=(1, 5, 10)) -> None:
        """Run the real group path once for every power-of-two batch bucket
        up to max_batch (its top padded bucket included) at each k bucket of
        ``ks``, with zero photos, so that the first clients meet built
        kernels, allocated memory and resident index tables. Stats are
        restored afterwards (exception-safe), so /stats counts only client
        traffic. With --int8 before calibration only the searches run (a
        zero photo must not calibrate the scales)."""
        img = np.zeros(self._surface_hw + (3,), np.float32)
        top = 1 << (max(1, self.max_batch) - 1).bit_length()  # groups pad up to this bucket
        buckets = [1 << i for i in range(top.bit_length())]
        k_buckets = sorted({self._k_bucket(k) for k in ks})
        with self._stats_lock:
            before = dict(self.stats)
        try:
            for b in buckets:
                for kb in k_buckets:
                    if self._int8 and self._sq is None:
                        if self._vector:
                            emb = np.zeros((b, self.index.embeds.shape[1]), np.float32)
                        else:
                            _, h, _, c = self.index.embeds.shape
                            emb = np.zeros((b, h, self._surface_hw[1] // 8, c), np.float32)
                        self._search(emb, kb)
                        continue
                    group = [_Pending(img, kb, 0) for _ in range(b)]
                    self._run_group(group)
                    for r in group:
                        if r.error is not None:
                            raise r.error
        finally:
            with self._stats_lock:
                self.stats.update(before)

    def _batch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            group = [item]
            deadline = time.monotonic() + self._window
            while len(group) < self.max_batch:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remain)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_group(group)
                    return
                group.append(nxt)
            self._run_group(group)

    @staticmethod
    def _pad_pow2(x: np.ndarray) -> np.ndarray:
        """Pad the batch axis to a power of two with copies of the first row."""
        n = len(x)
        bucket = 1 << (n - 1).bit_length()
        if bucket == n:
            return x
        return np.concatenate([x, np.broadcast_to(x[:1], (bucket - n,) + x.shape[1:])])

    @spanned("serve.dispatch")
    def _run_group(self, group) -> None:
        """One device dispatch of ``group``'s requests: span
        ``serve.dispatch`` with ``serve.embed`` and ``serve.search``."""
        try:
            b = len(group)
            with self._stats_lock:
                self.stats["requests"] += b
                self.stats["dispatches"] += 1
            with span("serve.embed"):
                s_emb = self._embed(self._pad_pow2(np.stack([r.img for r in group])))[:b]
            # the vector family serves every request exactly: its exact
            # search is one GEMM, no sweep cost to approximate away
            for approx in (False, True):
                rows = [i for i, r in enumerate(group)
                        if (r.candidates > 0 and not self._vector) == approx]
                if not rows:
                    continue
                with self._stats_lock:
                    self.stats["approx_searches" if approx else "exact_searches"] += len(rows)
                k_max = max(group[i].k for i in rows)
                embs = self._pad_pow2(s_emb[rows])
                if approx:
                    cand = max(max(group[i].candidates for i in rows), k_max)
                    # a larger pool than requested only improves recall; the
                    # cap bounds what the rerank gathers onto the device
                    cand = min(1 << (cand - 1).bit_length(), len(self.index), self.max_candidates)
                    with span("serve.search"):
                        idx, dist, orient = self.index.search_approx(
                            embs, k=min(k_max, cand), candidates=cand, fast=self._fast)
                else:
                    with span("serve.search"):
                        idx, dist, orient = self._search(embs, self._k_bucket(k_max))
                for out_row, i in enumerate(rows):
                    r = group[i]
                    r.result = self._format(idx[out_row], dist[out_row],
                                            None if orient is None else orient[out_row], r.k)
        except BaseException as err:  # propagate to every waiter
            with self._stats_lock:
                self.stats["errors"] += len(group)
            for r in group:
                r.error = err
        finally:
            for r in group:
                r.done.set()

    def _search(self, embs: np.ndarray, k: int):
        """Exact top-k: (indices, distances, orientations or None for the
        vector families), sharded over the mesh when there is one."""
        search = self.index.search_sharded if self._mesh is not None else self.index.search
        if self._vector:
            idx, dist = search(embs, k=k)
            return idx, dist, None
        return search(embs, k=k, fast=self._fast)

    def health(self) -> dict:
        """What GET /healthz answers."""
        return {
            "status": "ok",
            "gallery_size": len(self.index),
            "family": self.family,
            "int8": self._int8,
            "max_batch": self.max_batch,
            "sharded_devices": self._mesh.size if self._mesh is not None else 1,
        }

    def _format(self, idx_row, dist_row, orient_row, k: int):
        """Results of one request: tile centres (meta x/y), distance, the
        orientation in degrees (None for the vector families, ``orient_row``
        None) and the score: exp(10 (1 - d)) where d is in [0, 2] (chord
        distance, or the Euclidean distance of unit vectors), exp(-d) for
        the baseline family's unbounded distances (comparable within one
        gallery, not across families)."""
        xs = self.index.meta.get("x")
        ys = self.index.meta.get("y")
        results = []
        for j, (i, dd) in enumerate(zip(idx_row[:k], dist_row[:k])):
            results.append({
                "x": float(xs[i]) if xs is not None else None,
                "y": float(ys[i]) if ys is not None else None,
                "tile": int(i),
                "distance": float(dd),
                "orientation_deg": (None if orient_row is None else
                                    float(orient_row[j] * 360.0 / self.index.embeds.shape[2]
                                          - 180.0)),
                "score": float(np.exp(-dd) if self._baseline else np.exp(10.0 * (1.0 - dd))),
            })
        return results


def make_handler(service: GeolocateService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, service.health())
            elif self.path.startswith("/stats"):
                with service._stats_lock:
                    s = dict(service.stats)
                s["uptime_s"] = round(time.time() - service.started_at, 3)
                s["mean_batch"] = round(s["requests"] / s["dispatches"], 3) if s["dispatches"] else 0.0
                self._json(200, s)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/geolocate"):
                self._json(404, {"error": "unknown path"})
                return
            k = 5
            candidates = 0  # 0 = exact search; > 0 = two-stage approximate
            if "?" in self.path:
                for part in self.path.split("?", 1)[1].split("&"):
                    if part.startswith("k="):
                        try:
                            k = int(part[2:])
                            if k < 1:
                                raise ValueError(k)
                        except ValueError:
                            self._json(400, {"error": "bad k"})
                            return
                    elif part.startswith("candidates="):
                        try:
                            candidates = int(part[len("candidates="):])
                            if candidates < 0:  # must not enable a k-sized pool
                                raise ValueError(candidates)
                        except ValueError:
                            self._json(400, {"error": "bad candidates"})
                            return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._json(400, {"error": "empty body (expect image bytes)"})
                return
            data = self.rfile.read(length)
            try:
                results = service.geolocate(data, k=k, candidates=candidates)
            except Exception as err:  # bad image etc.
                self._json(400, {"error": f"{type(err).__name__}: {err}"})
                return
            self._json(200, {"results": results})

    return Handler


def serve(service: GeolocateService, port: int = 8000, host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Bind the HTTP server (returned; call .serve_forever(), and .shutdown()
    from another thread)."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--index", required=True,
                        help="gallery index .npz (GalleryIndex for --family fov, VectorIndex for "
                             "--family safa and baseline)")
    parser.add_argument("--weights", default="./weights")
    parser.add_argument("--tag", default=None)
    parser.add_argument("--dataset", default="witw")
    parser.add_argument("--fov", type=int, default=70)
    parser.add_argument("--family", choices=FAMILIES, default="fov",
                        help="tower/index family: fov = FOV-DSM towers + orientation-aligned FFT "
                             "index (default); safa = VGG16+SAFA towers + Euclidean vector index; "
                             "baseline = 7-conv GeM towers + Euclidean vector index (--fov "
                             "ignored; score = exp(-d))")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--fast-eval", action="store_true",
                        help="bf16 frequency product in the searches (opt-in approximation; "
                             "exact is the default)")
    parser.add_argument("--max-batch", type=int, default=0,
                        help=">=2 enables request micro-batching: concurrent requests share one "
                             "embed+search dispatch")
    parser.add_argument("--shard-gallery", action="store_true",
                        help="keep the gallery resident-sharded across every local GPU "
                             "(multi-GPU hosts): exact searches take the sharded top-k path")
    parser.add_argument("--batch-window-ms", type=float, default=3.0,
                        help="max wait after the first queued request before dispatching a "
                             "partial batch")
    parser.add_argument("--allow-mismatch", action="store_true",
                        help="serve even when the index's recorded precision or weights "
                             "fingerprint differs from the serving towers (degrades ranking)")
    parser.add_argument("--batch-workers", type=int, default=2,
                        help="concurrent batch-dispatch threads (>=2 lets groups overlap)")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the warm-up pass over the batch and k buckets at startup")
    parser.add_argument("--max-candidates", type=int, default=65536,
                        help="cap on any request's approximate-search rerank pool")
    args = parser.parse_args(argv)

    cfg = family_config(args.family, args.dataset, args.fov)
    index = (VectorIndex if args.family in VECTOR_FAMILIES else GalleryIndex).load(args.index)
    tag = args.tag or f"{args.family}_{args.fov}_{args.dataset}"
    params = load_params(cfg, os.path.join(args.weights, tag), index.device)
    service = GeolocateService(index, cfg, params, int8=args.int8, fast=args.fast_eval,
                               max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
                               allow_mismatch=args.allow_mismatch,
                               batch_workers=args.batch_workers,
                               max_candidates=args.max_candidates, family=args.family,
                               mesh=make_mesh() if args.shard_gallery else None)
    # Bind first, so that a port in use fails fast; connections made during
    # the warm-up wait in the listen backlog.
    server = serve(service, args.port, args.host)
    if not args.no_warmup:
        service.warmup()
    print(f"serving {len(index)} tiles on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
