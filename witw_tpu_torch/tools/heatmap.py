"""Geolocation heatmap sweep, FOV, SAFA and baseline families (port of
witw_tpu/tools/heatmap.py: ``window_grid``, ``_cache_is_stale``, ``sweep``,
``layer`` and ``main``).

A UTM bounding box is gridded into overlapping edge-meter tiles (reference
heatmap.py:119-124); each tile is cut from the satellite strip with the
native windowed GeoTIFF reader (``tools.geotiff``) and resampled to the
tower's tile size; the query photo(s) and every tile are embedded by the
FOV towers (bf16, whose stride-1 convs run on the conv3x3_bf16 kernel, or
with ``int8`` the static-int8 towers on kernels A, B and C), and every tile
is scored against every photo through ``GalleryIndex.score_all`` (the FFT
matcher). With ``--family safa`` the VGG16+SAFA towers embed photos and
tiles to unit vectors, the tiles go into a VectorIndex and are scored by
Euclidean distance (``VectorIndex.score_all``); the CSV then has no
orientation column. ``--family baseline`` does the same with the 7-conv GeM
towers at their own geometry (``cli.common.host_geometry``: WITW photos
500 x 500, CVUSA 224 x 1232 with their rows repeated; tiles resampled to a
raw 750²; no normalization, no polar transform) and scores exp(-d), its
distances being unbounded. The tile embed loop is
``tools.build_index.embed_tiles``, shared with ``build_index``.

The CSV's columns are witw_tpu's (``photo`` first when several photos are
swept, then x, y, orientation, dissimilarity, score), written with the
stdlib csv module; ``sweep`` returns them as an ordered dict of numpy
arrays. Orientation is in degrees from the embedding's actual width.

Run: ``python -m witw_tpu_torch.tools.heatmap -a 3 -b LEFT BOTTOM RIGHT TOP
-s SATDIR -p photo.jpg [more.jpg ...] -c out.csv --weights ./weights
[--family safa|baseline] [--index-cache tiles.npz] [--int8] [--fast-eval]
[--shard-gallery] [-i -l layer.tiff]``; ``--shard-gallery`` scores the tiles
sharded over every GPU of a multi-GPU host (``score_all_sharded``). The towers come from ``--weights``/``<family>_<fov>_witw``'s
``best`` checkpoint (the port's ``best.pt`` or witw_tpu's ``best.msgpack``).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from witw_tpu_torch.cli.common import host_geometry
from witw_tpu_torch.data.loader import decode_image, resize_host
from witw_tpu_torch.evaluation.index import GalleryIndex
from witw_tpu_torch.evaluation.vector_index import VectorIndex
from witw_tpu_torch.models.quantize import SATURATION_WARN_FRACTION  # noqa: F401 (witw_tpu's name)
from witw_tpu_torch.ops.image import normalize_images, repeat_rows
from witw_tpu_torch.parallel.mesh import make_mesh
from witw_tpu_torch.tools.build_index import (FAMILIES, VECTOR_FAMILIES, check_family,
                                              embed_tiles, family_config, int8_tower,
                                              load_params, tile_size)
from witw_tpu_torch.tools.cities import CITIES, strip_filename
from witw_tpu_torch.tools.geotiff import GeoTiff, resample, write_geotiff_u8
from witw_tpu_torch.train.pipeline import make_pipeline
from witw_tpu_torch.utils.hashing import params_fingerprint

TILE_DTYPES = ("float32", "uint8")


def window_grid(
    bounds: Sequence[float], edge: float, offset: float
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Tile centers + projWin windows over UTM bounds
    (min_e, min_n, max_e, max_n) — reference heatmap.py:119-124."""
    e2 = edge / 2.0
    eastings = np.arange(bounds[0] - e2, bounds[2] - e2, offset)
    northings = np.arange(bounds[3] + e2, bounds[1] + e2, -offset)
    centers_e, centers_n, windows = [], [], []
    for easting in eastings:
        for northing in northings:
            centers_e.append(easting + e2)
            centers_n.append(northing - e2)
            windows.append((easting, northing, easting + edge, northing - edge))
    return np.asarray(centers_e), np.asarray(centers_n), windows


def _cache_is_stale(index, n_windows, centers_e, want_precision,
                    params_sha=None, tile_dtype="float32", family="fov"):
    """True when a cached embedding index cannot serve this sweep: the tile
    grid changed (count or centers), the towers' precision differs (an f32
    gallery must never be scored against an int8 query embedding), the tile
    dtype or the model family differs, or the overhead tower's weights
    changed (a retrained checkpoint with the same grid must not serve the
    old embeddings)."""
    cached_x = np.asarray(index.meta.get("x", []))
    return (
        len(index) != n_windows
        or cached_x.shape != np.shape(centers_e)
        or not np.allclose(cached_x, centers_e)
        or str(index.meta.get("precision", "f32")) != want_precision
        or str(index.meta.get("tile_dtype", "float32")) != tile_dtype
        or str(index.meta.get("family", "fov")) != family
        or (params_sha is not None
            and str(index.meta.get("params_sha", "")) != params_sha)
    )


@contextlib.contextmanager
def tile_reader(sat_path: str, windows: Sequence[tuple], size: int, u8: bool = False):
    """``read_tile(i)``: the strip's window i resampled to size x size,
    float32, or rounded to uint8 with ``u8``. Each calling thread reads
    through a handle of its own (a handle serializes its reads); the strip
    is opened on entry, so a strip the reader cannot open fails here."""
    handles, local, lock = [], threading.local(), threading.Lock()

    def strip() -> GeoTiff:
        if not hasattr(local, "sat"):
            local.sat = GeoTiff(sat_path)
            with lock:
                handles.append(local.sat)
        return local.sat

    def read_tile(i):
        tile = strip().read_world_window(*windows[i]).astype(np.float32)
        tile = resample(tile[..., :3], size, size)
        return np.clip(np.rint(tile), 0.0, 255.0).astype(np.uint8) if u8 else tile

    try:
        strip()
        yield read_tile
    finally:
        for sat in handles:
            sat.close()


def write_csv(path: str, columns: Dict[str, np.ndarray]) -> None:
    """The columns as a CSV with a header row (numpy's shortest repr of
    each value, as pandas writes them)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(columns))
        writer.writerows(zip(*([str(v) for v in col] for col in columns.values())))


@torch.no_grad()
def sweep(
    sat_path: str,
    photo_path,  # str or Sequence[str]
    csv_path: str,
    bounds: Sequence[float],
    edge: float = 225.0,
    offset: float = 56.25,
    fov: int = 70,
    checkpoint_dir: str = "./weights",
    tag: Optional[str] = None,
    batch_size: int = 64,
    state=None,
    index_cache: Optional[str] = None,
    int8: bool = False,
    fast: bool = False,
    verbose: bool = True,
    cfg=None,
    tile_dtype: str = "float32",
    prefetch_tiles: int = 2,
    device=None,
    family: str = "fov",
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Sweep the photo(s) over the tile grid of ``bounds`` on ``device``
    (the card when None; the CPU only when asked for); writes ``csv_path``
    and returns its columns.

    ``state``: the towers' params ``{"surface": sd, "overhead": sd}`` or a
    TrainState; None restores ``checkpoint_dir/tag``'s ``best``.
    ``index_cache``: an .npz path; the embedded tile gallery (a GalleryIndex
    with the tile centres) is loaded from it when it is not stale (see
    ``_cache_is_stale``) and saved to it otherwise, so repeated sweeps of an
    area skip tile extraction and embedding. ``photo_path`` may be a list:
    every photo is embedded in one batch and scored against the same
    gallery; the CSV then gains a ``photo`` column. ``int8``: the
    static-int8 towers, the surface tower calibrated on the normalized
    photo(s), the overhead tower on batch_size tiles spread over the grid.
    ``fast``: bf16 frequency products in the scoring sweep (an opt-in
    approximation; FOV only). ``cfg``: an ExperimentConfig in place of the
    family's ``fov_experiment("witw", fov)`` or ``safa_experiment("witw",
    fov)`` (reduced geometries for tests). ``family="safa"``: the VGG16+SAFA
    towers, a VectorIndex of tile vectors scored by Euclidean distance, and
    no orientation column. ``family="baseline"``: the same with the 7-conv
    GeM towers on raw photos and 750² tiles, score exp(-d), the int8
    surface tower calibrated on the raw (row-repeated) photos.
    ``tile_dtype="uint8"``: tiles are rounded to uint8 on the host and cast
    to f32 on the device (a quarter of the upload); the cache records it.
    ``prefetch_tiles``: the tile reader's queue depth (0: batches read in
    the caller's thread; the same output either way). Each batch's tiles are
    read by ``build_index.READERS`` threads, each with its own handle on the
    strip. ``mesh`` (a ``parallel.Mesh`` of more than one entry): the tile
    gallery is scored resident-sharded over it (``score_all_sharded``, each
    device scoring its own shard; the same CSV up to f32 roundoff), the
    towers run on ``device`` (default: the mesh's first device)."""
    if tile_dtype not in TILE_DTYPES:
        raise ValueError(f"tile_dtype must be one of {TILE_DTYPES}, got {tile_dtype!r}")
    vector = family in VECTOR_FAMILIES
    baseline = family == "baseline"
    if cfg is None:
        cfg = family_config(family, "witw", fov)
    d = cfg.data
    check_family(family, cfg)
    sharded = mesh is not None and mesh.size > 1
    if device is None and mesh is not None:
        device = mesh.devices[0]
    pipeline = make_pipeline(cfg, device)
    device = pipeline.device
    if state is None:
        state = load_params(cfg, os.path.join(checkpoint_dir, tag or f"{family}_{fov}_witw"),
                            device)
    params = getattr(state, "params", state)
    index_cls = VectorIndex if vector else GalleryIndex

    centers_e, centers_n, windows = window_grid(bounds, edge, offset)
    n = len(windows)
    # a cache built by other weights is stale even with the same grid
    params_sha = params_fingerprint(params["overhead"])
    precision = "int8" if int8 else "f32"
    index = None
    if index_cache:
        index_cache = GalleryIndex._npz_path(index_cache)
        if os.path.exists(index_cache):
            try:
                index = index_cls.load(index_cache, device)
            except ValueError:
                index = None  # the other family's index type at this path
            if index is not None and _cache_is_stale(index, n, centers_e, precision, params_sha,
                                                     tile_dtype, family):
                index = None

    photo_paths = ([photo_path] if isinstance(photo_path, (str, os.PathLike))
                   else list(photo_path))
    surface_hw = host_geometry(cfg)[0] if baseline else (d.surface_height, d.surface_width)
    photo = np.stack([resize_host(decode_image(p), *surface_hw) for p in photo_paths])
    surface = {k: v.to(device) for k, v in params["surface"].items()}
    x = torch.from_numpy(photo).to(device)
    if not baseline:
        x = normalize_images(x, d.img_mean, d.img_std)
    elif pipeline.repeat_surface_rows:  # witw_tpu repeats them on the host: the same values
        x = repeat_rows(x, 2)
    if int8:
        fold, forward_int8, _ = int8_tower(cfg)
        s_emb = forward_int8(fold(surface, [x], False), x, False)
    else:
        s_emb = functional_call(pipeline.surface_model, surface, (x,), strict=True)
    s_emb = s_emb.float().cpu().numpy()

    if index is None:
        # only a few batches of tiles are ever resident: a 100k-tile sweep
        # at 256^2 would need ~75 GB materialized up front
        u8 = tile_dtype == "uint8"
        with tile_reader(sat_path, windows, tile_size(cfg), u8) as read_tile:
            embeds, sat_frac = embed_tiles(pipeline, params["overhead"], read_tile, n,
                                           batch_size, int8, prefetch_tiles, context="tile",
                                           tile_dtype=np.uint8 if u8 else np.float32)
        meta = {"x": centers_e, "y": centers_n, "precision": precision,
                "tile_dtype": tile_dtype, "family": family, "params_sha": params_sha}
        if sat_frac is not None:
            meta["int8_saturation"] = sat_frac
        index = index_cls(embeds, meta=meta, device=device)
        if index_cache:
            index.save(index_cache)

    if vector:
        distances = index.score_all_sharded(s_emb, mesh) if sharded else index.score_all(s_emb)
        orientations = None
    elif sharded:
        distances, orientations = index.score_all_sharded(s_emb, mesh, gallery_chunk=2048,
                                                          fast=fast)
    else:
        distances, orientations = index.score_all(s_emb, gallery_chunk=2048, fast=fast)
    parts = []
    for q, path in enumerate(photo_paths):
        cols = {}
        if len(photo_paths) > 1:
            cols["photo"] = np.full(n, str(path), dtype=object)
        cols["x"] = centers_e
        cols["y"] = centers_n
        if orientations is not None:
            cols["orientation"] = orientations[:, q] * 360.0 / index.embeds.shape[2] - 180.0
        cols["dissimilarity"] = distances[:, q]
        # the baseline's f / ||f||^0.5 vectors give unbounded distances
        cols["score"] = (np.exp(-distances[:, q]) if baseline
                         else np.exp(10.0 * (1.0 - distances[:, q])))
        parts.append(cols)
    columns = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    write_csv(csv_path, columns)
    if verbose:
        print(f"swept {n} tiles x {len(photo_paths)} photo(s) -> {csv_path}")
    return columns


def layer(sat_path: str, bounds: Sequence[float], layer_path: str) -> None:
    """Crop the satellite strip to the sweep bounds for GIS display
    (reference heatmap.py:190-194)."""
    with GeoTiff(sat_path) as sat:
        tile = sat.read_world_window(bounds[0], bounds[3], bounds[2], bounds[1])
        gt = sat.geotransform
        out_gt = np.array([bounds[0], gt[1], 0.0, bounds[3], 0.0, gt[5]])
        write_geotiff_u8(layer_path, tile.astype(np.uint8), out_gt, sat.epsg)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Geolocation heatmap sweep")
    parser.add_argument("-a", "--aoi", type=int, choices=range(1, 12), default=3,
                        help="SpaceNet AOI of satellite image")
    parser.add_argument("-b", "--bounds", type=float, nargs=4,
                        default=(447665.8, 5411329.8, 448184.8, 5411814.8),
                        metavar=("left", "bottom", "right", "top"),
                        help="UTM bounds: min easting, min northing, max easting, max northing")
    parser.add_argument("-e", "--edge", type=float, default=225)
    parser.add_argument("-o", "--offset", type=float, default=56.25)
    parser.add_argument("-f", "--fov", type=int, default=70)
    parser.add_argument("-s", "--satdir", default="/local_data/geoloc/sat/utm")
    parser.add_argument("-p", "--photopath", nargs="+", default=["img.jpg"],
                        help="query photo(s); several sweep against the same "
                             "embedded tile gallery in one pass (multi-photo "
                             "CSV gains a 'photo' column)")
    parser.add_argument("-c", "--csvpath", default="./geomatch.csv")
    parser.add_argument("-l", "--layerpath", default="./satlayer.tiff")
    parser.add_argument("-i", "--image", action="store_true")
    parser.add_argument("--weights", default="./weights")
    parser.add_argument("--index-cache", default=None,
                        help="npz path caching the embedded tile gallery between sweeps")
    parser.add_argument("--int8", action="store_true",
                        help="embed with the static-int8 towers")
    parser.add_argument("--family", choices=FAMILIES, default="fov",
                        help="tower family: fov = orientation-aligned FFT sweep (default); safa = "
                             "VGG16+SAFA Euclidean sweep (no orientation column); baseline = "
                             "7-conv GeM towers on raw 750^2 tiles (Euclidean, score exp(-d))")
    parser.add_argument("--fast-eval", action="store_true",
                        help="bf16 frequency product in the tile scoring sweep "
                             "(opt-in approximation; exact is the default)")
    parser.add_argument("--shard-gallery", action="store_true",
                        help="score with the tile gallery resident-sharded across every local "
                             "GPU (multi-GPU hosts); same CSV (f32 roundoff)")
    args = parser.parse_args(argv)
    name = [c.name for c in CITIES.values() if c.index == args.aoi][0]
    sat_path = os.path.join(args.satdir, strip_filename(name))
    columns = sweep(sat_path, args.photopath, args.csvpath, args.bounds, args.edge, args.offset,
                    args.fov, checkpoint_dir=args.weights, index_cache=args.index_cache,
                    int8=args.int8, fast=args.fast_eval, family=args.family,
                    mesh=make_mesh() if args.shard_gallery else None)
    if args.image:
        layer(sat_path, args.bounds, args.layerpath)
    return columns


if __name__ == "__main__":
    main()
