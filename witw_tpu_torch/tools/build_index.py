"""Build a serving index from a dataset CSV's overhead tiles (port of
witw_tpu/tools/build_index.py, all three serving families).

Each tile listed in the CSV (either reference schema: CVUSA headerless, WITW
17-column) is decoded, resized, normalized, polar-transformed and embedded
by the overhead tower: the bf16 tower, whose stride-1 convs run on the
conv3x3_bf16 kernel, or with ``--int8`` the static-int8 tower (kernels A, B
and C), calibrated on tiles sampled across the whole gallery. ``--family
fov`` (the default) embeds FOV-DSM feature maps into a GalleryIndex;
``--family safa`` embeds VGG16+SAFA unit vectors into a VectorIndex.
``--family baseline`` embeds raw 750² tiles (no normalization, no polar
transform: the encoder scales its input) with the 7-conv GeM overhead tower
(cuDNN convs in bf16; with ``--int8`` im2col + ``torch._int_mm``) into a
VectorIndex of f / ||f||^0.5 vectors, not unit ones (``--fov`` ignored).
The index records its precision ("f32" for the float towers, as witw_tpu stamps
it, or "int8"), family, the overhead tower's weights fingerprint and the
tile paths, so that the serving daemon of either package refuses towers
that did not build it.

Run: ``python -m witw_tpu_torch.tools.build_index --csv test.csv --out
gallery.npz --dataset witw --fov 70 [--family safa|baseline] [--int8]
[--meta-cols longitude:x,latitude:y]`` (headerless CVUSA CSVs address extra
columns by position: ``2:x,3:y``). The towers come from
``--weights/--tag``'s ``best`` checkpoint (tag ``<family>_<fov>_<dataset>``
by default, as witw_tpu names it for every family), the port's ``best.pt``
or witw_tpu's ``best.msgpack``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as futures
import itertools
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from witw_tpu_torch.cli.common import host_geometry
from witw_tpu_torch.configs import baseline_experiment, fov_experiment, safa_experiment
from witw_tpu_torch.data.csv_registry import read_pair_paths, read_rows
from witw_tpu_torch.data.loader import decode_image, prefetch_iter, resize_host
from witw_tpu_torch.evaluation.index import GalleryIndex
from witw_tpu_torch.evaluation.vector_index import VectorIndex
from witw_tpu_torch.models import quantize
from witw_tpu_torch.ops.image import normalize_images
from witw_tpu_torch.ops.polar import polar_transform
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.pipeline import BaselinePipeline, Pipeline, make_pipeline
from witw_tpu_torch.utils.hashing import params_fingerprint

# Embedded batches in flight before the oldest is fetched: consecutive
# batches' upload, embed and fetch overlap (witw_tpu's depth).
IN_FLIGHT = 3
# Threads reading a batch's tiles: decode, the native GeoTIFF reader and its
# resample release the interpreter lock.
READERS = min(8, os.cpu_count() or 1)
# Serving family -> its model config's kind; the vector families' indexes
# are VectorIndexes.
KINDS = {"fov": "fov_dsm", "safa": "vgg_safa", "baseline": "baseline"}
FAMILIES = tuple(KINDS)
VECTOR_FAMILIES = ("safa", "baseline")


def check_family(family: str, cfg=None) -> None:
    """Raise for a family the port does not serve, or one that ``cfg``'s
    model is not."""
    if family not in FAMILIES:
        raise ValueError(f"unsupported family {family!r}")
    if cfg is not None and getattr(cfg.model, "kind", None) != KINDS[family]:
        raise ValueError(f"family {family!r} does not fit the config's "
                         f"{type(cfg.model).__name__}")


def family_config(family: str, dataset: str, fov: int):
    """The preset of a tower family: ``fov_experiment``, ``safa_experiment``
    or ``baseline_experiment`` (which has no fov)."""
    check_family(family)
    if family == "baseline":
        return baseline_experiment(dataset=dataset)
    return (safa_experiment if family == "safa" else fov_experiment)(dataset=dataset, fov=fov)


def tile_size(cfg) -> int:
    """The side the overhead tower takes its tiles at: ``overhead_size``, or
    the baseline family's native 750."""
    return host_geometry(cfg)[1][0]


def load_params(cfg, directory: str, device):
    """The towers' params from ``directory``'s ``best`` checkpoint (the
    port's ``.pt`` or witw_tpu's ``.msgpack``), on ``device``."""
    state = make_pipeline(cfg, device).init_state(torch.Generator().manual_seed(0))
    return Checkpointer(directory).restore("best", state).params


def int8_tower(cfg):
    """The static-int8 pieces of ``cfg``'s family: (the tower folder for
    ``calibrate_overhead_span``, the forward, the saturation count), each
    taking the circular flag of the FOV family's."""
    kind = getattr(cfg.model, "kind", None)
    if kind == "baseline":
        m = cfg.model
        return (lambda sd, batches, circ: quantize.quantize_baseline_tower_static(
                    sd, batches, m.leaky_slope),
                lambda sq, x, circ: quantize.quantized_baseline_forward_static(
                    sq, x, m.gem_power, m.leaky_slope),
                quantize.static_int8_saturation_baseline)
    if kind == "vgg_safa":
        return (quantize.quantize_safa_tower_static,
                lambda sq, x, circ: quantize.quantized_safa_forward_static(*sq, x, circ),
                quantize.static_int8_saturation_safa)
    return (quantize.quantize_tower_static, quantize.quantized_fov_forward_static,
            quantize.static_int8_saturation)


def _column(values: List[str]) -> np.ndarray:
    """A CSV column as pandas would type it: float64 when every field is a
    number or empty (NaN), else strings ("nan" for empty fields)."""
    try:
        return np.asarray([float(v) if v != "" else np.nan for v in values], np.float64)
    except ValueError:
        return np.asarray(["nan" if v == "" else v for v in values]).astype(str)


def read_meta_cols(csv_path: str, header: Optional[int], specs: Sequence[str]) -> Dict[str, np.ndarray]:
    """``--meta-cols``: each ``"src[:dst]"`` copies CSV column src under the
    key dst. Header CSVs name their columns; headerless ones (CVUSA) address
    them by position (``"2:x"``)."""
    names, rows = read_rows(csv_path, header)
    columns = list(names) if names is not None else list(range(max(map(len, rows), default=0)))
    meta = {}
    for spec in specs:
        col, _, dst = spec.partition(":")
        dst = dst or col
        if col in columns:
            pos = columns.index(col)
        elif names is None and col.lstrip("-").isdigit() and int(col) in columns:
            pos = int(col)
        else:
            raise ValueError(
                f"--meta-cols column {col!r} not in CSV (has: {columns}; headerless CSVs use "
                f"integer positions, e.g. '2:x')"
            )
        meta[dst] = _column([row[pos] if pos < len(row) else "" for row in rows])
    return meta


def preprocess_tiles(data_cfg, x: torch.Tensor) -> torch.Tensor:
    """Raw tiles [B, S, S, C] (any dtype, 0-255) -> the overhead tower's
    normalized polar input, normalize then polar as witw_tpu's tools do."""
    x = normalize_images(x.to(torch.float32), data_cfg.img_mean, data_cfg.img_std)
    return polar_transform(x, data_cfg.surface_height, data_cfg.surface_width_max)


@torch.no_grad()
def embed_tiles(
    pipeline: Pipeline,
    overhead: Dict[str, torch.Tensor],
    read_tile: Callable[[int], np.ndarray],
    n: int,
    batch_size: int,
    int8: bool = False,
    prefetch: int = 2,
    context: str = "gallery",
    tile_dtype=np.float32,
) -> Tuple[np.ndarray, Optional[float]]:
    """Embed tiles 0..n-1 with the overhead tower; ``read_tile(i)`` returns
    tile i as an [S, S, C'] array, C' the data config's channels or 1 (a
    grayscale tile fills every channel), and must be safe to call from
    READERS threads at once. ``tile_dtype``: the batch buffers' dtype,
    float32 or uint8 (a quarter of the upload; cast to f32 on the device).
    Batches of ``batch_size`` are read by those threads in a producer thread
    ``prefetch`` batches ahead (0: in the caller's thread), uploaded from
    pinned memory, and up to IN_FLIGHT embedded batches are held before the
    oldest is fetched. ``int8``: the static-int8 tower, calibrated on
    ``batch_size`` tiles spread over [0, n), whose reads are reused; its
    clip fraction on the first batch is checked (``context`` names the tiles
    in the warning). Returns (embeddings [n, h, W', c] or vectors [n, D],
    float32, the clip fraction or None)."""
    d = pipeline.cfg.data
    size = tile_size(pipeline.cfg)
    device = pipeline.device
    overhead = {k: v.to(device) for k, v in overhead.items()}

    def preprocess(x: torch.Tensor) -> torch.Tensor:
        if isinstance(pipeline, BaselinePipeline):
            return x.to(torch.float32)  # raw pixels: the encoder scales them
        return preprocess_tiles(d, x)

    sq, calib_tiles = None, {}
    fold, forward_int8, saturation = int8_tower(pipeline.cfg)
    if int8:
        # gallery-spanning calibration sample; its tiles are reused below
        sq, calib_tiles = quantize.calibrate_overhead_span(overhead, read_tile, n, batch_size,
                                                           preprocess, quantize_fn=fold)

    def embed(x: torch.Tensor) -> torch.Tensor:
        polar = preprocess(x)
        if int8:
            return forward_int8(sq, polar, True)
        return functional_call(pipeline.overhead_model, overhead, (polar,), strict=True)

    def tile_batches(pool):
        # a fresh buffer per batch: batches wait in the prefetch queue while
        # the device embeds earlier ones
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            tiles = [calib_tiles.pop(i, None) for i in range(start, stop)]
            missing = [i for i, t in zip(range(start, stop), tiles) if t is None]
            # each reader takes a run of neighbouring tiles, whose windows
            # share most of the strip rows its handle has just read
            per = max(1, -(-len(missing) // READERS))
            runs = pool.map(lambda run: [read_tile(i) for i in run],
                            [missing[k:k + per] for k in range(0, len(missing), per)])
            read = dict(zip(missing, itertools.chain.from_iterable(runs)))
            buf = np.zeros((batch_size, size, size, d.channels), tile_dtype)
            for j, tile in enumerate(tiles):
                buf[j] = read[start + j] if tile is None else tile
            yield stop - start, buf

    def upload(buf: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(buf)
        if device.type == "cuda":  # pinned, so the copy does not wait for the embeds queued
            return x.pin_memory().to(device, non_blocking=True)
        return x.to(device)

    sat_frac = None
    parts, pending = [], collections.deque()
    with futures.ThreadPoolExecutor(READERS) as pool:
        for real, buf in prefetch_iter(tile_batches(pool), depth=prefetch):
            x = upload(buf)
            if int8 and sat_frac is None:
                sat_frac = quantize.check_saturation(sq, preprocess(x), True, context=context,
                                                     saturation_fn=saturation)
            pending.append((embed(x), real))
            if len(pending) >= IN_FLIGHT:
                emb, r = pending.popleft()
                parts.append(emb[:r].cpu().numpy())
    while pending:
        emb, r = pending.popleft()
        parts.append(emb[:r].cpu().numpy())
    return np.concatenate(parts)[:n], sat_frac


@torch.no_grad()
def build_index(
    csv_path: str,
    out_path: Optional[str] = None,
    dataset: str = "witw",
    fov: int = 70,
    checkpoint_dir: str = "./weights",
    tag: Optional[str] = None,
    batch_size: int = 64,
    int8: bool = False,
    meta_cols: Optional[Sequence[str]] = None,
    state=None,
    cfg=None,
    verbose: bool = True,
    device=None,
    family: str = "fov",
):
    """Embed every overhead tile listed in ``csv_path`` with the overhead
    tower and return (and save to ``out_path``) the index on ``device``
    (the card when None; the CPU only when asked for): a GalleryIndex of
    FOV-DSM maps, or with ``family="safa"`` a VectorIndex of VGG16+SAFA
    unit vectors (Euclidean serving, the daemon's ``--family safa``), or
    with ``family="baseline"`` a VectorIndex of the 7-conv GeM tower's
    vectors of raw 750² tiles.

    ``state``: the towers' params ``{"surface": sd, "overhead": sd}`` or a
    TrainState; None restores them from ``checkpoint_dir``. ``meta_cols``:
    CSV columns copied into the index meta (``"src:dst"`` renames, e.g.
    ``["lon:x", "lat:y"]`` for the daemon's x/y). ``int8``: the static-int8
    tower, calibrated on batch_size tiles spread over the gallery."""
    if cfg is None:
        cfg = family_config(family, dataset, fov)
    d = cfg.data
    check_family(family, cfg)
    pipeline = make_pipeline(cfg, device)
    if state is None:
        state = load_params(cfg, os.path.join(checkpoint_dir, tag or f"{family}_{fov}_{dataset}"),
                            pipeline.device)
    params = getattr(state, "params", state)

    overhead_paths = [o for _, o in read_pair_paths(d.dataset, csv_path)]
    n = len(overhead_paths)

    size = tile_size(cfg)

    def read_tile(i):
        tile = decode_image(overhead_paths[i])
        return resize_host(tile[..., : d.channels], size, size)

    embeds, sat_frac = embed_tiles(pipeline, params["overhead"], read_tile, n, batch_size, int8,
                                   context="gallery")

    meta = {
        "precision": "int8" if int8 else "f32",
        "family": family,
        "params_sha": params_fingerprint(params["overhead"]),
        "path": np.asarray(overhead_paths),
    }
    if sat_frac is not None:
        meta["int8_saturation"] = sat_frac
    if meta_cols:
        meta.update(read_meta_cols(csv_path, d.dataset.header, meta_cols))

    index_cls = VectorIndex if family in VECTOR_FAMILIES else GalleryIndex
    index = index_cls(embeds, meta=meta, device=pipeline.device)
    if out_path:
        index.save(out_path)
        if verbose:
            print(f"embedded {n} tiles -> {out_path}")
    return index


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--csv", required=True, help="dataset CSV (either schema)")
    parser.add_argument("--out", required=True,
                        help="output index .npz (GalleryIndex, or VectorIndex for --family safa "
                             "and baseline)")
    parser.add_argument("--dataset", default="witw", choices=["cvusa", "witw"])
    parser.add_argument("--fov", type=int, default=70)
    parser.add_argument("--weights", default="./weights")
    parser.add_argument("--tag", default=None)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--int8", action="store_true", help="embed with the static-int8 towers")
    parser.add_argument("--family", choices=FAMILIES, default="fov",
                        help="tower/index family: fov = FOV-DSM feature-map GalleryIndex "
                             "(default); safa = VGG16+SAFA Euclidean VectorIndex; baseline = "
                             "7-conv GeM towers on raw 750^2 tiles (Euclidean VectorIndex; --fov "
                             "ignored)")
    parser.add_argument("--meta-cols", default=None,
                        help="comma-separated CSV columns to copy into the index meta; "
                             "'src:dst' renames (e.g. lon:x,lat:y for the serving daemon's x/y)")
    args = parser.parse_args(argv)
    return build_index(
        args.csv, args.out, dataset=args.dataset, fov=args.fov,
        checkpoint_dir=args.weights, tag=args.tag,
        batch_size=args.batch_size, int8=args.int8,
        meta_cols=args.meta_cols.split(",") if args.meta_cols else None,
        family=args.family,
    )


if __name__ == "__main__":
    main()
