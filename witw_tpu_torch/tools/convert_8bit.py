"""16-bit pansharpened strips -> 8-bit RGB (band-select + rescale) on the
card (port of witw_tpu/tools/convert_8bit.py).

Replaces reference tools/dataset_building/create_8bit_images.py (which shells
out to the gdal_translate binary) with the native windowed reader and the
scaling in PyTorch, on the card unless ``device="cpu"`` is passed:
- band selection/order per AOI (WV-3 PS-MS uses bands [5,3,2], WV-2 AOIs
  [3,2,1] — reference convert_strips.py:14-77),
- per-band rescale from a low/high percentile of *positive* pixels (the
  reference's rescale_type='perc' with 2-98 defaults,
  create_8bit_images.py:85-111), a fixed clip range, or explicit per-band
  ranges,
- optional gamma correction (create_8bit_images.py:163-172),
- skip images whose zero-pixel fraction exceeds a threshold (30%,
  create_8bit_images.py:113-118),
- directory driver (create_8bit_images.py:215-244): a process pool on the
  CPU; on the card the rasters are converted one after another in this
  process, since a forked worker cannot use CUDA.

A percentile is ``np.percentile``'s (linear interpolation between two order
statistics), bit for bit: the order statistics of an integer raster come
from a 65,536-bin histogram (a strip band holds 1e8-1e9 pixels, past
``torch.quantile``'s limit), those of a float raster from a sort, and the
interpolation is numpy's own arithmetic on the host.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from witw_tpu_torch.tools.cities import strip_filename
from witw_tpu_torch.tools.geotiff import GeoTiff, write_geotiff_u8
from witw_tpu_torch.utils.device import resolve_device

# Band orders per satellite product (reference convert_strips.py:14-77):
# the 8 PS-MS AOIs (vegas, paris, shanghai, khartoum, moscow, mumbai, san,
# dar) convert with [5,3,2]; the PS-RGBNIR/merged AOIs (atlanta, rotterdam)
# with [3,2,1]; rio's strip is PRE-PROCESSED RGB and is never converted
# (reference stitches its tiles directly, convert_strips.py:4-5,17-18).
BAND_ORDERS = {
    "wv3_psms": (5, 3, 2),  # 1-based band indices for R, G, B
    "rgbnir": (3, 2, 1),
}

DEFAULT_AOI_BANDS = {
    "rio": None, "vegas": "wv3_psms", "paris": "wv3_psms",
    "shanghai": "wv3_psms", "khartoum": "wv3_psms", "atlanta": "rgbnir",
    "moscow": "wv3_psms", "mumbai": "wv3_psms", "san": "wv3_psms",
    "dar": "wv3_psms", "rotterdam": "rgbnir",
}

# Reference per-band min/max tables ("numbers retrieved from
# all_dems_min_max.py ... over the entirety of SN3",
# create_8bit_images.py:20-36), keyed by 1-based SOURCE band id.
RESCALE_TABLES = {
    "tot_3band": {1: (63, 1178), 2: (158, 1285), 3: (148, 880)},
    "tot_8band": {
        1: (154, 669), 2: (122, 1061), 3: (119, 1520), 4: (62, 1497),
        5: (20, 1342), 6: (36, 1505), 7: (17, 1853), 8: (7, 1559),
    },
}

HISTOGRAM_BINS = 65536  # every uint16 value


def as_tensor(img, device=None) -> torch.Tensor:
    """A raster (numpy or torch) as a tensor on ``device`` (a tensor's own
    device when None and it is one; else the card). uint16 travels as its
    int16 bits and is widened to int32 on the device (bincount and the
    arithmetic need a signed type)."""
    if isinstance(img, torch.Tensor):
        return img if device is None else img.to(device)
    device = resolve_device(device)
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint16:
        return torch.from_numpy(img.view(np.int16)).to(device).to(torch.int32) & 0xFFFF
    return torch.from_numpy(img).to(device)


def _lerp(a, b, t):
    """numpy's linear interpolation of two order statistics
    (numpy/lib/_function_base_impl.py ``_lerp``), with its ``t >= 0.5``
    branch, on 0-d arrays so that every step rounds as numpy's does."""
    diff = np.subtract(b, a)
    out = np.asanyarray(np.add(a, diff * t))
    np.subtract(b, diff * (1 - t), out=out, where=t >= 0.5, casting="unsafe",
                dtype=type(out.dtype))
    return out[()]


def numpy_percentiles(n: int, qs: Sequence[float], dtype,
                      order_stats: Callable[[List[int]], np.ndarray]) -> List:
    """``[np.percentile(a, q) for q in qs]`` for an array ``a`` of ``n``
    values of numpy ``dtype``, given ``order_stats(ks)``: the ks-th smallest
    values of ``a`` (0-based), fetched in one call."""
    dtype = np.dtype(dtype)
    plan = []
    for q in qs:
        vi = np.asanyarray((n - 1) * np.asanyarray(
            np.true_divide(q, dtype.type(100) if dtype.kind == "f" else 100)))
        prev = np.asanyarray(np.floor(vi))
        nxt = np.asanyarray(prev + 1)
        if vi >= n - 1:
            prev, nxt = np.asanyarray(n - 1), np.asanyarray(n - 1)
        elif vi < 0:
            prev, nxt = np.asanyarray(0), np.asanyarray(0)
        prev, nxt = prev.astype(np.intp), nxt.astype(np.intp)
        gamma = np.asanyarray(np.asanyarray(vi - prev), dtype=vi.dtype)
        plan.append((int(prev), int(nxt), gamma))
    stats = np.asarray(order_stats([k for p in plan for k in p[:2]]))
    value_dtype = dtype if dtype.kind == "f" else np.dtype(np.float64)
    stats = stats.astype(value_dtype)
    return [_lerp(stats[2 * i], stats[2 * i + 1], gamma)
            for i, (_, _, gamma) in enumerate(plan)]


def _histogram_stats(values: torch.Tensor):
    """(n, order_stats) of the positive values of an integer tensor from
    its 65,536-bin histogram."""
    counts = torch.bincount(values.reshape(-1).to(torch.int32).clamp_(min=0),
                            minlength=HISTOGRAM_BINS)
    counts[0] = 0  # zeros are nodata
    cum = counts.cumsum(0)
    n = int(cum[-1])

    def order_stats(ks):
        ks = torch.tensor(ks, dtype=cum.dtype, device=cum.device)
        return torch.searchsorted(cum, ks, right=True).cpu().numpy()

    return n, order_stats


def sorted_stats(values: torch.Tensor):
    """(n, order_stats) of a float tensor's values, sorted."""
    ordered = torch.sort(values.reshape(-1)).values
    n = ordered.numel()

    def order_stats(ks):
        return ordered[torch.tensor(ks, device=ordered.device)].cpu().numpy()

    return n, order_stats


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(np.float64) if not t.is_floating_point() else (
        torch.empty(0, dtype=t.dtype).numpy().dtype)


def _positive_percentiles(band: torch.Tensor, low: float, high: float) -> Tuple[float, float]:
    if band.is_floating_point():
        n, order_stats = sorted_stats(band[band > 0])
    elif band.numel() and int(band.max()) >= HISTOGRAM_BINS:
        n, order_stats = sorted_stats(band[band > 0].to(torch.float64))
    else:
        n, order_stats = _histogram_stats(band)
    if n == 0:
        return 0.0, 1.0
    lo, hi = numpy_percentiles(n, (low, high), _numpy_dtype(band), order_stats)
    return float(lo), float(hi)


def band_percentiles(band, low: float = 2.0, high: float = 98.0,
                     device=None) -> Tuple[float, float]:
    """Percentiles over positive pixels only (zeros are nodata,
    reference create_8bit_images.py:97-104), equal to witw_tpu's
    ``np.percentile`` of them."""
    return _positive_percentiles(as_tensor(band, device), low, high)


def rescale_to_u8(
    img,
    rescale: str = "perc",
    fixed_range: Tuple[float, float] = (0.0, 65535.0),
    per_band_ranges: Optional[Dict[int, Tuple[float, float]]] = None,
    percentiles: Tuple[float, float] = (2.0, 98.0),
    gamma: Optional[float] = None,
    device=None,
) -> np.ndarray:
    """HWC raster (numpy or torch) -> uint8 numpy with per-band scaling in
    f64 on ``device``.

    'clip' spans the full 16-bit range like the reference
    (create_8bit_images.py:126-127: bmin, bmax = 0, 65535); 'dict' reads
    ``per_band_ranges`` keyed by the OUTPUT channel index (callers translate
    from the reference's source-band tables, RESCALE_TABLES). The reference
    floors every mode's lo at 1 (create_8bit_images.py:136)."""
    img = as_tensor(img, device)
    out = torch.empty(img.shape, dtype=torch.uint8, device=img.device)
    for b in range(img.shape[2]):
        band = img[..., b]
        if rescale == "perc":
            if band.is_floating_point():
                band = band.to(torch.float64)  # witw_tpu ranks the f64 copy
            lo, hi = _positive_percentiles(band, *percentiles)
        elif rescale == "clip":
            lo, hi = fixed_range
        elif rescale == "dict":
            if per_band_ranges is None or b not in per_band_ranges:
                raise ValueError(
                    f"rescale='dict' needs per_band_ranges for channel {b} "
                    "(see RESCALE_TABLES for the reference's tables)"
                )
            lo, hi = per_band_ranges[b]
        else:
            raise ValueError(rescale)
        lo = max(1.0, float(lo))  # reference: bmin = max(1, bmin)
        if hi <= lo:
            hi = lo + 1.0
        scaled = ((band.to(torch.float64) - lo) / (hi - lo)).clamp_(0.0, 1.0)
        if gamma:
            scaled = scaled.pow_(1.0 / gamma)
        out[..., b] = torch.round(scaled * 255.0).to(torch.uint8)
    return out.cpu().numpy()


def zero_fraction(img, device=None) -> float:
    """Fraction of pixels zero in all bands (reference zero_frac.py:1-17)."""
    img = as_tensor(img, device)
    blank = int((img == 0).all(dim=-1).sum())
    return blank / (img.numel() // img.shape[-1])


def convert_to_8bit(
    src_path: str,
    dst_path: str,
    bands: Sequence[int] = (1, 2, 3),
    rescale: str = "perc",
    gamma: Optional[float] = None,
    max_zero_frac: float = 0.3,
    table: Optional[str] = None,
    device=None,
    **kw,
) -> bool:
    """Convert one raster on ``device`` (the card when None); returns False
    if skipped (too many zero pixels, reference
    create_8bit_images.py:113-118). ``table`` selects a reference per-band
    range table (RESCALE_TABLES, keyed by SOURCE band id) and implies
    rescale='dict'."""
    if table:
        src_ranges = RESCALE_TABLES[table]
        kw["per_band_ranges"] = {i: src_ranges[b] for i, b in enumerate(bands)}
        rescale = "dict"
    device = resolve_device(device)
    with GeoTiff(src_path) as tif:
        img = as_tensor(tif.read(), device)
        sel = img[..., [b - 1 for b in bands]]
        del img
        if zero_fraction(sel) > max_zero_frac:
            return False
        out = rescale_to_u8(sel, rescale=rescale, gamma=gamma, **kw)
        del sel
        write_geotiff_u8(dst_path, out, tif.geotransform, tif.epsg)
    return True


def _convert_job(args):
    return convert_to_8bit(*args[:2], **args[2])


def dir_to_8bit(
    src_dir: str,
    dst_dir: str,
    bands: Sequence[int] = (1, 2, 3),
    n_workers: int = 12,
    device=None,
    **kw,
) -> int:
    """Convert every .tif in a directory (reference
    create_8bit_images.py:215-244). On the card the rasters go one after
    another through this process; on the CPU through a pool of
    ``n_workers`` spawned processes."""
    device = resolve_device(device)
    os.makedirs(dst_dir, exist_ok=True)
    jobs = []
    for name in sorted(os.listdir(src_dir)):
        if not name.lower().endswith((".tif", ".tiff")):
            continue
        jobs.append((os.path.join(src_dir, name), os.path.join(dst_dir, name),
                     dict(bands=bands, device=str(device), **kw)))
    if device.type != "cpu" or n_workers <= 1:
        return sum(bool(_convert_job(j)) for j in jobs)
    with ProcessPoolExecutor(n_workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return sum(bool(ok) for ok in pool.map(_convert_job, jobs))


def convert_strips(src_dir: str, dst_dir: str, device=None) -> int:
    """Per-AOI strip conversion driver with the right band order per
    satellite product (reference tools/dataset_building/convert_strips.py:14-77:
    WV-3 PS-MS strips use bands [5,3,2]; WV-2 AOIs use [3,2,1]). The strips
    go one after another."""
    device = resolve_device(device)
    os.makedirs(dst_dir, exist_ok=True)
    done = 0
    for city, product in DEFAULT_AOI_BANDS.items():
        fn = strip_filename(city)
        src = os.path.join(src_dir, fn)
        if not os.path.exists(src):
            continue
        if product is None:
            # rio's strip is pre-processed RGB — the reference never runs it
            # through conversion (convert_strips.py:17-18); pass it through
            shutil.copyfile(src, os.path.join(dst_dir, fn))
            done += 1
            continue
        if convert_to_8bit(src, os.path.join(dst_dir, fn), bands=BAND_ORDERS[product],
                           device=device):
            done += 1
    return done


def main(argv=None):
    parser = argparse.ArgumentParser(description="16-bit -> 8-bit RGB conversion")
    parser.add_argument("--src", required=True, help="source file or directory")
    parser.add_argument("--dst", required=True)
    parser.add_argument("--bands", type=int, nargs=3, default=(1, 2, 3),
                        help="1-based R G B band indices")
    parser.add_argument("--rescale",
                        choices=["perc", "clip", "tot_3band", "tot_8band"],
                        default="perc",
                        help="perc = 2-98 percentile of positive pixels; "
                             "clip = full 16-bit range; tot_3band/tot_8band "
                             "= the reference's fixed per-band SN3 tables")
    parser.add_argument("--gamma", type=float, default=None)
    parser.add_argument("--workers", type=int, default=12,
                        help="processes for a directory on the CPU")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run on the host)")
    args = parser.parse_args(argv)
    table = args.rescale if args.rescale in RESCALE_TABLES else None
    rescale = "dict" if table else args.rescale
    if os.path.isdir(args.src):
        n = dir_to_8bit(args.src, args.dst, args.bands, args.workers, device=args.device,
                        rescale=rescale, gamma=args.gamma, table=table)
        print(f"converted {n} rasters")
    else:
        ok = convert_to_8bit(args.src, args.dst, args.bands, rescale=rescale,
                             gamma=args.gamma, table=table, device=args.device)
        print("converted" if ok else "skipped (zero fraction)")


if __name__ == "__main__":
    main()
