"""Raster reprojection to UTM at fixed ground resolution, on the card (port
of witw_tpu/tools/reproject.py).

Replaces reference tools/dataset_building/reproject_strips.py (which shells
out ``gdalwarp -t_srs EPSG:<utm> -tr .3 .3 -r lanczos``): inverse-mapped warp
using the Krüger series and Lanczos-3 sampling. The source raster may be in
geographic WGS84 (EPSG:4326) or another UTM zone; each destination pixel is
inverse-projected to source coordinates and sampled. The destination is
warped block by block over windowed reads of the source, as witw_tpu's loop
does; each block's geodesy and its 6 x 6 Lanczos taps run in f64 on
``device`` (the card unless ``device="cpu"``): at 48.9 degrees an f32
latitude's ulp (~0.4 m) is more than one 0.3 m pixel.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from witw_tpu_torch.tools.cities import CITIES, strip_filename
from witw_tpu_torch.tools.geotiff import GeoTiff, utm_to_wgs84, wgs84_to_utm, write_geotiff_u8
from witw_tpu_torch.utils.device import resolve_device

F64 = torch.float64


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    px = math.pi * x
    out = torch.where((x.abs() < 3) & (x != 0),
                      3.0 * torch.sin(px) * torch.sin(px / 3.0) / (px * px), 0.0)
    return torch.where(x == 0, 1.0, out)


def _sample_lanczos(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample img (HWC, f32) at f64 coords (xs, ys) with a 6x6 Lanczos3
    kernel; f64 out. The taps are summed in witw_tpu's order (dy outer,
    dx inner)."""
    h, w, c = img.shape
    flat = img.reshape(h * w, c)
    x0 = torch.floor(xs).long()
    y0 = torch.floor(ys).long()
    wxs = [_lanczos3(xs - (x0 + dx)) for dx in range(-2, 4)]
    xxs = [torch.clamp(x0 + dx, 0, w - 1) for dx in range(-2, 4)]
    acc = torch.zeros((*xs.shape, c), dtype=F64, device=xs.device)
    wsum = torch.zeros(xs.shape, dtype=F64, device=xs.device)
    for dy in range(-2, 4):
        wy = _lanczos3(ys - (y0 + dy))
        row = torch.clamp(y0 + dy, 0, h - 1) * w
        for wx, xx in zip(wxs, xxs):
            wgt = wx * wy
            acc += wgt[..., None] * flat[row + xx]
            wsum += wgt
    return acc / torch.clamp(wsum, min=1e-12)[..., None]


# Vectorized Krüger-series transforms — same math as the native geodesy
# (geotiff_io.cpp) and witw_tpu's numpy copy, in f64 torch ops.
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E0 = 500000.0
_N = _F / (2.0 - _F)
_DEG = 180.0 / math.pi  # numpy's degrees / radians factors
_RAD = math.pi / 180.0


def _utm_to_wgs84_vec(e: torch.Tensor, n: torch.Tensor, epsg: int):
    north = 32600 <= epsg < 32700
    zone = epsg - (32600 if north else 32700)
    nn = _N
    big_a = _A / (1 + nn) * (1 + nn**2 / 4 + nn**4 / 64)
    y = n.to(F64) - (0.0 if north else 10000000.0)
    xi = y / (_K0 * big_a)
    eta = (e.to(F64) - _E0) / (_K0 * big_a)
    beta = [0, nn / 2 - 2 * nn**2 / 3 + 37 * nn**3 / 96, nn**2 / 48 + nn**3 / 15, 17 * nn**3 / 480]
    xi_p, eta_p = xi.clone(), eta.clone()
    for j in (1, 2, 3):
        xi_p -= beta[j] * torch.sin(2 * j * xi) * torch.cosh(2 * j * eta)
        eta_p -= beta[j] * torch.cos(2 * j * xi) * torch.sinh(2 * j * eta)
    chi = torch.asin(torch.sin(xi_p) / torch.cosh(eta_p))
    lat = chi.clone()
    delta = [0, 2 * nn - 2 * nn**2 / 3 - 2 * nn**3, 7 * nn**2 / 3 - 8 * nn**3 / 5, 56 * nn**3 / 15]
    for j in (1, 2, 3):
        lat += delta[j] * torch.sin(2 * j * chi)
    lon0 = zone * 6.0 - 183.0
    return lat * _DEG, lon0 + torch.atan2(torch.sinh(eta_p), torch.cos(xi_p)) * _DEG


def _wgs84_to_utm_vec(lat: torch.Tensor, lon: torch.Tensor, epsg: int):
    north = 32600 <= epsg < 32700
    zone = epsg - (32600 if north else 32700)
    nn = _N
    lat_r = lat.to(F64) * _RAD
    lon_r = lon.to(F64) * _RAD - math.radians(zone * 6 - 183)
    s = torch.sin(lat_r)
    t = torch.sinh(torch.atanh(s) - 2 * math.sqrt(nn) / (1 + nn)
                   * torch.atanh(2 * math.sqrt(nn) / (1 + nn) * s))
    xi = torch.atan2(t, torch.cos(lon_r))
    eta = torch.atanh(torch.sin(lon_r) / torch.sqrt(1 + t * t))
    big_a = _A / (1 + nn) * (1 + nn**2 / 4 + nn**4 / 64)
    alpha = [0, nn / 2 - 2 * nn**2 / 3 + 5 * nn**3 / 16, 13 * nn**2 / 48 - 3 * nn**3 / 5,
             61 * nn**3 / 240]
    xi_s, eta_s = xi.clone(), eta.clone()
    for j in (1, 2, 3):
        xi_s += alpha[j] * torch.sin(2 * j * xi) * torch.cosh(2 * j * eta)
        eta_s += alpha[j] * torch.cos(2 * j * xi) * torch.sinh(2 * j * eta)
    easting = _E0 + _K0 * big_a * eta_s
    northing = _K0 * big_a * xi_s + (0.0 if north else 10000000.0)
    return easting, northing


@dataclasses.dataclass(frozen=True)
class UtmGrid:
    """The destination grid: its upper-left corner (e_min, n_max), size
    and pixel size in metres, in UTM ``epsg``."""
    epsg: int
    e_min: float
    n_max: float
    width: int
    height: int
    resolution: float

    @property
    def geotransform(self) -> np.ndarray:
        return np.array([self.e_min, self.resolution, 0.0, self.n_max, 0.0, -self.resolution])


def utm_grid(src: GeoTiff, dst_epsg: int, resolution: float = 0.3) -> UtmGrid:
    """The UTM grid covering the source raster's projected corners."""
    corners = []
    for px, py in [(0, 0), (src.width, 0), (0, src.height), (src.width, src.height)]:
        x, y = src.pixel_to_world(px, py)
        if src.epsg in (0, 4326):
            lon, lat = x, y
        else:
            lat, lon = utm_to_wgs84(x, y, src.epsg)
        # epsg= pins zone AND hemisphere to the destination grid: a
        # northern-grid strip dipping below the equator must not get
        # +10,000,000 m false northing on its southern corners
        e, n, _ = wgs84_to_utm(lat, lon, epsg=dst_epsg)
        corners.append((e, n))
    es = [c[0] for c in corners]
    ns = [c[1] for c in corners]
    e_min, e_max = min(es), max(es)
    n_min, n_max = min(ns), max(ns)
    return UtmGrid(dst_epsg, e_min, n_max, int(math.ceil((e_max - e_min) / resolution)),
                   int(math.ceil((n_max - n_min) / resolution)), resolution)


@torch.no_grad()
def warp_block(src: GeoTiff, grid: UtmGrid, bx: int, by: int, bw: int, bh: int,
               resample: str = "lanczos", device=None) -> Optional[np.ndarray]:
    """The destination block of bh x bw pixels at (by, bx), uint8 HWC, or
    None where its source window lies off the raster (the block stays
    zero)."""
    device = resolve_device(device)
    gt = [float(v) for v in src.geotransform]
    jj = torch.arange(bw, dtype=F64, device=device)[None, :].expand(bh, bw)
    ii = torch.arange(bh, dtype=F64, device=device)[:, None].expand(bh, bw)
    easting = grid.e_min + (bx + jj + 0.5) * grid.resolution
    northing = grid.n_max - (by + ii + 0.5) * grid.resolution
    # dst UTM -> WGS84 -> source pixel coords
    lat, lon = _utm_to_wgs84_vec(easting, northing, grid.epsg)
    if src.epsg in (0, 4326):
        sx = (lon - gt[0]) / gt[1]
        sy = (lat - gt[3]) / gt[5]
    else:
        se, sn = _wgs84_to_utm_vec(lat, lon, src.epsg)
        sx = (se - gt[0]) / gt[1]
        sy = (sn - gt[3]) / gt[5]
    # Windowed source read covering this block's sample coords plus the
    # 6-tap Lanczos support; clipping the window to the raster keeps the
    # kernel's coordinate clamp equal to a whole-image edge replicate.
    bounds = torch.stack([sx.min(), sx.max(), sy.min(), sy.max()]).cpu().numpy()
    cx = np.clip(bounds[:2], -4.0, src.width + 4.0)
    cy = np.clip(bounds[2:], -4.0, src.height + 4.0)
    x0 = max(0, int(math.floor(cx[0])) - 3)
    x1 = min(src.width, int(math.ceil(cx[1])) + 4)
    y0 = max(0, int(math.floor(cy[0])) - 3)
    y1 = min(src.height, int(math.ceil(cy[1])) + 4)
    if x0 >= x1 or y0 >= y1:
        return None
    win = torch.from_numpy(src.read_window(x0, y0, x1 - x0, y1 - y0).astype(np.float32)).to(device)
    lx, ly = sx - x0, sy - y0
    if resample == "lanczos":
        vals = _sample_lanczos(win, lx, ly)
    else:
        xi = torch.clamp(torch.round(lx).long(), 0, win.shape[1] - 1)
        yi = torch.clamp(torch.round(ly).long(), 0, win.shape[0] - 1)
        vals = win[yi, xi]
    inside = (sx >= -0.5) & (sx < src.width - 0.5) & (sy >= -0.5) & (sy < src.height - 0.5)
    vals = torch.where(inside[..., None], vals, 0)
    return torch.clamp(torch.round(vals), 0, 255).to(torch.uint8).cpu().numpy()


def reproject_to_utm(
    src_path: str,
    dst_path: str,
    dst_epsg: int,
    resolution: float = 0.3,
    block: int = 2048,
    resample: str = "lanczos",
    device=None,
) -> UtmGrid:
    """Warp a WGS84 (EPSG:4326) or UTM raster to a UTM grid at
    ``resolution`` m/px on ``device`` (the card when None); returns the
    grid written."""
    device = resolve_device(device)
    with GeoTiff(src_path) as src:
        grid = utm_grid(src, dst_epsg, resolution)
        out = np.zeros((grid.height, grid.width, src.bands), np.uint8)
        for by in range(0, grid.height, block):
            for bx in range(0, grid.width, block):
                bw = min(block, grid.width - bx)
                bh = min(block, grid.height - by)
                tile = warp_block(src, grid, bx, by, bw, bh, resample, device)
                if tile is not None:
                    out[by:by + bh, bx:bx + bw] = tile
    write_geotiff_u8(dst_path, out, grid.geotransform, dst_epsg)
    return grid


def reproject_strips(src_dir: str, dst_dir: str, resolution: float = 0.3, device=None):
    """Per-city driver (reference reproject_strips.py:39-54)."""
    device = resolve_device(device)
    os.makedirs(dst_dir, exist_ok=True)
    for name, city in CITIES.items():
        fn = strip_filename(name)
        src = os.path.join(src_dir, fn)
        if not os.path.exists(src):
            continue
        reproject_to_utm(src, os.path.join(dst_dir, fn), city.epsg, resolution, device=device)
        print(f"reprojected {fn} -> EPSG:{city.epsg}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Reproject strips to UTM")
    parser.add_argument("--src-dir", required=True)
    parser.add_argument("--dst-dir", required=True)
    parser.add_argument("--resolution", type=float, default=0.3)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run on the host)")
    args = parser.parse_args(argv)
    reproject_strips(args.src_dir, args.dst_dir, args.resolution, args.device)


if __name__ == "__main__":
    main()
