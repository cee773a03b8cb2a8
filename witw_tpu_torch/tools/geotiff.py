"""Python binding for the native GeoTIFF reader and writer (port of
witw_tpu/tools/geotiff.py: ``native_lib``, ``GeoTiff``, ``write_geotiff_u8``
and ``resample``).

The library is the port's copy of witw_tpu's C++ source
(``witw_tpu_torch/native/geotiff_io.cpp``), compiled by g++ at first use
into ``witw_tpu_torch/_build/`` under a name that carries a hash of the
source and the flags, and loaded with ctypes. There is no fallback: a
failed build raises with the compiler's output, a file the reader cannot
open raises, and every read, write and resample runs through the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from witw_tpu_torch.kernels.build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR / "native" / "geotiff_io.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-shared")
LINK_FLAGS = ("-lz",)


def build_native(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` unless its hashed library exists; returns the
    library's path. The library is written under a temporary name and
    renamed, so a process building it beside another never loads half a
    file. RuntimeError, with the compiler's output, when the build fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    digest.update(Path(source).read_bytes())
    path = Path(build_dir) / f"libgeotiff_io_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native GeoTIFF library cannot be built")
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", tmp, *LINK_FLAGS],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"building {source} failed ({out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_long, c_int, c_double, c_void_p = ctypes.c_long, ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    lib.gt_open.restype = c_void_p
    lib.gt_open.argtypes = [ctypes.c_char_p]
    lib.gt_close.restype = None
    lib.gt_close.argtypes = [c_void_p]
    for fn in ("gt_width", "gt_height"):
        getattr(lib, fn).restype = c_long
        getattr(lib, fn).argtypes = [c_void_p]
    for fn in ("gt_bands", "gt_bits", "gt_epsg", "gt_has_geo"):
        getattr(lib, fn).restype = c_int
        getattr(lib, fn).argtypes = [c_void_p]
    lib.gt_geotransform.restype = c_int
    lib.gt_geotransform.argtypes = [c_void_p, ctypes.POINTER(c_double)]
    lib.gt_read_window.restype = c_int
    lib.gt_read_window.argtypes = [c_void_p, c_long, c_long, c_long, c_long,
                                   ctypes.POINTER(ctypes.c_uint16)]
    lib.gt_write_u8.restype = c_int
    lib.gt_write_u8.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), c_long, c_long,
                                c_int, ctypes.POINTER(c_double), c_int, c_int]
    lib.gt_resample.restype = c_int
    lib.gt_resample.argtypes = [ctypes.POINTER(ctypes.c_float), c_long, c_long, c_int,
                                ctypes.POINTER(ctypes.c_float), c_long, c_long, c_int]
    return lib


@functools.lru_cache(maxsize=None)
def native_lib() -> ctypes.CDLL:
    """The native library, built at first use (RuntimeError if it cannot
    be)."""
    return _declare(ctypes.CDLL(str(build_native())))


class GeoTiff:
    """Windowed GeoTIFF raster with GDAL-free geotransform support."""

    def __init__(self, path: str):
        self.path = path
        self._lib = native_lib()
        handle = self._lib.gt_open(os.fsencode(path))
        if not handle:
            raise IOError(f"the native GeoTIFF reader cannot open {path}")
        self._handle = ctypes.c_void_p(handle)

    def _open_handle(self) -> ctypes.c_void_p:
        if self._handle is None:
            raise ValueError(f"{self.path} is closed")
        return self._handle

    # ---- metadata ----

    @property
    def width(self) -> int:
        return self._lib.gt_width(self._open_handle())

    @property
    def height(self) -> int:
        return self._lib.gt_height(self._open_handle())

    @property
    def bands(self) -> int:
        return self._lib.gt_bands(self._open_handle())

    @property
    def dtype(self):
        return np.uint16 if self._lib.gt_bits(self._open_handle()) == 16 else np.uint8

    @property
    def epsg(self) -> int:
        return self._lib.gt_epsg(self._open_handle())

    @property
    def geotransform(self) -> np.ndarray:
        """GDAL-style affine [x0, dx, 0, y0, 0, dy]."""
        gt = (ctypes.c_double * 6)()
        self._lib.gt_geotransform(self._open_handle(), gt)
        return np.asarray(gt[:], np.float64)

    # ---- IO ----

    def read_window(self, x0: int, y0: int, w: int, h: int) -> np.ndarray:
        """Read a pixel window (clipped; outside = 0) as HWC in native dtype."""
        buf = np.zeros((h, w, self.bands), np.uint16)
        rc = self._lib.gt_read_window(self._open_handle(), x0, y0, w, h,
                                      buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        if rc != 0:
            raise IOError(f"gt_read_window failed on {self.path}")
        return buf.astype(self.dtype)

    def read(self) -> np.ndarray:
        return self.read_window(0, 0, self.width, self.height)

    def world_to_pixel(self, x: float, y: float) -> Tuple[float, float]:
        gt = self.geotransform
        return (x - gt[0]) / gt[1], (y - gt[3]) / gt[5]

    def pixel_to_world(self, px: float, py: float) -> Tuple[float, float]:
        gt = self.geotransform
        return gt[0] + px * gt[1], gt[3] + py * gt[5]

    def read_world_window(self, x_min, y_max, x_max, y_min, out_size=None) -> np.ndarray:
        """Read by world coords (projWin-style: ulx, uly, lrx, lry — the
        reference clips tiles with gdal.Translate(projWin=...),
        sitetiles.py:168-171)."""
        px0, py0 = self.world_to_pixel(x_min, y_max)
        px1, py1 = self.world_to_pixel(x_max, y_min)
        x0, y0 = int(round(px0)), int(round(py0))
        w, h = int(round(px1 - px0)), int(round(py1 - py0))
        tile = self.read_window(x0, y0, max(w, 1), max(h, 1))
        if out_size is not None and (tile.shape[0], tile.shape[1]) != out_size:
            tile = resample(tile.astype(np.float32), out_size[0], out_size[1]).astype(self.dtype)
        return tile

    def close(self):
        if self._handle is not None:
            self._lib.gt_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_geotiff_u8(
    path: str,
    data: np.ndarray,
    geotransform: Optional[np.ndarray] = None,
    epsg: int = 0,
    compress: bool = True,
) -> None:
    """Write an HWC uint8 array as a (Geo)TIFF."""
    lib = native_lib()
    data = np.ascontiguousarray(data.astype(np.uint8))
    if data.ndim == 2:
        data = data[..., None]
    h, w, bands = data.shape
    gt_ptr = None
    if geotransform is not None:
        gt_ptr = (ctypes.c_double * 6)(*[float(v) for v in geotransform])
    rc = lib.gt_write_u8(os.fsencode(path), data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         w, h, bands, gt_ptr, epsg, 1 if compress else 0)
    if rc != 0:
        raise IOError(f"gt_write_u8 failed ({rc}) for {path}")


def resample(src: np.ndarray, out_h: int, out_w: int, method: str = "bilinear") -> np.ndarray:
    """Native separable resample (bilinear | lanczos), HWC float32."""
    if method not in ("bilinear", "lanczos"):
        raise ValueError(f"unknown resample method {method!r}")
    lib = native_lib()
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim == 2:
        src = src[..., None]
    h, w, bands = src.shape
    dst = np.zeros((out_h, out_w, bands), np.float32)
    rc = lib.gt_resample(src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h, bands,
                         dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_w, out_h,
                         1 if method == "lanczos" else 0)
    if rc != 0:
        # a swallowed failure (e.g. bad_alloc on the native tmp buffer) would
        # return the untouched all-zero dst as valid pixels
        raise MemoryError(f"gt_resample failed (rc={rc}) at {h}x{w}x{bands} -> {out_h}x{out_w}")
    return dst
