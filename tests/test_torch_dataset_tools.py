"""The port's dataset-construction tools (witw_tpu_torch.tools: geotiff's
UTM transforms, convert_8bit, zero_frac, reproject, filter_csv, density,
tiles, modify, semantic_masks, build_dataset) against witw_tpu's on the same
seeded inputs and files, on the CPU (``device="cpu"``), at small sizes.

Tolerances: percentiles, 8-bit rasters without gamma, tiles, CSVs (their
bytes, and their frames as pandas reads them), density and modify are
equal; with gamma within 1 on <= 1e-4 of the pixels; reprojection equal
except where witw_tpu's unrounded value is within 1e-6 of a .5 tie, the
geodesy within 1e-6 m and 1e-10 degrees; the heuristic road mask within
atol 2e-4 of cv2's (its uint8 within 1 on <= 0.5% of the pixels), the
checkpoint masks equal.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import importlib.util
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from witw_tpu.tools import build_dataset as jbd
from witw_tpu.tools import convert_8bit as j8
from witw_tpu.tools import density as jden
from witw_tpu.tools import filter_csv as jfilt
from witw_tpu.tools import geotiff as jgt
from witw_tpu.tools import modify as jmod
from witw_tpu.tools import reproject as jrep
from witw_tpu.tools import semantic_masks as jsem
from witw_tpu.tools import tiles as jtiles
from witw_tpu.tools import zero_frac as jzf
from witw_tpu_torch.configs import fov_experiment
from witw_tpu_torch.data.csv_registry import read_table, table_len, write_table
from witw_tpu_torch.tools import build_dataset as tbd
from witw_tpu_torch.tools import convert_8bit as t8
from witw_tpu_torch.tools import density as tden
from witw_tpu_torch.tools import filter_csv as tfilt
from witw_tpu_torch.tools import geotiff as tgt
from witw_tpu_torch.tools import modify as tmod
from witw_tpu_torch.tools import parity as tparity
from witw_tpu_torch.tools import reproject as trep
from witw_tpu_torch.tools import semantic_masks as tsem
from witw_tpu_torch.tools import tiles as ttiles
from witw_tpu_torch.tools import zero_frac as tzf

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
PARIS = (48.8566, 2.3522)
GTF = np.array([447000.0, 0.3, 0.0, 5411000.0, 0.0, -0.3])


def _smoke():
    """chip_smoke.py (for its uint16 GeoTIFF writer), loaded by path."""
    spec = importlib.util.spec_from_file_location("_chip_smoke_for_tests", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def write_u16():
    smoke = _smoke()

    def write(path, data, gt, epsg):
        data = np.asarray(data, np.uint16)
        smoke.write_tiff_u16(str(path), [data], data.shape[0], data.shape[1], data.shape[2],
                             np.asarray(gt, np.float64), epsg, rows_per_strip=7)
    return write


def _table(frame: pd.DataFrame):
    """A pandas frame as the port's table (object columns stay objects)."""
    return {c: frame[c].to_numpy(dtype=None if frame[c].dtype.kind in "fiub" else object)
            for c in frame.columns}


def _same_csv(a, b):
    assert Path(a).read_bytes() == Path(b).read_bytes()
    pd.testing.assert_frame_equal(pd.read_csv(a), pd.read_csv(b))


# ---------------------------------------------------------------- geodesy


@pytest.mark.parametrize("lat, lon, kw", [
    (48.8566, 2.3522, {}), (-6.8, 39.27, {}), (0.0005, 2.99, {"epsg": 32731}),
    (51.9, 4.4, {"zone": 32}), (36.1, -115.2, {"epsg": 32611}), (-22.9, -43.2, {}),
])
def test_utm_transforms_bit_equal(lat, lon, kw):
    want = jgt.wgs84_to_utm(lat, lon, **kw)
    got = tgt.wgs84_to_utm(lat, lon, **kw)
    assert got == want
    assert tgt.utm_to_wgs84(got[0], got[1], got[2]) == jgt.utm_to_wgs84(*want)


@pytest.mark.parametrize("epsg", [32631, 32737])
def test_vectorized_geodesy_within_tolerance(rng, epsg):
    e = rng.uniform(300000, 700000, 2000)
    n = rng.uniform(5.2e6, 5.6e6, 2000) if epsg // 100 == 326 else rng.uniform(9.1e6, 9.3e6, 2000)
    lat, lon = jrep._utm_to_wgs84_vec(e, n, epsg)
    lat_t, lon_t = trep._utm_to_wgs84_vec(torch.tensor(e), torch.tensor(n), epsg)
    assert np.abs(lat_t.numpy() - lat).max() <= 1e-10
    assert np.abs(lon_t.numpy() - lon).max() <= 1e-10
    e_j, n_j = jrep._wgs84_to_utm_vec(lat, lon, epsg)
    e_t, n_t = trep._wgs84_to_utm_vec(torch.tensor(lat), torch.tensor(lon), epsg)
    assert np.abs(e_t.numpy() - e_j).max() <= 1e-6
    assert np.abs(n_t.numpy() - n_j).max() <= 1e-6


def test_background_writes_write_every_file_and_raise_a_failure(tmp_path, rng, monkeypatch):
    tiles = [rng.integers(0, 255, (9, 11, 3), dtype=np.uint8) for _ in range(40)]
    monkeypatch.setattr(tgt, "WRITE_THREADS", 3)  # 40 files, at most 6 in flight
    with tgt.background_writes() as write:
        for i, tile in enumerate(tiles):
            write(str(tmp_path / f"{i}.tif"), tile, GTF, 32631)
    for i, tile in enumerate(tiles):
        with tgt.GeoTiff(str(tmp_path / f"{i}.tif")) as tif:
            np.testing.assert_array_equal(tif.read(), tile)
    monkeypatch.setattr(tgt, "WRITE_THREADS", 2)
    with pytest.raises(IOError, match="gt_write_u8 failed"):
        with tgt.background_writes() as write:
            write(str(tmp_path / "no_such_dir" / "x.tif"), tiles[0])
            write(str(tmp_path / "ok.tif"), tiles[1])
    assert (tmp_path / "ok.tif").exists()


# ---------------------------------------------------------------- 8-bit


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32, np.float64])
def test_band_percentiles_bit_equal(rng, dtype):
    for n in (1, 2, 7, 1000, 4097):
        if np.dtype(dtype).kind == "u":
            band = rng.integers(0, 256 if dtype == np.uint8 else 65536, n).astype(dtype)
        else:
            band = rng.uniform(-50, 4000, n).astype(dtype)
        band[rng.random(n) < 0.2] = 0
        for q in ((2.0, 98.0), (0.0, 100.0), (50.0, 50.5), (33.3, 97)):
            assert t8.band_percentiles(band, *q, device=CPU) == j8.band_percentiles(band, *q)
    assert t8.band_percentiles(np.zeros(9, dtype), device=CPU) == (0.0, 1.0)


def _raster(rng, shape=(61, 53, 3), high=4000):
    img = rng.integers(0, high, shape).astype(np.uint16)
    img[:7] = 0
    return img


@pytest.mark.parametrize("kw", [
    {}, {"rescale": "clip"}, {"rescale": "clip", "fixed_range": (100.0, 3000.0)},
    {"rescale": "dict", "per_band_ranges": {0: (20, 1342), 1: (119, 1520), 2: (122, 1061)}},
    {"percentiles": (5.0, 95.0)}, {"float": True},
], ids=["perc", "clip", "clip-range", "dict", "perc-5-95", "float-perc"])
def test_rescale_to_u8_bit_equal(rng, kw):
    kw = dict(kw)
    img = _raster(rng)
    if kw.pop("float", False):
        img = img.astype(np.float64) + rng.random(img.shape)
    np.testing.assert_array_equal(t8.rescale_to_u8(img, device=CPU, **kw),
                                  j8.rescale_to_u8(img, **kw))


def test_rescale_gamma_within_one(rng):
    img = _raster(rng, (256, 256, 3))
    want = j8.rescale_to_u8(img, gamma=2.2).astype(int)
    got = t8.rescale_to_u8(img, gamma=2.2, device=CPU).astype(int)
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() <= 1e-4


def test_zero_fraction_and_tables_equal(rng):
    img = _raster(rng)
    img[10:12, :, 1] = 0  # zero in one band only: not blank
    assert t8.zero_fraction(img, device=CPU) == j8.zero_fraction(img)
    assert t8.BAND_ORDERS == j8.BAND_ORDERS
    assert t8.DEFAULT_AOI_BANDS == j8.DEFAULT_AOI_BANDS
    assert t8.RESCALE_TABLES == j8.RESCALE_TABLES
    with pytest.raises(ValueError, match="per_band_ranges"):
        t8.rescale_to_u8(img, rescale="dict", device=CPU)


@pytest.mark.parametrize("kw", [{}, {"table": "tot_8band"}, {"rescale": "clip"},
                                {"gamma": 2.0}], ids=["perc", "table", "clip", "gamma"])
def test_convert_to_8bit_files_match(tmp_path, rng, write_u16, kw):
    src = tmp_path / "strip.tif"
    write_u16(src, _raster(rng, (50, 47, 8)), GTF, 32631)
    assert tgt.GeoTiff(str(src)).dtype == np.uint16
    for pkg, out in ((j8, "j.tif"), (t8, "t.tif")):
        extra = {"device": CPU} if pkg is t8 else {}
        assert pkg.convert_to_8bit(str(src), str(tmp_path / out), bands=(5, 3, 2), **kw, **extra)
    with tgt.GeoTiff(str(tmp_path / "j.tif")) as a, tgt.GeoTiff(str(tmp_path / "t.tif")) as b:
        assert (a.epsg, list(a.geotransform)) == (b.epsg, list(b.geotransform)) == (32631, list(GTF))
        want, got = a.read().astype(int), b.read().astype(int)
    if "gamma" in kw:
        assert np.abs(got - want).max() <= 1 and (got != want).mean() <= 1e-4
    else:
        np.testing.assert_array_equal(got, want)
    blank = tmp_path / "blank.tif"
    write_u16(blank, np.zeros((20, 20, 8)), GTF, 32631)
    assert not t8.convert_to_8bit(str(blank), str(tmp_path / "b.tif"), device=CPU)
    assert not j8.convert_to_8bit(str(blank), str(tmp_path / "b.tif"))


def test_dir_to_8bit_and_convert_strips_match(tmp_path, rng, write_u16):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("03_paris.tif", "06_atlanta.tif"):
        write_u16(src / name, _raster(rng, (31, 29, 8)), GTF, 32631)
    jgt.write_geotiff_u8(str(src / "01_rio.tif"), rng.integers(0, 255, (9, 8, 3), dtype=np.uint8))
    assert t8.convert_strips(str(src), str(tmp_path / "ts"), device=CPU) == \
        j8.convert_strips(str(src), str(tmp_path / "js")) == 3
    for name in ("03_paris.tif", "06_atlanta.tif", "01_rio.tif"):
        assert (tmp_path / "ts" / name).read_bytes() == (tmp_path / "js" / name).read_bytes()
    # the CPU's process pool (spawned workers) against witw_tpu in one process
    os.unlink(src / "01_rio.tif")
    (src / "notes.txt").write_text("not a raster")
    assert t8.dir_to_8bit(str(src), str(tmp_path / "td"), (5, 3, 2), n_workers=2, device=CPU) == \
        j8.dir_to_8bit(str(src), str(tmp_path / "jd"), (5, 3, 2), n_workers=1) == 2
    for name in ("03_paris.tif", "06_atlanta.tif"):
        assert (tmp_path / "td" / name).read_bytes() == (tmp_path / "jd" / name).read_bytes()


def test_zero_frac_cli_matches(tmp_path, rng, capsys):
    path = tmp_path / "z.tif"
    img = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    img[:5] = 0
    jgt.write_geotiff_u8(str(path), img)
    jzf.main([str(path)])
    want = capsys.readouterr().out
    tzf.main([str(path), "--device", CPU])
    assert capsys.readouterr().out == want == f"{5 / 20:.6f} {path}\n"


# ---------------------------------------------------------------- reprojection


def _geo_raster(tmp_path, rng, name, h, w, epsg):
    """A uint8 raster of about 0.3 m pixels near Paris (or Dar es Salaam for
    a southern EPSG) in ``epsg`` (4326 or UTM)."""
    lat, lon = PARIS if epsg in (4326, 32631, 32632) else (-6.8, 39.27)
    if epsg == 4326:
        gt = [lon, 0.3 / (111320 * math.cos(math.radians(lat))), 0, lat, 0, -0.3 / 111132]
    else:
        e, n, _ = jgt.wgs84_to_utm(lat, lon, epsg=epsg)
        gt = [e, 0.3, 0, n, 0, -0.3]
    path = str(tmp_path / name)
    jgt.write_geotiff_u8(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                         np.array(gt), epsg)
    return path


def _witw_unrounded(src_path, dst_epsg, resolution=0.3):
    """witw_tpu's Lanczos values before rounding, over the whole destination
    as one block (witw_tpu/tools/reproject.py's loop body)."""
    with jgt.GeoTiff(src_path) as src:
        gt = src.geotransform
        corners = []
        for px, py in [(0, 0), (src.width, 0), (0, src.height), (src.width, src.height)]:
            x, y = src.pixel_to_world(px, py)
            lat, lon = (y, x) if src.epsg in (0, 4326) else jgt.utm_to_wgs84(x, y, src.epsg)
            corners.append(jgt.wgs84_to_utm(lat, lon, epsg=dst_epsg)[:2])
        e_min = min(c[0] for c in corners)
        n_max = max(c[1] for c in corners)
        out_w = int(math.ceil((max(c[0] for c in corners) - e_min) / resolution))
        out_h = int(math.ceil((n_max - min(c[1] for c in corners)) / resolution))
        jj, ii = np.meshgrid(np.arange(out_w), np.arange(out_h))
        lat, lon = jrep._utm_to_wgs84_vec(e_min + (jj + 0.5) * resolution,
                                          n_max - (ii + 0.5) * resolution, dst_epsg)
        if src.epsg in (0, 4326):
            sx, sy = (lon - gt[0]) / gt[1], (lat - gt[3]) / gt[5]
        else:
            se, sn = jrep._wgs84_to_utm_vec(lat, lon, src.epsg)
            sx, sy = (se - gt[0]) / gt[1], (sn - gt[3]) / gt[5]
        vals = jrep._sample_lanczos(src.read().astype(np.float32), sx, sy)
        inside = (sx >= -0.5) & (sx < src.width - 0.5) & (sy >= -0.5) & (sy < src.height - 0.5)
        return np.where(inside[..., None], vals, 0)


@pytest.mark.parametrize("src_epsg, dst_epsg", [(4326, 32631), (32632, 32631), (4326, 32737)],
                         ids=["wgs84", "utm-zone-32", "south"])
def test_reproject_matches_witw(tmp_path, rng, src_epsg, dst_epsg):
    src = _geo_raster(tmp_path, rng, "src.tif", 70, 83, src_epsg)
    jrep.reproject_to_utm(src, str(tmp_path / "j.tif"), dst_epsg)
    grid = trep.reproject_to_utm(src, str(tmp_path / "t.tif"), dst_epsg, device=CPU)
    with tgt.GeoTiff(str(tmp_path / "j.tif")) as a, tgt.GeoTiff(str(tmp_path / "t.tif")) as b:
        assert (a.width, a.height, a.epsg) == (b.width, b.height, b.epsg) == \
            (grid.width, grid.height, dst_epsg)
        np.testing.assert_array_equal(a.geotransform, b.geotransform)
        want, got = a.read(), b.read()
    vals = _witw_unrounded(src, dst_epsg)
    np.testing.assert_array_equal(np.clip(np.round(vals), 0, 255).astype(np.uint8), want)
    tie = np.abs(np.abs(vals - np.floor(vals)) - 0.5) <= 1e-6
    off = got != want
    assert not (off & ~tie).any()
    assert np.abs(got.astype(int) - want).max() <= 1


def test_reproject_blocks_and_nearest_match(tmp_path, rng):
    """Blocks smaller than the destination (windows read per block, a block
    off the raster) give the one-block result; nearest sampling is equal."""
    src = _geo_raster(tmp_path, rng, "src.tif", 60, 150, 4326)
    trep.reproject_to_utm(src, str(tmp_path / "one.tif"), 32631, device=CPU)
    trep.reproject_to_utm(src, str(tmp_path / "blocks.tif"), 32631, block=32, device=CPU)
    with tgt.GeoTiff(str(tmp_path / "one.tif")) as a, tgt.GeoTiff(str(tmp_path / "blocks.tif")) as b:
        np.testing.assert_array_equal(a.read(), b.read())
    jrep.reproject_to_utm(src, str(tmp_path / "jn.tif"), 32631, block=32, resample="nearest")
    trep.reproject_to_utm(src, str(tmp_path / "tn.tif"), 32631, block=32, resample="nearest",
                          device=CPU)
    assert (tmp_path / "jn.tif").read_bytes() == (tmp_path / "tn.tif").read_bytes()
    with tgt.GeoTiff(src) as s:
        grid = trep.utm_grid(s, 32631)
        far = trep.UtmGrid(32631, grid.e_min + 1e5, grid.n_max, 16, 16, 0.3)
        assert trep.warp_block(s, far, 0, 0, 16, 16, device=CPU) is None


def test_reproject_strips_driver_matches(tmp_path, rng, capsys):
    (tmp_path / "src").mkdir()
    src = _geo_raster(tmp_path / "src", rng, "03_paris.tif", 40, 45, 4326)
    jrep.reproject_strips(str(tmp_path / "src"), str(tmp_path / "j"))
    trep.reproject_strips(str(tmp_path / "src"), str(tmp_path / "t"), device=CPU)
    out = capsys.readouterr().out
    assert out.count("reprojected 03_paris.tif -> EPSG:32631") == 2
    with tgt.GeoTiff(str(tmp_path / "j/03_paris.tif")) as a, \
            tgt.GeoTiff(str(tmp_path / "t/03_paris.tif")) as b:
        want, got = a.read(), b.read()
    vals = _witw_unrounded(src, 32631)
    tie = np.abs(np.abs(vals - np.floor(vals)) - 0.5) <= 1e-6
    assert not ((got != want) & ~tie).any()


# ---------------------------------------------------------------- tables


def test_table_csv_round_trip_matches_pandas(tmp_path):
    frame = pd.DataFrame({
        "i": [1, -2, 3], "f": [0.1, np.nan, 1e16], "s": ["a,b", "", 'q"'],
        "b": [True, False, True], "mixed": ["7", "x", "1.5"], "ints_as_floats": [1.0, 2.0, np.nan],
    })
    frame.to_csv(tmp_path / "pd.csv", index=False)
    table = read_table(str(tmp_path / "pd.csv"))
    assert {k: v.dtype.kind for k, v in table.items()} == \
        {"i": "i", "f": "f", "s": "O", "b": "b", "mixed": "O", "ints_as_floats": "f"}
    write_table(str(tmp_path / "port.csv"), table)
    _same_csv(tmp_path / "pd.csv", tmp_path / "port.csv")
    assert table_len(table) == 3


# ---------------------------------------------------------------- tiles


def _write_metadata(root, city, records):
    d = Path(root) / city
    d.mkdir(parents=True, exist_ok=True)
    (d / "metadata.json").write_text(json.dumps(records))


def _records(rng, n, lat0, lon0, start=0):
    out = []
    for i in range(start, start + n):
        rec = {"id": str(1000 + i), "owner": f"owner {i}", "title": f"t, \"{i}\" é",
               "datetaken": "2019-06-01 12:00:00", "latitude": f"{lat0 + rng.uniform(-5e-4, 5e-4):.7f}",
               "longitude": lon0 + float(rng.uniform(-5e-4, 5e-4)), "accuracy": int(rng.integers(10, 17)),
               "license": int(rng.integers(1, 9))}
        if i % 3:
            rec["url_o"] = f"http://x/{1000 + i}_o.jpg"
        if i % 2:
            rec["url_m"] = f"http://x/{1000 + i}_m.jpg"
        if i % 5 == 0:
            del rec["owner"]
        out.append(rec)
    return out


def test_build_csv_matches_witw(tmp_path, rng):
    root = tmp_path / "meta"
    _write_metadata(root, "paris", _records(rng, 7, *PARIS))
    _write_metadata(root, "vegas", _records(rng, 4, 36.17, -115.14, start=7))
    want = jtiles.build_csv(str(root), str(tmp_path / "j.csv"))
    got = ttiles.build_csv(str(root), str(tmp_path / "t.csv"))
    _same_csv(tmp_path / "j.csv", tmp_path / "t.csv")
    assert list(got) == list(want.columns) and list(got)[15:] == ["surface_path", "overhead_path"]
    for col in want.columns:
        assert [str(v) for v in got[col]] == [str(v) for v in want[col]], col
    frame = jtiles.metadata_to_frame(str(root / "paris" / "metadata.json"), "paris")
    table = ttiles.metadata_to_frame(str(root / "paris" / "metadata.json"), "paris")
    pd.testing.assert_frame_equal(pd.DataFrame(table), frame)


def _strip_u8(tmp_path, rng, side=400, name="03_paris.tif", dtype=np.uint8):
    e, n, epsg = jgt.wgs84_to_utm(*PARIS)
    gtf = np.array([e - side * 0.15, 0.3, 0, n + side * 0.15, 0, -0.3])
    sat = tmp_path / "sat"
    sat.mkdir(exist_ok=True)
    strip = rng.integers(1, 255, (side, side, 3), dtype=np.uint8)
    strip[: side // 4] = 0  # nodata rows
    jgt.write_geotiff_u8(str(sat / name), strip, gtf, epsg)
    return sat


def test_clip_tiles_and_split_match(tmp_path, rng, write_u16):
    sat = _strip_u8(tmp_path, rng)
    rows = [{"aoi": "paris", "id": str(100 + i), "latitude": PARIS[0] + d[0], "longitude": PARIS[1] + d[1]}
            for i, d in enumerate([(0, 0), (1e-4, 2e-4), (-2e-4, -1e-4), (3.3e-4, 0), (0.05, 0.1),
                                   (0, 0)])]
    rows.append({"aoi": "vegas", "id": "200", "latitude": 36.1, "longitude": -115.1})
    frame = jtiles.annotate_frame(pd.DataFrame(rows))
    table = ttiles.annotate_frame(_table(pd.DataFrame(rows)))
    kept_j = jtiles.clip_tiles(frame, str(sat), str(tmp_path / "j"), edge=30.0)
    kept_t = ttiles.clip_tiles(table, str(sat), str(tmp_path / "t"), edge=30.0)
    assert list(kept_t["id"]) == list(kept_j["id"]) and len(kept_j) == 5
    for rel in kept_j["overhead_path"]:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()
    for (a, b), name in zip(zip(jtiles.split_train_test(kept_j), ttiles.split_train_test(kept_t)),
                            ("train", "test")):
        a.to_csv(tmp_path / f"j_{name}.csv", index=False)
        write_table(str(tmp_path / f"t_{name}.csv"), b)
        _same_csv(tmp_path / f"j_{name}.csv", tmp_path / f"t_{name}.csv")
    # a 16-bit strip is refused by both: astype(uint8) would wrap its values
    write_u16(sat / "03_paris.tif", rng.integers(0, 4000, (40, 40, 3)), GTF, 32631)
    with pytest.raises(ValueError, match="convert_8bit"):
        jtiles.clip_tiles(frame, str(sat), str(tmp_path / "j2"), edge=3.0)
    with pytest.raises(ValueError, match="convert_8bit"):
        ttiles.clip_tiles(table, str(sat), str(tmp_path / "t2"), edge=3.0)


# ---------------------------------------------------------------- density / filter


def _photo_frame(rng, n=400):
    return pd.DataFrame({
        "aoi": rng.choice(["vegas", "paris", "rio"], n), "id": np.arange(n) + 7,
        "latitude": 48.85 + rng.uniform(0, 1e-3, n), "longitude": 2.35 + rng.uniform(0, 1e-3, n),
        "title": [f"p{i}" for i in range(n)]})


@pytest.mark.parametrize("threshold, seed", [(10.0, 0), (25.0, 3), (0.0, 1)])
def test_limit_density_matches(tmp_path, rng, threshold, seed, monkeypatch):
    monkeypatch.setattr(tden, "BLOCK", 37)  # several device round trips
    _photo_frame(rng).to_csv(tmp_path / "in.csv", index=False)
    want = jden.limit_density(pd.read_csv(tmp_path / "in.csv"), threshold, seed)
    got = tden.limit_density(read_table(str(tmp_path / "in.csv")), threshold, seed, device=CPU)
    assert list(got["id"]) == list(want["id"])
    want.to_csv(tmp_path / "j.csv", index=False)
    write_table(str(tmp_path / "t.csv"), got)
    _same_csv(tmp_path / "j.csv", tmp_path / "t.csv")


@pytest.mark.parametrize("nan_rows", [[0, 5, 60], [3, 4, 90, 91]])
def test_limit_density_matches_with_empty_coordinates(tmp_path, rng, nan_rows, monkeypatch):
    """Empty latitude cells read as NaN: a NaN distance is never >= the
    threshold, so after a kept NaN row witw_tpu keeps nothing more of its
    AOI, inside a block as across blocks."""
    monkeypatch.setattr(tden, "BLOCK", 37)
    frame = _photo_frame(rng, 120)
    frame.loc[nan_rows, "latitude"] = np.nan
    frame.to_csv(tmp_path / "in.csv", index=False)
    want = jden.limit_density(pd.read_csv(tmp_path / "in.csv"), 10.0, 0)
    got = tden.limit_density(read_table(str(tmp_path / "in.csv")), 10.0, 0, device=CPU)
    assert list(got["id"]) == list(want["id"])
    want.to_csv(tmp_path / "j.csv", index=False)
    write_table(str(tmp_path / "t.csv"), got)
    _same_csv(tmp_path / "j.csv", tmp_path / "t.csv")


def test_density_and_filter_clis_match(tmp_path, rng, capsys):
    _photo_frame(rng, 120).to_csv(tmp_path / "in.csv", index=False)
    (tmp_path / "ids.txt").write_text("\n".join(str(i) for i in range(7, 127, 3)) + "\n\n")
    for pkg, tag, extra in ((jden, "j", []), (tden, "t", ["--device", CPU])):
        pkg.main(["--csv", str(tmp_path / "in.csv"), "--out", str(tmp_path / f"{tag}_d.csv"),
                  "--threshold", "15"] + extra)
    for pkg, tag in ((jfilt, "j"), (tfilt, "t")):
        for mode in ("retain", "remove"):
            pkg.main([mode, "--csv", str(tmp_path / "in.csv"), "--ids", str(tmp_path / "ids.txt"),
                      "--out", str(tmp_path / f"{tag}_{mode}.csv")])
    out = capsys.readouterr().out.splitlines()
    assert out[:1] == out[1:2] and out[2:4] == out[4:6]
    for name in ("d", "retain", "remove"):
        _same_csv(tmp_path / f"j_{name}.csv", tmp_path / f"t_{name}.csv")


def test_filter_frame_matches():
    frame = pd.DataFrame({"id": [1, 2, 3, 4], "name": ["a", "b", "c", "d"]})
    table = _table(frame)
    for mode in ("retain", "remove"):
        want = jfilt.filter_frame(frame, ["2", 4], mode)
        got = tfilt.filter_frame(table, ["2", 4], mode)
        assert list(got["id"]) == list(want["id"]) and list(got["name"]) == list(want["name"])
    with pytest.raises(ValueError):
        tfilt.filter_frame(table, [], "keep")


# ---------------------------------------------------------------- modify


@pytest.mark.parametrize("options", [(10,), (20,), (10, 20), (40,), (50,), (10, 50), (20, 40)])
def test_modify_pair_equal(rng, options):
    surface = rng.integers(0, 255, (120, 480, 3), dtype=np.uint8)
    overhead = rng.integers(0, 255, (600, 600, 3), dtype=np.uint8)
    for seed in range(3):
        want = jmod.modify_pair(surface, overhead, options, np.random.default_rng(seed))
        got = tmod.modify_pair(surface, overhead, options, np.random.default_rng(seed))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_modify_run_matches(tmp_path, rng):
    for d in ("s", "o"):
        (tmp_path / d).mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (60, 240, 3), dtype=np.uint8)).save(tmp_path / "s" / f"{i}.png")
        Image.fromarray(rng.integers(0, 255, (560, 560, 3), dtype=np.uint8)).save(tmp_path / "o" / f"{i}.png")
    for pkg, tag in ((jmod, "j"), (tmod, "t")):
        pkg.main([str(o) for o in (1, 2, 20, 50)] + [
            "--surface_in", str(tmp_path / "s"), "--overhead_in", str(tmp_path / "o"),
            "--surface_out", str(tmp_path / f"{tag}s"), "--overhead_out", str(tmp_path / f"{tag}o"),
            "--seed", "5"])
    for sub in ("s", "o"):
        for i in range(2):
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"t{sub}" / f"{i}.png")),
                                          np.asarray(Image.open(tmp_path / f"j{sub}" / f"{i}.png")))


# ---------------------------------------------------------------- semantic masks


def _blobs(rng, h, w):
    """An image with smooth regions (gray road-like bands) and texture."""
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    img[h // 3: h // 2] = 120 + rng.integers(0, 6, (h // 2 - h // 3, w, 1))
    img[:, w // 4: w // 4 + 9] = np.array([90, 95, 100])
    return img.astype(np.uint8)


@pytest.mark.parametrize("shape", [(64, 64), (97, 130), (256, 256)])
def test_heuristic_road_mask_matches_cv2(rng, shape):
    img = _blobs(rng, *shape).astype(np.float32)
    want = jsem.heuristic_road_mask(img)
    got = tsem.heuristic_road_mask(img, device=CPU)
    assert got.dtype == np.float32 and got.shape == shape
    assert np.abs(got - want).max() <= 2e-4
    w8 = np.round(np.clip(want, 0, 1) * 255).astype(int)
    g8 = np.round(np.clip(got, 0, 1) * 255).astype(int)
    assert np.abs(w8 - g8).max() <= 1 and (w8 != g8).mean() <= 0.005


def test_normalizers_match(rng):
    pred = rng.normal(0, 3, (20, 30)).astype(np.float32)
    np.testing.assert_array_equal(tsem.minmax_normalize(pred, CPU), jsem.minmax_normalize(pred))
    np.testing.assert_allclose(tsem.normalize_prediction(pred, CPU),
                               jsem.normalize_prediction(pred), rtol=0, atol=1e-12)


def _overhead_dir(tmp_path, rng, n=2, side=40):
    d = tmp_path / "overhead"
    d.mkdir()
    for i in range(n):
        jgt.write_geotiff_u8(str(d / f"t{i}.tif"), _blobs(rng, side, side + 3), GTF, 32631)
    (d / "notes.txt").write_text("not a tile")
    return d


def test_precompute_masks_heuristic_matches(tmp_path, rng):
    d = _overhead_dir(tmp_path, rng)
    assert jsem.precompute_masks(str(d), str(tmp_path / "j"), verbose=False) == \
        tsem.precompute_masks(str(d), str(tmp_path / "t"), verbose=False, device=CPU) == 2
    for i in range(2):
        with tgt.GeoTiff(str(tmp_path / "j" / f"t{i}.tif")) as a, \
                tgt.GeoTiff(str(tmp_path / "t" / f"t{i}.tif")) as b:
            want, got = a.read().astype(int), b.read().astype(int)
            assert (b.epsg, list(b.geotransform)) == (32631, list(GTF))
        np.testing.assert_array_equal(got[..., :3], want[..., :3])
        assert np.abs(got[..., 3] - want[..., 3]).max() <= 1
        assert (got[..., 3] != want[..., 3]).mean() <= 0.005
    # the default directory is <parent>/cresi_uint8
    assert tsem.precompute_masks(str(d), verbose=False, device=CPU) == 2
    assert (tmp_path / "cresi_uint8" / "t0.tif").exists()


@pytest.mark.parametrize("out_channels", [1, 2])
def test_checkpoint_masks_bit_equal(tmp_path, rng, out_channels):
    d = _overhead_dir(tmp_path, rng)
    torch.manual_seed(0)
    model = torch.nn.Conv2d(3, out_channels, 3, padding=1)
    ckpt = str(tmp_path / "seg.pth")
    torch.save(model, ckpt)
    jsem.precompute_masks(str(d), str(tmp_path / "j"), segmenter=jsem.torch_segmenter(ckpt),
                          minmax=True, verbose=False)
    tsem.precompute_masks(str(d), str(tmp_path / "t"), segmenter=tsem.torch_segmenter(ckpt, CPU),
                          minmax=True, verbose=False, device=CPU)
    tsem.precompute_masks(str(d), str(tmp_path / "tl"), segmenter=tsem.torch_segmenter(ckpt, CPU),
                          logits=True, verbose=False, device=CPU)
    jsem.precompute_masks(str(d), str(tmp_path / "jl"), segmenter=jsem.torch_segmenter(ckpt),
                          logits=True, verbose=False)
    for i in range(2):
        for a, b in (("j", "t"), ("jl", "tl")):
            with tgt.GeoTiff(str(tmp_path / a / f"t{i}.tif")) as x, \
                    tgt.GeoTiff(str(tmp_path / b / f"t{i}.tif")) as y:
                np.testing.assert_array_equal(y.read(), x.read())


def test_segmenters_refuse_a_state_dict(tmp_path):
    ckpt = str(tmp_path / "sd.pth")
    torch.save(torch.nn.Conv2d(3, 1, 3).state_dict(), ckpt)
    with pytest.raises(ValueError, match="full nn.Module"):
        tsem.torch_segmenter(ckpt, CPU)
    io_map = tmp_path / "io.txt"
    io_map.write_text("a 1\n")
    with pytest.raises(ValueError, match="full nn.Module"):
        tbd.torch_indoor_classifier(ckpt, str(io_map), device=CPU)


# ---------------------------------------------------------------- build_dataset


def _photo_files(tmp_path, rng):
    """Photos of each kind is_single_band and the classifier see."""
    d = tmp_path / "kinds"
    d.mkdir()
    rgb = rng.integers(120, 255, (32, 40, 3), dtype=np.uint8)
    grey = rng.integers(0, 255, (32, 40), dtype=np.uint8)
    Image.fromarray(rgb).save(d / "rgb.jpg")
    Image.fromarray(grey).save(d / "grey.jpg")
    Image.fromarray(rgb).save(d / "rgb.png")
    Image.fromarray(grey).save(d / "grey.png")
    Image.fromarray(np.dstack([rgb, grey])).save(d / "rgba.png")
    Image.fromarray(grey).convert("LA").save(d / "la.png")
    Image.fromarray(rgb).convert("P").save(d / "palette.png")
    Image.fromarray(rgb // 8).save(d / "dark.jpg")
    (d / "bad.jpg").write_bytes(b"\xff\xd8not a jpeg")
    return d


def test_is_single_band_matches(tmp_path, rng):
    d = _photo_files(tmp_path, rng)
    for path in sorted(d.iterdir()) + [d / "missing.jpg"]:
        assert tbd.is_single_band(str(path)) == jbd.is_single_band(str(path)), path.name


def _classifier(tmp_path):
    model = torch.nn.Sequential(torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
                                torch.nn.Linear(3, 4))
    with torch.no_grad():
        model[2].weight.copy_(torch.tensor([[-1.0] * 3, [-0.33] * 3, [0.33] * 3, [1.0] * 3]))
        model[2].bias.zero_()
    ckpt = tmp_path / "places.pth"
    torch.save(model, ckpt)
    io_map = tmp_path / "io.txt"
    io_map.write_text("a 1\nb 1\n\nc 2\nd 2\n")
    return str(ckpt), str(io_map)


def test_indoor_classifier_matches(tmp_path, rng):
    d = _photo_files(tmp_path, rng)
    ckpt, io_map = _classifier(tmp_path)
    want = jbd.torch_indoor_classifier(ckpt, io_map)
    got = tbd.torch_indoor_classifier(ckpt, io_map, device=CPU, input_size=64)
    want64 = jbd.torch_indoor_classifier(ckpt, io_map, input_size=64)
    got224 = tbd.torch_indoor_classifier(ckpt, io_map, device=CPU)
    decisions = {p.name: want(str(p)) for p in sorted(d.iterdir())}
    assert decisions["dark.jpg"] is True and decisions["rgb.jpg"] is False
    assert decisions["bad.jpg"] is True  # unreadable photos are dropped
    for p in sorted(d.iterdir()):
        assert got224(str(p)) == decisions[p.name] and got(str(p)) == want64(str(p)), p.name


def test_build_matches_witw(tmp_path, rng):
    """Every stage on planted photos: grey, unreadable, missing, dark
    (indoor), a preset id, off the strip, over the nodata rows; files under
    {id}.jpg and under the URL's basename; Paris test, Rotterdam train."""
    sat = _strip_u8(tmp_path, rng, side=300)
    os.link(sat / "03_paris.tif", sat / "11_rotterdam.tif")
    e, n, _ = jgt.wgs84_to_utm(*PARIS)
    meta, photos = tmp_path / "meta", tmp_path / "photos"
    kinds = ["ok", "ok", "grey", "bad", "missing", "dark", "removed", "off", "blank", "ok"]
    ident = 0
    for city in ("paris", "rotterdam"):
        recs = []
        (photos / city).mkdir(parents=True)
        for k, kind in enumerate(kinds):
            ident += 1
            dn = 15.0 if kind == "blank" else float(rng.uniform(-25, 5))
            lat, lon = jgt.utm_to_wgs84(e + float(rng.uniform(-20, 20)), n + dn, 32631)
            if kind == "off":
                lat += 0.01
            url = f"http://x/{ident}_sec_m.jpg"
            recs.append({"id": str(ident), "latitude": lat, "longitude": lon, "url_m": url,
                         "title": kind, "license": "4", "accuracy": "16"})
            path = photos / city / (f"{ident}.jpg" if k % 2 else url.rsplit("/", 1)[-1])
            if kind == "grey":
                Image.fromarray(rng.integers(0, 255, (24, 30), dtype=np.uint8)).save(path)
            elif kind == "bad":
                path.write_bytes(b"junk")
            elif kind == "dark":
                Image.fromarray(rng.integers(0, 20, (24, 30, 3), dtype=np.uint8)).save(path)
            elif kind != "missing":
                Image.fromarray(rng.integers(150, 255, (24, 30, 3), dtype=np.uint8)).save(path)
        _write_metadata(meta, city, recs)
    removed = {"7", "17"}
    ckpt, io_map = _classifier(tmp_path)
    want = jbd.build(str(meta), str(photos), str(sat), str(tmp_path / "j"), edge=30.0,
                     remove_ids=removed, indoor_classifier=jbd.torch_indoor_classifier(ckpt, io_map),
                     verbose=False)
    seconds = {}
    got = tbd.build(str(meta), str(photos), str(sat), str(tmp_path / "t"), edge=30.0,
                    remove_ids=removed, indoor_classifier=tbd.torch_indoor_classifier(
                        ckpt, io_map, device=CPU), verbose=False, device=CPU, stage_seconds=seconds)
    assert list(got["id"]) == list(want["id"]) and len(want) == 6
    assert sorted(seconds) == ["1", "2", "3", "4", "5", "6", "7-8"]
    for name in ("dataset.csv", "train.csv", "test.csv"):
        _same_csv(tmp_path / "j" / name, tmp_path / "t" / name)
    for sub in ("overhead", "surface"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert sorted(os.listdir(tmp_path / "t" / sub)) == names and names
        for name in names:
            assert (tmp_path / "t" / sub / name).read_bytes() == \
                (tmp_path / "j" / sub / name).read_bytes()


# ---------------------------------------------------------------- the CLIs


def test_tool_clis_run_as_modules():
    """Each tool's CLI parses its arguments when run as ``python -m``."""
    code = textwrap.dedent("""
        import runpy, sys
        for name in sys.argv[1:]:
            sys.argv = [name, "--help"]
            try:
                runpy.run_module(name, run_name="__main__", alter_sys=True)
            except SystemExit as e:
                assert e.code in (0, None), (name, e.code)
            else:
                raise AssertionError(name + " did not exit on --help")
        print("ok")
    """)
    names = ["witw_tpu_torch.tools." + m for m in (
        "convert_8bit", "zero_frac", "reproject", "filter_csv", "density", "tiles", "modify",
        "semantic_masks", "build_dataset", "parity", "flickr.search")]
    out = subprocess.run([sys.executable, "-c", code, *names], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_tools_run_on_the_card_unless_asked_for_the_cpu(tmp_path, rng, monkeypatch):
    """Without a GPU, every entry point that does device work raises when
    no device is named; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _raster(rng, (8, 8, 3))
    jgt.write_geotiff_u8(str(tmp_path / "t.tif"), img.astype(np.uint8), GTF, 32631)
    (tmp_path / "o").mkdir()
    jgt.write_geotiff_u8(str(tmp_path / "o" / "t.tif"), img.astype(np.uint8), GTF, 32631)
    model = tmp_path / "m.pth"
    torch.save(torch.nn.Conv2d(3, 1, 1), model)
    (tmp_path / "io.txt").write_text("a 1\n")
    table = {"aoi": np.array(["paris"], object), "latitude": np.ones(1), "longitude": np.ones(1)}
    calls = [
        lambda: t8.band_percentiles(img[..., 0]), lambda: t8.rescale_to_u8(img),
        lambda: t8.zero_fraction(img),
        lambda: t8.convert_to_8bit(str(tmp_path / "t.tif"), str(tmp_path / "u.tif")),
        lambda: t8.dir_to_8bit(str(tmp_path / "o"), str(tmp_path / "d")),
        lambda: trep.reproject_to_utm(str(tmp_path / "t.tif"), str(tmp_path / "r.tif"), 32631),
        lambda: tden.limit_density(table), lambda: tsem.heuristic_road_mask(img),
        lambda: tsem.precompute_masks(str(tmp_path / "o")),
        lambda: tsem.torch_segmenter(str(model)),
        lambda: tbd.torch_indoor_classifier(str(model), str(tmp_path / "io.txt")),
        lambda: tbd.build(str(tmp_path), str(tmp_path), str(tmp_path), str(tmp_path / "b")),
        lambda: tparity.load_reference_towers(fov_experiment("cvusa", 360), "s.pth", "o.pth"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
