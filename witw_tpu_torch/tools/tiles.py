"""Dataset heart: photo metadata -> CSV, and overhead tile extraction (port
of witw_tpu/tools/tiles.py, on the port's tables instead of pandas frames).

Replaces reference tools/dataset_building/sitetiles.py:
- ``metadata_to_frame``: flatten per-city Flickr ``metadata.json`` into a
  table (reference sitetiles.py:86-93).
- ``annotate_frame``: add license text/URL, satellite name and the
  surface_path/overhead_path columns that become CSV columns 15/16 — the
  exact columns the models read (reference sitetiles.py:96-121).
- ``clip_tiles``: for each photo, convert its WGS84 geotag to the strip's UTM
  (native geodesy instead of osr, reference sitetiles.py:147-151) and
  extract an ``edge``-meter tile around it via a windowed read (instead of
  gdal.Translate(projWin=...), reference sitetiles.py:161-171).

The CSVs are written as witw_tpu's ``DataFrame.to_csv(index=False)`` writes
them (``data/csv_registry.write_table``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterable, List, Optional

import numpy as np

from witw_tpu_torch.data.csv_registry import (Table, concat_tables, iter_rows, read_table,
                                              table_len, take_rows, write_table)
from witw_tpu_torch.tools.cities import CITIES, TEST_CITIES, strip_filename
from witw_tpu_torch.tools.geotiff import GeoTiff, background_writes, wgs84_to_utm

LICENSE_URLS = {
    "CC BY-SA 4.0": "https://creativecommons.org/licenses/by-sa/4.0/",
    "CC BY 2.0": "https://creativecommons.org/licenses/by/2.0/",
    "CC BY-SA 2.0": "https://creativecommons.org/licenses/by-sa/2.0/",
    "CC BY-NC 2.0": "https://creativecommons.org/licenses/by-nc/2.0/",
    "CC0": "https://creativecommons.org/publicdomain/zero/1.0/",
}

# The 17 columns of the dataset CSV; the models read surface_path and
# overhead_path at columns 15/16 (usecols=[15,16], reference cvig_fov.py:46-47).
COLUMNS = (
    "aoi", "id", "owner", "title", "datetaken", "latitude", "longitude",
    "accuracy", "license", "url", "license_name", "license_url",
    "satellite", "city_fullname", "photo_license_url", "surface_path", "overhead_path",
)


def _column(values: List) -> np.ndarray:
    """A column built from Python values as a DataFrame built from records
    types it: int64 where every value is an int, float64 where every value
    is a number or None (None as NaN), strings otherwise."""
    numbers = [v for v in values if v is not None]
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in numbers) and numbers:
        if len(numbers) == len(values) and all(isinstance(v, int) for v in numbers):
            return np.array(values, np.int64)
        return np.array([np.nan if v is None else v for v in values], np.float64)
    out = np.empty(len(values), object)
    out[:] = values
    return out


def metadata_to_frame(metadata_path: str, city: str) -> Table:
    """Flatten a Flickr metadata.json (list of photo dicts) to rows."""
    with open(metadata_path) as f:
        records = json.load(f)
    rows = [
        {
            "aoi": city,
            "id": str(rec.get("id", "")),
            "owner": rec.get("owner", ""),
            "title": rec.get("title", ""),
            "datetaken": rec.get("datetaken", ""),
            "latitude": float(rec.get("latitude", 0.0)),
            "longitude": float(rec.get("longitude", 0.0)),
            "accuracy": rec.get("accuracy", ""),
            "license": str(rec.get("license", "")),
            # url_o is present only when the owner allows original
            # downloads; url_m always is (the reference's url_field)
            "url": rec.get("url_o") or rec.get("url_m") or rec.get("url", ""),
        }
        for rec in records
    ]
    return {k: _column([r[k] for r in rows]) for k in COLUMNS[:10]}


def annotate_frame(table: Table) -> Table:
    """Add license/satellite columns + surface/overhead path columns
    (columns 15/16 of the final CSV, consumed by the models)."""
    n = table_len(table)
    out = dict(table)
    meta = [CITIES.get(c) for c in table["aoi"]]
    out["license_name"] = _column([m.license if m else "" for m in meta])
    out["license_url"] = _column([LICENSE_URLS.get(name, "") for name in out["license_name"]])
    out["satellite"] = _column([m.satellite if m else "" for m in meta])
    out["city_fullname"] = _column([m.fullname if m else "" for m in meta])
    out["photo_license_url"] = table["url"] if "url" in table else _column([""] * n)
    out["surface_path"] = _column([os.path.join("surface", f"{aoi}_{pid}.jpg")
                                  for aoi, pid in zip(table["aoi"], table["id"])])
    out["overhead_path"] = _column([os.path.join("overhead", f"{aoi}_{pid}.tif")
                                   for aoi, pid in zip(table["aoi"], table["id"])])
    for c in COLUMNS:
        if c not in out:
            out[c] = _column([""] * n)
    return {c: out[c] for c in COLUMNS}


def build_csv(metadata_root: str, out_csv: str, cities: Optional[Iterable[str]] = None) -> Table:
    """metadata/{city}/metadata.json -> one annotated dataset.csv."""
    frames = []
    for city in cities or CITIES:
        path = os.path.join(metadata_root, city, "metadata.json")
        if os.path.exists(path):
            frames.append(metadata_to_frame(path, city))
    if not frames:
        raise ValueError(f"no metadata.json under {metadata_root}")
    table = annotate_frame(concat_tables(frames))
    write_table(out_csv, table)
    return table


def clip_tiles(table: Table, sat_dir: str, out_dir: str, edge: float = 225.0,
               verbose: bool = False) -> Table:
    """Extract an edge x edge meter overhead tile centered on each photo.

    Returns the table filtered to rows whose tile was written. The tiles
    are compressed and written on background threads.
    """
    os.makedirs(os.path.join(out_dir, "overhead"), exist_ok=True)
    kept = []
    strips = {}
    try:
        with background_writes() as write:
            for i, row in enumerate(iter_rows(table)):
                city = row["aoi"]
                if city not in strips:
                    path = os.path.join(sat_dir, strip_filename(city))
                    strips[city] = GeoTiff(path) if os.path.exists(path) else None
                tif = strips[city]
                if tif is None:
                    continue
                if tif.dtype != np.uint8:
                    raise ValueError(
                        f"{strip_filename(city)} is {np.dtype(tif.dtype)}: run the 16->8-bit "
                        "conversion (tools/convert_8bit.py) before tile extraction — "
                        "astype(uint8) would wrap sample values modulo 256"
                    )
                # Project into the STRIP's grid (its zone + hemisphere), not the
                # zone implied by the photo's own longitude: near a zone boundary
                # those differ by hundreds of km and the tile reads off-raster.
                easting, northing, _ = wgs84_to_utm(row["latitude"], row["longitude"],
                                                    epsg=tif.epsg)
                half = edge / 2.0
                tile = tif.read_world_window(easting - half, northing + half, easting + half,
                                             northing - half)
                if tile.size == 0 or tile.max() == 0:
                    continue
                out_path = os.path.join(out_dir, row["overhead_path"])
                gt = tif.geotransform
                tile_gt = np.array([easting - half, gt[1], 0.0, northing + half, 0.0, gt[5]])
                write(out_path, tile.astype(np.uint8), tile_gt, tif.epsg)
                kept.append(i)
                if verbose:
                    print(f"clipped {out_path}")
    finally:
        for tif in strips.values():
            if tif is not None:
                tif.close()
    return take_rows(table, kept)


def split_train_test(table: Table, test_cities=TEST_CITIES):
    """Held-out-city split (reference build_dataset:59-63: Paris = test)."""
    is_test = np.array([a in tuple(test_cities) for a in table["aoi"]], bool)
    return take_rows(table, ~is_test), take_rows(table, is_test)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build dataset CSV / clip overhead tiles")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_csv = sub.add_parser("csv", help="metadata.json files -> dataset.csv")
    p_csv.add_argument("--metadata-root", required=True)
    p_csv.add_argument("--out", default="dataset.csv")
    p_ds = sub.add_parser("dataset", help="clip overhead tiles for each photo")
    p_ds.add_argument("--csv", required=True)
    p_ds.add_argument("--sat-dir", required=True)
    p_ds.add_argument("--out-dir", required=True)
    p_ds.add_argument("--edge", type=float, default=225.0)
    args = parser.parse_args(argv)
    if args.cmd == "csv":
        table = build_csv(args.metadata_root, args.out)
        print(f"wrote {table_len(table)} rows to {args.out}")
    else:
        table = read_table(args.csv)
        kept = clip_tiles(table, args.sat_dir, args.out_dir, args.edge, verbose=True)
        print(f"clipped {table_len(kept)}/{table_len(table)} tiles")


if __name__ == "__main__":
    main()
