"""Flickr geotagged-photo scraper: recursive bbox search + metadata dump
(port of witw_tpu/tools/flickr/search.py; host code, no device work).

Re-implements the reference scraper's strategy (reference
tools/download/flickr/src/flickr_search.py) against the Flickr REST API
directly with httpx (the flickrapi package is not available here):

- recursive bisection: Flickr caps any geo query at ~4000 results, so boxes
  with more hits are split on their long axis until each is under the cap
  (quadtree-style, reference flickr_search.py:66-125),
- page through flickr.photos.search collecting metadata + original URLs with
  per-id dedup (reference flickr_search.py:175-248),
- write metadata.json / urls per city (reference flickr_search.py:250-276),
- optional AWS Lambda fan-out of the downloads (reference
  flickr_search.py:278-342) via witw_tpu_torch.tools.flickr.uploader.

Network access is required to actually run; all request logic is isolated in
``_api_call`` so tests can stub it.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

from witw_tpu_torch.tools.flickr.config import BBox, ScraperConfig

API_URL = "https://api.flickr.com/services/rest/"
# Request BOTH url_o (original; only present when the owner allows original
# downloads) and url_m (always present — the reference's url_field,
# config.yaml:1): keeping only url_o leaves most photos with no usable URL.
EXTRAS = "geo,license,url_o,url_m,date_taken,owner_name"


def photo_url(rec: dict, prefer: str = "url_o") -> str:
    """Best available download URL for a record: the preferred size field,
    then the other one, then a legacy 'url' key."""
    order = [prefer] + [f for f in ("url_o", "url_m") if f != prefer]
    for field in order:
        if rec.get(field):
            return rec[field]
    return rec.get("url", "") or ""


def _api_call(params: Dict, api_key: str, retries: int = 3) -> Dict:
    import httpx

    query = dict(
        params,
        api_key=api_key,
        format="json",
        nojsoncallback=1,
    )
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        try:
            resp = httpx.get(API_URL, params=query, timeout=30.0)
            resp.raise_for_status()
            data = resp.json()
            if data.get("stat") != "ok":
                raise RuntimeError(f"flickr error: {data}")
            return data
        except Exception as err:  # pragma: no cover - network path
            last_err = err
            time.sleep(2.0 * (attempt + 1))
    raise RuntimeError(f"flickr API failed after {retries} tries: {last_err}")


def est_area_m2(bbox: BBox, radius: float = 6.371e6) -> float:
    """Spherical-cap estimate of a lon/lat box's area in m^2 (the bisection
    guard metric, reference flickr_search.py:60-64)."""
    import math

    min_lon, min_lat, max_lon, max_lat = bbox
    return (
        radius**2
        * math.radians(max_lon - min_lon)
        * abs(math.sin(math.radians(max_lat)) - math.sin(math.radians(min_lat)))
    )


def _search_params(cfg: ScraperConfig) -> Dict:
    return {
        "method": "flickr.photos.search",
        "license": ",".join(cfg.licenses),
        "has_geo": 1,
        "privacy_filter": cfg.privacy_filter,
        "content_type": cfg.content_type,
        "geo_context": cfg.geo_context,
    }


def count_in_bbox(bbox: BBox, cfg: ScraperConfig, api=_api_call) -> int:
    data = api(
        dict(
            _search_params(cfg),
            bbox=",".join(f"{v:.6f}" for v in bbox),
            per_page=1,
        ),
        cfg.api_key,
    )
    return int(data["photos"]["total"])


def split_bbox(bbox: BBox) -> List[BBox]:
    """Bisect on the long axis (reference flickr_search.py:66-125)."""
    min_lon, min_lat, max_lon, max_lat = bbox
    if (max_lon - min_lon) >= (max_lat - min_lat):
        mid = (min_lon + max_lon) / 2.0
        return [(min_lon, min_lat, mid, max_lat), (mid, min_lat, max_lon, max_lat)]
    mid = (min_lat + max_lat) / 2.0
    return [(min_lon, min_lat, max_lon, mid), (min_lon, mid, max_lon, max_lat)]


def partition_bboxes(
    bbox: BBox, cfg: ScraperConfig, api=_api_call, max_depth: int = 12,
    throttle=None,
) -> List[BBox]:
    """Recursively split until each box is under the result cap, with the
    reference's area guards (flickr_search.py:85-99): boxes above max_area
    split without an API call; boxes below min_area never split; a throttle
    sleeps between count queries."""
    if throttle is None:
        throttle = time.sleep if cfg.time_delay > 0 else (lambda s: None)
    out: List[BBox] = []
    stack = [(bbox, 0)]
    while stack:
        box, depth = stack.pop()
        area = est_area_m2(box)
        if area > cfg.max_area_m2 and depth < max_depth:
            for child in split_bbox(box):
                stack.append((child, depth + 1))
            continue
        throttle(cfg.time_delay)
        total = count_in_bbox(box, cfg, api)
        if total == 0:
            continue
        if total < cfg.max_per_box or area <= cfg.min_area_m2 or depth >= max_depth:
            out.append(box)
        else:
            for child in split_bbox(box):
                stack.append((child, depth + 1))
    return out


def collect_photos(bbox: BBox, cfg: ScraperConfig, api=_api_call,
                   throttle=None) -> List[Dict]:
    """Page through one bbox's results (reference flickr_search.py:175-248).
    A throttle sleeps before every page fetch like the reference's universal
    time_delay (flickr_search.py:208,224) — back-to-back page requests get
    the API key rate-limited mid-scrape."""
    if throttle is None:
        throttle = time.sleep if cfg.time_delay > 0 else (lambda s: None)
    photos: List[Dict] = []
    page = 1
    while True:
        throttle(cfg.time_delay)
        data = api(
            dict(
                _search_params(cfg),
                bbox=",".join(f"{v:.6f}" for v in bbox),
                extras=EXTRAS,
                per_page=cfg.per_page,
                page=page,
            ),
            cfg.api_key,
        )
        body = data["photos"]
        photos.extend(body.get("photo", []))
        if page >= int(body.get("pages", 0)):
            break
        page += 1
    return photos


def read_metadata(city_dir: str) -> List[Dict]:
    """Previously saved records for a city, [] when absent or corrupt
    (a torn write can't happen — snapshots are atomic — but a hand-edited
    file shouldn't kill a week-long scrape). Reference
    tools/download/flickr/src/metadata.py:70-137 (read_metadata)."""
    try:
        with open(os.path.join(city_dir, "metadata.json")) as f:
            records = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return []
    # Valid JSON of the wrong shape (a hand-edited dict, a list of strings)
    # must degrade the same way as a corrupt file, not crash the resume.
    if not isinstance(records, list):
        return []
    return [r for r in records if isinstance(r, dict)]


def get_known_urls(city_dir: str, prefer: str = "url_o") -> List[str]:
    """Download URLs of every previously saved record (reference
    metadata.py get_known_urls), across both size fields."""
    urls = [photo_url(r, prefer) for r in read_metadata(city_dir)]
    return [u for u in urls if u]


def _write_snapshot(city_dir: str, records: List[Dict]) -> None:
    """Atomic metadata.json + urls write (tmp + rename): a kill mid-write
    never loses the previous snapshot."""
    os.makedirs(city_dir, exist_ok=True)
    meta_path = os.path.join(city_dir, "metadata.json")
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(records, f)
    os.replace(tmp, meta_path)
    urls_path = os.path.join(city_dir, "urls")
    tmp = urls_path + ".tmp"
    with open(tmp, "w") as f:
        for rec in records:
            url = photo_url(rec)
            if url:
                f.write(url + "\n")
    os.replace(tmp, urls_path)


def scrape_city(
    city: str,
    cfg: ScraperConfig,
    api=_api_call,
    on_photo: Optional[Callable[[Dict], None]] = None,
) -> List[Dict]:
    """Scrape one city; writes metadata.json + urls files
    (reference flickr_search.py:250-276). Returns the deduped records.

    Cross-run resume (reference metadata.py:70-137): previously saved
    records seed the dedup set and are MERGED with — never overwritten by —
    this run's finds; a snapshot is written atomically after every completed
    box, so an interrupted week-long scrape resumes where it stopped and a
    re-run converges to the same deduped set. ``on_photo`` fires only for
    photos not already known from an earlier run."""
    bbox = cfg.cities[city]
    city_dir = os.path.join(cfg.out_dir, city)
    # seed with earlier runs' records: incremental merge, not overwrite
    seen: Dict[str, Dict] = {
        str(rec.get("id")): rec for rec in read_metadata(city_dir)
    }
    n_resumed = len(seen)
    boxes = partition_bboxes(bbox, cfg, api)
    for box in boxes:
        new_in_box = 0
        for photo in collect_photos(box, cfg, api):
            pid = str(photo.get("id"))
            if pid in seen:
                continue
            seen[pid] = photo
            new_in_box += 1
            if on_photo is not None:
                on_photo(photo)
        if new_in_box:
            _write_snapshot(city_dir, list(seen.values()))

    records = list(seen.values())
    if not records or n_resumed == len(records):
        _write_snapshot(city_dir, records)  # nothing new: still (re)write
    return records


def read_secret_file(path: str) -> str:
    """Docker-secret credential file: first line, stripped (the reference
    mounts flickr_api_key/flickr_api_secret as compose secrets and reads them
    with secrets.get_secret, reference tools/download/flickr/src/secrets.py +
    docker-compose.yaml:11-21). Returns "" when the file is absent so callers
    can fall through to env/CLI sources."""
    try:
        with open(path) as f:
            return f.readline().strip()
    except OSError:
        return ""


def resolve_api_key(cli_value: str = "", secret_root: str = "/run/secrets") -> str:
    """Credential precedence: explicit CLI flag > FLICKR_API_KEY env >
    FLICKR_API_KEY_FILE env (path) > docker secret {secret_root}/flickr_api_key.
    An unreadable FLICKR_API_KEY_FILE warns and falls through to the docker
    secret rather than silently disabling credentials (a typo'd path must not
    terminate the chain)."""
    if cli_value:
        return cli_value
    if os.environ.get("FLICKR_API_KEY"):
        return os.environ["FLICKR_API_KEY"]
    key_file = os.environ.get("FLICKR_API_KEY_FILE", "")
    if key_file:
        key = read_secret_file(key_file)
        if key:
            return key
        print(f"warning: FLICKR_API_KEY_FILE={key_file} is missing/unreadable; "
              "falling back to the docker secret", file=sys.stderr)
    return read_secret_file(os.path.join(secret_root, "flickr_api_key"))


def main(argv=None):  # pragma: no cover - network entry point
    import argparse

    parser = argparse.ArgumentParser(description="Scrape Flickr geotagged photos")
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--api-key", default="",
                        help="Flickr API key; falls back to FLICKR_API_KEY, "
                             "then FLICKR_API_KEY_FILE, then the docker "
                             "secret /run/secrets/flickr_api_key")
    parser.add_argument("--out-dir", default=None,
                        help="overrides the config's out_dir when given")
    parser.add_argument("--cities", nargs="*", default=None)
    args = parser.parse_args(argv)
    cfg = ScraperConfig.from_yaml(args.config) if args.config else ScraperConfig()
    api_key = resolve_api_key(args.api_key)
    if api_key:
        cfg.api_key = api_key
    if args.out_dir is not None:
        # only an EXPLICIT flag overrides the YAML's out_dir — clobbering it
        # with the argparse default would strand a resumed scrape away from
        # its earlier metadata.json
        cfg.out_dir = args.out_dir
    for city in args.cities or cfg.cities:
        records = scrape_city(city, cfg)
        print(f"{city}: {len(records)} photos")


if __name__ == "__main__":
    main()
