"""Scraper configuration: city bounding boxes + API settings (port of
witw_tpu/tools/flickr/config.py).

YAML-configurable like the reference (reference
tools/download/flickr/config.yaml:1-53, src/config.py:3-22), read by the
port's own YAML reader (``configs/serialize.load_scraper_yaml``), not
PyYAML; defaults cover the 11 SpaceNet cities. Bounding boxes are (min_lon,
min_lat, max_lon, max_lat).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from witw_tpu_torch.configs.serialize import load_scraper_yaml

BBox = Tuple[float, float, float, float]

# SpaceNet AOI bounding boxes (lon/lat) — the reference's exact boxes
# (tools/download/flickr/config.yaml:8-53); these DEFINE the dataset extent.
DEFAULT_CITY_BBOXES: Dict[str, BBox] = {
    "rio": (-43.8574219, -23.1152344, -43.1542969, -22.7636719),
    "vegas": (-115.3075176, 36.1212777, -115.1526078, 36.2639592),
    "paris": (2.1109464, 48.4492509, 2.3131089, 49.0767795),
    "shanghai": (121.5901692, 30.8275659, 121.7484324, 31.4273115),
    "khartoum": (32.4191484, 15.4365912, 32.5687824, 15.8719878),
    "atlanta": (-84.4972444444445, 33.5884472222222,
                -84.3023833333333, 33.8360277777778),
    "moscow": (37.616508, 55.2994884, 37.8664794, 56.1044097),
    "mumbai": (72.7673544, 18.8756568, 72.8947026, 19.5682986),
    "san": (-66.0202785, 18.3164733, -65.8945476, 18.510336),
    "dar": (39.200166, -6.8752314, 39.3379686, -6.7444974),
    "rotterdam": (4.29701944444444, 51.8252194444445,
                  4.53869722222222, 51.9456583333333),
}

# CC + public-domain license ids accepted by the scraper (Flickr license codes).
ALLOWED_LICENSES = ("1", "2", "3", "4", "5", "6", "7", "8", "9", "10")


@dataclasses.dataclass
class ScraperConfig:
    api_key: str = ""
    api_secret: str = ""
    cities: Dict[str, BBox] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_CITY_BBOXES)
    )
    max_per_box: int = 4000       # Flickr caps geo queries ~4000 results
    per_page: int = 250
    licenses: Tuple[str, ...] = ALLOWED_LICENSES
    out_dir: str = "./flickr_out"
    lambda_name: Optional[str] = None  # AWS fan-out (reference :278-342), optional
    bucket: Optional[str] = None
    # Area-guarded bisection + throttling (reference flickr_search.py:85-99:
    # boxes above max_area split without querying; boxes below min_area stop
    # splitting regardless of count; time_delay sleeps between API calls).
    max_area_m2: float = 5.0e8
    min_area_m2: float = 1.0e4
    time_delay: float = 1.0
    # Search filters (reference flickr_search.py:18-21).
    privacy_filter: int = 1   # public only
    content_type: int = 1     # photos only
    geo_context: int = 0      # 0=all, 1=indoor, 2=outdoor
    # Preferred URL size field (reference config.yaml: url_m). The scraper
    # requests url_o AND url_m; consumers fall back across both.
    url_field: str = "url_o"

    @classmethod
    def from_yaml(cls, path: str) -> "ScraperConfig":
        """Load either this module's flat schema or the REFERENCE's
        config.yaml (tools/download/flickr/config.yaml): cities as a list of
        {name, bounding_boxes} entries with 'NN_name' codes, and the
        reference key names (density_limit/page_size/min_area/max_area)."""
        import warnings

        aliases = {
            "density_limit": "max_per_box",
            "page_size": "per_page",
            "max_area": "max_area_m2",
            "min_area": "min_area_m2",
        }
        ignored = {"refresh_metadata"}  # reference keys with no analogue here
        with open(path) as f:
            raw = load_scraper_yaml(f.read())
        cfg = cls()
        for key, val in raw.items():
            if key == "cities":
                if isinstance(val, dict):
                    cfg.cities = {k: tuple(v) for k, v in val.items()}
                else:
                    # reference shape: [{name: "01_rio",
                    #                    bounding_boxes: [[...]], ...}, ...]
                    cities = {}
                    for entry in val:
                        name = str(entry.get("name", ""))
                        head, _, tail = name.partition("_")
                        if head.isdigit() and tail:
                            name = tail
                        boxes = entry.get("bounding_boxes") or []
                        if name and boxes:
                            cities[name] = tuple(boxes[0])
                    cfg.cities = cities
            elif key in aliases:
                setattr(cfg, aliases[key], val)
            elif hasattr(cfg, key):
                setattr(cfg, key, val)
            elif key not in ignored:
                warnings.warn(f"unknown scraper config key {key!r} ignored",
                              stacklevel=2)
        return cfg
