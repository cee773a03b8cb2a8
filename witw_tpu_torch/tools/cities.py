"""SpaceNet AOI registry (a copy of witw_tpu/tools/cities.py).

The 11 SpaceNet city strips the WITW dataset is built from, with their UTM
EPSG codes, satellite sources and imagery licenses (reference
tools/dataset_building/sitetiles.py:15-80 and
tools/dataset_building/reproject_strips.py:10-36).
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class City:
    index: int
    name: str
    fullname: str
    epsg: int            # UTM zone EPSG for the reprojected strip
    satellite: str       # WorldView-2 / WorldView-3 (per AOI)
    license: str


CITIES: Dict[str, City] = {
    c.name: c
    for c in [
        City(1, "rio", "Rio de Janeiro", 32723, "WorldView-2", "CC BY-SA 4.0"),
        City(2, "vegas", "Las Vegas", 32611, "WorldView-3", "CC BY-SA 4.0"),
        City(3, "paris", "Paris", 32631, "WorldView-3", "CC BY-SA 4.0"),
        City(4, "shanghai", "Shanghai", 32651, "WorldView-3", "CC BY-SA 4.0"),
        City(5, "khartoum", "Khartoum", 32636, "WorldView-3", "CC BY-SA 4.0"),
        City(6, "atlanta", "Atlanta", 32616, "WorldView-2", "CC BY-SA 4.0"),
        # AOIs 7-10 are WorldView-3 like 2-5 (reference sitetiles.py:114-118:
        # WV-2 is only AOIs 1, 6, 11; value strings match the reference
        # CSV's satellite column); San Juan is UTM zone 20N (reference
        # reproject_strips.py:33: 32620 — lon ~ -66 is zone 20)
        City(7, "moscow", "Moscow", 32637, "WorldView-3", "CC BY-SA 4.0"),
        City(8, "mumbai", "Mumbai", 32643, "WorldView-3", "CC BY-SA 4.0"),
        City(9, "san", "San Juan", 32620, "WorldView-3", "CC BY-SA 4.0"),
        City(10, "dar", "Dar es Salaam", 32737, "WorldView-3", "CC BY-SA 4.0"),
        City(11, "rotterdam", "Rotterdam", 32631, "WorldView-2", "CC BY-SA 4.0"),
    ]
}

# Strip filename convention used by the tools: {index:02d}_{name}.tif
def strip_filename(name: str) -> str:
    c = CITIES[name]
    return f"{c.index:02d}_{c.name}.tif"


# Test split: Paris is the held-out test city; the other 10 train
# (reference tools/dataset_building/build_dataset:59-63).
TEST_CITIES = ("paris",)
