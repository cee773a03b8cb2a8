"""Geographic density limiter (port of witw_tpu/tools/density.py, on the
port's tables).

Greedy thinning: per AOI, keep a shuffled photo only if its haversine
distance to every already-kept photo is at least `threshold` meters
(reference tools/dataset_building/limit_density.py:27-63). The AOIs go in
sorted order and each is shuffled by a fresh ``np.random.RandomState(seed)``
as witw_tpu's ``groupby("aoi")`` and ``group.sample(frac=1.0,
random_state=seed)`` do. The distances run in f64 on ``device`` (the card
unless ``device="cpu"``) a block of candidates at a time: one device
round trip a block gives each candidate's distances to every photo kept
before the block and to the block's earlier candidates, and the host walks
the block in order.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from witw_tpu_torch.data.csv_registry import (Table, concat_tables, read_table, table_len,
                                              take_rows, write_table)
from witw_tpu_torch.utils.device import resolve_device

EARTH_RADIUS_M = 6371008.8
BLOCK = 512  # candidates decided per device round trip


def haversine_m(lat1, lon1, lat2, lon2) -> torch.Tensor:
    """Great-circle distance in meters between (lat1, lon1) and (lat2,
    lon2), broadcast; f64 tensors (witw_tpu's numpy formula)."""
    rad = math.pi / 180.0
    lat1, lon1 = lat1 * rad, lon1 * rad
    lat2, lon2 = lat2 * rad, lon2 * rad
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = torch.sin(dlat / 2) ** 2 + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_M * torch.arcsin(torch.sqrt(a))


def _thin(lat: torch.Tensor, lon: torch.Tensor, threshold_m: float) -> np.ndarray:
    """The keep mask of the greedy scan over (lat, lon) in order."""
    n = lat.numel()
    keep = np.zeros(n, bool)
    kept = torch.zeros(0, dtype=torch.long, device=lat.device)
    for start in range(0, n, BLOCK):
        stop = min(n, start + BLOCK)
        c_lat, c_lon = lat[start:stop, None], lon[start:stop, None]
        # row i: candidate start + i against the kept photos, then against
        # the block's candidates (only earlier ones are read); both with
        # witw_tpu's ``d >= threshold``, which a NaN distance fails
        far_kept = (haversine_m(c_lat, c_lon, lat[kept][None], lon[kept][None])
                    >= threshold_m).all(dim=1)
        far_block = haversine_m(c_lat, c_lon, lat[None, start:stop],
                                lon[None, start:stop]) >= threshold_m
        far_kept, far_block = far_kept.cpu().numpy(), far_block.cpu().numpy()
        chosen = []
        for i in range(stop - start):
            if far_kept[i] and far_block[i, chosen].all():
                chosen.append(i)
        keep[[start + i for i in chosen]] = True
        kept = torch.cat([kept, torch.tensor(chosen, dtype=torch.long, device=lat.device) + start])
    return keep


def limit_density(table: Table, threshold_m: float = 10.0, seed: int = 0,
                  device=None) -> Table:
    """Thin the table per AOI so no two kept photos are closer than
    threshold_m. Order is shuffled (seeded) like the reference."""
    device = resolve_device(device)
    aois = table["aoi"]
    present = np.array([not (isinstance(a, float) and math.isnan(a)) for a in aois], bool)
    parts = []
    for aoi in sorted(set(aois[present].tolist())):
        rows = np.flatnonzero(present & (aois == aoi))
        rows = rows[np.random.RandomState(seed).choice(len(rows), size=len(rows), replace=False)]
        group = take_rows(table, rows)
        lat = torch.as_tensor(np.asarray(group["latitude"], np.float64), device=device)
        lon = torch.as_tensor(np.asarray(group["longitude"], np.float64), device=device)
        parts.append(take_rows(group, _thin(lat, lon, threshold_m)))
    return concat_tables(parts)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Thin photos by geographic density")
    parser.add_argument("--csv", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--threshold", type=float, default=10.0, help="meters")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run on the host)")
    args = parser.parse_args(argv)
    table = read_table(args.csv)
    out = limit_density(table, args.threshold, device=args.device)
    write_table(args.out, out)
    print(f"kept {table_len(out)}/{table_len(table)} photos")


if __name__ == "__main__":
    main()
