"""Blank-fraction check CLI (port of witw_tpu/tools/zero_frac.py).

Prints the fraction of pixels that are zero in all bands for each raster —
the dataset pipeline's blank-tile filter input (reference
tools/dataset_building/zero_frac.py:1-17, which uses gdalnumeric; this uses
the native reader and counts on the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse

from witw_tpu_torch.tools.convert_8bit import zero_fraction
from witw_tpu_torch.tools.geotiff import GeoTiff


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fraction of all-band-zero pixels")
    parser.add_argument("paths", nargs="+")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run on the host)")
    args = parser.parse_args(argv)
    for path in args.paths:
        with GeoTiff(path) as tif:
            print(f"{zero_fraction(tif.read(), device=args.device):.6f} {path}")


if __name__ == "__main__":
    main()
