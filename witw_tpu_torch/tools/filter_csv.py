"""CSV row filter by ID list (port of witw_tpu/tools/filter_csv.py, on the
port's tables instead of pandas frames).

Replaces the reference's bash + `look -b` binary-search filter
(reference tools/dataset_building/filter_csv:1-35) with a set lookup.
"""

from __future__ import annotations

import argparse
from typing import Iterable, Set

import numpy as np

from witw_tpu_torch.data.csv_registry import Table, read_table, table_len, take_rows, write_table


def load_id_set(path: str) -> Set[str]:
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def filter_frame(table: Table, ids: Iterable[str], mode: str = "retain",
                 id_column: str = "id") -> Table:
    """The rows whose ``id_column`` (as a string, as pandas' ``astype(str)``
    writes it) is in ``ids`` ('retain') or is not ('remove')."""
    ids = set(str(i) for i in ids)
    member = np.array([str(v) in ids for v in table[id_column]], bool)
    if mode == "retain":
        return take_rows(table, member)
    if mode == "remove":
        return take_rows(table, ~member)
    raise ValueError(mode)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Retain/remove CSV rows by id list")
    parser.add_argument("mode", choices=["retain", "remove"])
    parser.add_argument("--csv", required=True)
    parser.add_argument("--ids", required=True, help="file with one id per line")
    parser.add_argument("--out", required=True)
    parser.add_argument("--id-column", default="id")
    args = parser.parse_args(argv)
    table = read_table(args.csv)
    out = filter_frame(table, load_id_set(args.ids), args.mode, args.id_column)
    write_table(args.out, out)
    print(f"{args.mode}: {table_len(out)}/{table_len(table)} rows")


if __name__ == "__main__":
    main()
