"""CSV pair registry (port of witw_tpu/data/csv_registry.py, without pandas).

Reads the (surface, overhead) image-path pairs from a dataset CSV in either
reference schema (reference model/cvig_fov.py:54-97): CVUSA headerless with
[overhead, surface] at columns 0/1; WITW 17-column with a header row,
columns 15/16 = [surface, overhead]. Relative paths are resolved against the
CSV's directory (or an explicit base path). Semantic datasets read the
``.tif`` siblings of the listed paths (reference cvig_semantic.py:89-90).
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

from witw_tpu_torch.configs.base import DatasetConfig


def read_rows(csv_path: str, header: Optional[int]) -> Tuple[Optional[List[str]], List[List[str]]]:
    """(the header row or None, the data rows) of a CSV; blank lines are
    skipped, as pandas skips them. ``header`` is the header row's index
    among the non-blank lines (None: headerless)."""
    with open(csv_path, newline="") as f:
        rows = [row for row in csv.reader(f) if row]
    if header is None:
        return None, rows
    return rows[header], rows[header + 1:]


def read_pair_paths(
    dataset: DatasetConfig,
    csv_path: str,
    base_path: Optional[str] = None,
) -> List[Tuple[str, str]]:
    """Return [(surface_path, overhead_path), ...] with absolute paths."""
    base = base_path if base_path is not None else os.path.dirname(csv_path)
    _, rows = read_rows(csv_path, dataset.header)
    col = dict(zip(dataset.path_names, dataset.path_columns))

    def absolutize(p: str) -> str:
        return os.path.join(base, p) if p and p[0] != "/" else p

    pairs = []
    for row in rows:
        surface = absolutize(row[col["surface"]])
        overhead = absolutize(row[col["overhead"]])
        if dataset.semantic:
            surface = os.path.splitext(surface)[0] + ".tif"
            overhead = os.path.splitext(overhead)[0] + ".tif"
        pairs.append((surface, overhead))
    return pairs
