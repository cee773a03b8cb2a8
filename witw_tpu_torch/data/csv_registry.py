"""CSV pair registry (port of witw_tpu/data/csv_registry.py, without pandas).

Reads the (surface, overhead) image-path pairs from a dataset CSV in either
reference schema (reference model/cvig_fov.py:54-97): CVUSA headerless with
[overhead, surface] at columns 0/1; WITW 17-column with a header row,
columns 15/16 = [surface, overhead]. Relative paths are resolved against the
CSV's directory (or an explicit base path). Semantic datasets read the
``.tif`` siblings of the listed paths (reference cvig_semantic.py:89-90).

Also the port's table, which stands where witw_tpu's dataset tools hold a
pandas DataFrame: an ordered dict of equal-length numpy columns
(:data:`Table`), read from and written to CSV as ``pandas.read_csv`` and
``DataFrame.to_csv(index=False)`` read and write such a file.
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

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


Table = Dict[str, np.ndarray]

# The cells pandas.read_csv reads as missing (its default na_values).
_NA = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
                 "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"])
_INT = re.compile(r"[-+]?[0-9]+")
_DECIMAL = re.compile(r"\s*([-+]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([-+]?[0-9]+))?\s*")
_POW10 = [float(f"1e{i}") for i in range(309)]


def _parse_float(text: str) -> float:
    """A decimal as pandas.read_csv's default parser reads it (pandas'
    ``precise_xstrtod``: the first 17 digits accumulated in a double, then
    one product or quotient by a power of ten), which is not always
    correctly rounded: a 17-digit value can land one ulp away from
    ``float(text)``. Other spellings (inf, nan) go through ``float``."""
    m = _DECIMAL.fullmatch(text)
    if m is None or not (m.group(2) or m.group(3)):
        return float(text)
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for c in whole:
        if digits < 17:
            number = number * 10.0 + (ord(c) - 48)
            digits += 1
        else:
            exponent += 1
    for c in (frac or "")[:max(0, 17 - digits)]:
        number = number * 10.0 + (ord(c) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp) if exp else 0
    if exponent > 308:
        return math.copysign(math.inf, number) if number else number
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 * number if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
         "false": False}


def _column(cells: Sequence[str]) -> np.ndarray:
    """One column's cells typed as pandas.read_csv types them: int64, then
    bool, then float64 (missing cells NaN), else strings (missing NaN)."""
    present = [c for c in cells if c not in _NA]
    if present and len(present) == len(cells):
        if all(_INT.fullmatch(c) for c in present) and all(
                -2 ** 63 <= int(c) < 2 ** 63 for c in present):
            return np.array([int(c) for c in cells], np.int64)
        if all(c in _BOOL for c in present):
            return np.array([_BOOL[c] for c in cells], bool)
    try:
        return np.array([math.nan if c in _NA else _parse_float(c) for c in cells], np.float64)
    except ValueError:
        return np.array([math.nan if c in _NA else c for c in cells], object)


def read_table(csv_path: str) -> Table:
    """A CSV with a header row as a :data:`Table`."""
    header, rows = read_rows(csv_path, 0)
    return {name: _column([row[i] if i < len(row) else "" for row in rows])
            for i, name in enumerate(header)}


def _cell(v) -> str:
    if v is None or (isinstance(v, (float, np.floating)) and math.isnan(v)):
        return ""
    if isinstance(v, (float, np.floating)):
        return str(np.float64(v))  # the shortest repr, as pandas writes floats
    return str(v)


def write_table(csv_path: str, table: Table) -> None:
    """The table as ``DataFrame(table).to_csv(csv_path, index=False)``
    writes it: a header row, floats as their shortest repr, an empty field
    for a missing value."""
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(table))
        writer.writerows(zip(*([_cell(v) for v in col] for col in table.values())))


def table_len(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def take_rows(table: Table, index) -> Table:
    """The rows that ``index`` (positions or a boolean mask) selects, in
    its order."""
    index = np.asarray(index)
    if index.dtype != bool:
        index = index.astype(np.intp)
    return {k: v[index] for k, v in table.items()}


def concat_tables(tables: Sequence[Table]) -> Table:
    """The tables' rows one after another (every table has the first's
    columns)."""
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def iter_rows(table: Table) -> Iterator[dict]:
    """Each row as a dict of column -> value."""
    names = list(table)
    for values in zip(*table.values()):
        yield dict(zip(names, values))
