"""Tab-separated tables without pandas.

The JAX package reads every TSV (DESED event tables, durations, score
tables) with ``pd.read_csv(path, sep="\\t")`` and writes score tables with
``DataFrame.to_csv(sep="\\t", index=False)``. The card's machine has no
pandas, so the port reads and writes them here, with what its callers take
from pandas: named columns; a column whose every present cell is a number
is float64; a missing cell (empty, or one of pandas' default missing
markers) is NaN; other columns hold ``str`` with NaN where a cell is
missing. Rows keep the file's order. Quoted fields are not read. Numbers
are read by Python's ``float``, correctly rounded, where pandas' default
parser can be one unit in the last place off on a long decimal.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

# pandas' default ``na_values`` (``pandas._libs.parsers.STR_NA_VALUES``)
MISSING = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _number(cell: str) -> float:
    return math.nan if cell in MISSING else float(cell)


class Table:
    """Named columns of equal length, in the file's column order."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns: List[str] = list(columns)
        self._data = dict(columns)
        lengths = {len(v) for v in self._data.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")

    def __len__(self) -> int:
        return len(self._data[self.columns[0]]) if self.columns else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self._data[name]

    def rows(self) -> Iterator[Dict]:
        """One dict per row, column name -> cell (``DataFrame.iterrows``)."""
        for i in range(len(self)):
            yield {c: self._data[c][i] for c in self.columns}

    def take(self, idx: Sequence[int]) -> "Table":
        idx = np.asarray(idx, dtype=np.int64)
        return Table({c: self._data[c][idx] for c in self.columns})

    def groupby(self, name: str) -> Iterator[Tuple[object, "Table"]]:
        """(key, rows with that key) in sorted key order, rows in file order
        (``DataFrame.groupby(name)``; rows whose key is missing are dropped)."""
        groups: Dict[object, List[int]] = {}
        for i, key in enumerate(self._data[name]):
            if not (isinstance(key, float) and math.isnan(key)):
                groups.setdefault(key, []).append(i)
        for key in sorted(groups):
            yield key, self.take(groups[key])

    def to_numpy(self, dtype=None) -> np.ndarray:
        """[rows, columns]: float64 when every column is, else object."""
        cols = [self._data[c] for c in self.columns]
        if dtype is None and any(c.dtype == object for c in cols):
            dtype = object
        return np.stack(cols, axis=1).astype(dtype or np.float64) if cols else np.zeros((0, 0))


def read_tsv(path: str) -> Table:
    """``pd.read_csv(path, sep="\\t")`` for plain tab-separated files."""
    with open(path, newline="") as f:
        lines = f.read().splitlines()
    lines = [line for line in lines if line]  # pandas skips blank lines
    if not lines:
        raise ValueError(f"{path}: no header line")
    header = lines[0].split("\t")
    cells = [line.split("\t") for line in lines[1:]]
    for n, row in enumerate(cells, start=2):
        if len(row) > len(header):
            raise ValueError(f"{path}:{n}: {len(row)} fields, header has {len(header)}")
        row.extend([""] * (len(header) - len(row)))
    columns = {}
    for j, name in enumerate(header):
        raw = [row[j] for row in cells]
        try:
            columns[name] = np.asarray([_number(c) for c in raw], dtype=np.float64)
        except ValueError:
            columns[name] = np.asarray(
                [math.nan if c in MISSING else c for c in raw], dtype=object
            )
    return Table(columns)


def _cell(value) -> str:
    if isinstance(value, str):
        return value
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else repr(float(value))
    return str(value)


def write_tsv(path: str, columns: Sequence[str], rows) -> None:
    """Write ``rows`` (a [n, len(columns)] array or sequences) under a header
    line, as ``DataFrame(rows, columns=columns).to_csv(path, sep="\\t",
    index=False)`` writes float64 and string cells: floats in their
    shortest round-trip form, missing cells empty."""
    with open(path, "w", newline="") as f:
        f.write("\t".join(columns) + "\n")
        for row in rows:
            if len(row) != len(columns):
                raise ValueError(f"a row of {len(row)} cells under {len(columns)} columns")
            f.write("\t".join(_cell(v) for v in row) + "\n")
