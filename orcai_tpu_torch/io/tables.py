"""Tables without pandas: the CSVs of the data chain and of evaluation.

A `Table` is an optional list of row labels and an ordered dict of numpy
columns. `read_csv` gives each column the type `pandas.read_csv` infers for
these tables (int64, float64 where a numeric column has blanks, bool, else
object cells of str / bool with None for a missing cell), and `to_csv`
writes the text that `DataFrame.to_csv` writes: floats as their shortest
float64 text, a missing value as an empty cell, bool as True/False, the
row labels first when the table has them, and a `.gz` path through gzip.
The JAX package reads and writes the same files with pandas.
"""

from __future__ import annotations

import csv
import gzip
import io
import re
from pathlib import Path

import numpy as np

# pandas.read_csv's default missing-value tokens
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|Inf|INF|infinity|Infinity)\Z")


_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def parse_float(text: str) -> float:
    """A float cell as pandas.read_csv reads it by default (its "high"
    precision parser, precise_xstrtod): up to 17 significant digits are
    accumulated in a double, number * 10 + digit, and the result is scaled
    by one power of ten. This is not always the correctly rounded value
    that float() gives: 0.005333333333333333 * k written with repr can read
    back one unit in the last place off, and the reference's tables carry
    that value on."""
    t = text.strip()
    if t.lower().lstrip("+-") in ("inf", "infinity"):
        return float(t)
    p, n = 0, len(t)
    negative = False
    if p < n and t[p] in "+-":
        negative = t[p] == "-"
        p += 1
    number, exponent, num_digits = 0.0, 0, 0
    while p < n and t[p].isdigit():
        if num_digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(t[p]) - 48)
            num_digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and t[p] == ".":
        p += 1
        num_decimals = 0
        while num_digits < _MAX_DIGITS and p < n and t[p].isdigit():
            number = number * 10.0 + (ord(t[p]) - 48)
            p += 1
            num_digits += 1
            num_decimals += 1
        while p < n and t[p].isdigit():
            p += 1
        exponent -= num_decimals
    if negative:
        number = -number
    if p < n and t[p] in "eE":
        p += 1
        sign = 1
        if p < n and t[p] in "+-":
            sign = -1 if t[p] == "-" else 1
            p += 1
        e, e_digits = 0, 0
        while e_digits < _MAX_DIGITS and p < n and t[p].isdigit():
            e = e * 10 + (ord(t[p]) - 48)
            e_digits += 1
            p += 1
        exponent += sign * e
    if exponent > 308:
        return float("-inf") if negative else float("inf")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_column(cells: list[str]) -> np.ndarray:
    """One column's text cells -> the numpy column pandas would infer."""
    missing = [c in NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not present:
        return np.full(len(cells), np.nan)
    if all(_INT.match(c) for c in present):
        if not any(missing):
            return np.array([int(c) for c in cells], dtype=np.int64)
        return np.array([np.nan if m else float(c) for c, m in zip(cells, missing)])
    if all(_FLOAT.match(c) for c in present):
        return np.array([np.nan if m else parse_float(c) for c, m in zip(cells, missing)])
    if all(c in _TRUE or c in _FALSE for c in present):
        if not any(missing):
            return np.array([c in _TRUE for c in cells], dtype=bool)
        return object_column([None if m else c in _TRUE for c, m in zip(cells, missing)])
    return object_column([None if m else c for c, m in zip(cells, missing)])


def object_column(values) -> np.ndarray:
    """A 1-D object array holding `values` as they are (str, bool, None)."""
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def isna(column: np.ndarray) -> np.ndarray:
    """Missing cells: NaN in a float column, None or NaN in an object one."""
    column = np.asarray(column)
    if column.dtype.kind == "f":
        return np.isnan(column)
    if column.dtype == object:
        return np.array([v is None or (isinstance(v, float) and v != v) for v in column],
                        dtype=bool)
    return np.zeros(column.shape, dtype=bool)


def cell_text(value) -> str:
    """A cell as DataFrame.to_csv writes it."""
    if value is None:
        return ""
    if isinstance(value, (bool, np.bool_)):
        return "True" if value else "False"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        value = float(value)
        # the shortest text that reads back as the same float64; NaN is empty
        return "" if value != value else repr(value)
    return str(value)


def _open_text(path: Path | str, mode: str):
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, mode + "b"), encoding="utf-8", newline="")
    return open(path, mode, newline="", encoding="utf-8")


class Table:
    """Row labels (or None) plus named numpy columns of one length."""

    def __init__(self, index: list | None, columns: dict[str, np.ndarray],
                 index_name: str | None = None):
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        n = len(index) if index is not None else (
            len(next(iter(self.columns.values()))) if self.columns else 0)
        self.index = list(index) if index is not None else None
        self.index_name = index_name
        for name, col in self.columns.items():
            if col.shape != (n,):
                raise ValueError(f"column {name} has shape {col.shape}, expected ({n},)")
        self._n = n

    # -- access ---------------------------------------------------------------

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __setitem__(self, name: str, values) -> None:
        col = np.asarray(values)
        if col.ndim == 0:
            col = object_column([values] * self._n) if isinstance(values, str) or values is None \
                else np.full(self._n, values)
        if col.shape != (self._n,):
            raise ValueError(f"column {name} has shape {col.shape}")
        self.columns[name] = col

    @property
    def names(self) -> list[str]:
        return list(self.columns)

    def row(self, label) -> dict:
        i = self.index.index(label)
        return {k: v[i] for k, v in self.columns.items()}

    def records(self):
        """Each row as a dict of its cells (the row labels are not in it)."""
        for i in range(self._n):
            yield {k: v[i] for k, v in self.columns.items()}

    def take(self, order) -> "Table":
        """The rows at positions `order` (an index array or a boolean mask)."""
        order = np.asarray(order)
        if order.dtype == bool:
            order = np.flatnonzero(order)
        order = order.astype(np.int64)
        index = None if self.index is None else [self.index[i] for i in order]
        return Table(index, {k: v[order] for k, v in self.columns.items()}, self.index_name)

    def select(self, names: list[str]) -> "Table":
        return Table(self.index, {k: self.columns[k] for k in names}, self.index_name)

    @staticmethod
    def concat(tables: list["Table"]) -> "Table":
        """Rows of `tables` one after another (same columns, no row labels)."""
        names = tables[0].names
        columns = {}
        for k in names:
            parts = [t[k] for t in tables]
            kinds = {p.dtype.kind for p in parts}
            columns[k] = (np.concatenate(parts) if len(kinds) == 1 and "O" not in kinds
                          else object_column([v for p in parts for v in p]))
        return Table(None, columns)

    # -- text -----------------------------------------------------------------

    @classmethod
    def read_csv(cls, path: Path | str, index_col: str | None = None,
                 sep: str = ",", header: list[str] | None = None) -> "Table":
        """Read a CSV (gzip where the path ends in .gz). `header` names the
        columns of a file without a header line."""
        with _open_text(path, "r") as f:
            rows = list(csv.reader(f, delimiter=sep))
        if header is None:
            if not rows:
                raise ValueError(f"No columns to parse from file {path}")
            header, rows = rows[0], rows[1:]
        rows = [r for r in rows if r]
        if not rows and not header:
            raise ValueError(f"No columns to parse from file {path}")
        width = len(header)
        rows = [r + [""] * (width - len(r)) if len(r) < width else r[:width] for r in rows]
        cells = list(zip(*rows)) if rows else [()] * width
        columns = {name: _parse_column(list(c)) for name, c in zip(header, cells)}
        if index_col is None:
            return cls(None, columns)
        index = columns.pop(index_col)
        return cls(list(index), columns, index_name=index_col)

    def rows(self, index: bool = True):
        for i in range(self._n):
            cells = [cell_text(col[i]) for col in self.columns.values()]
            yield ([cell_text(self.index[i])] + cells) if index else cells

    def to_csv(self, path: Path | str, index: bool | None = None,
               index_label: str | None = None) -> None:
        """Write the table as DataFrame.to_csv would (gzip for a .gz path);
        the row labels go first unless index=False or there are none."""
        index = self.index is not None if index is None else index
        with _open_text(path, "w") as f:
            writer = csv.writer(f, lineterminator="\n")
            label = index_label if index_label is not None else (self.index_name or "")
            writer.writerow(([label] if index else []) + self.names)
            writer.writerows(self.rows(index))

    def __str__(self) -> str:
        lines = ["\t".join(([""] if self.index is not None else []) + self.names)]
        lines += ["\t".join(r) for r in self.rows(self.index is not None)]
        return "\n".join(lines)

    def to_string(self) -> str:
        """The table as pandas' DataFrame.to_string lays it out: the row
        labels left-justified (their name on a row of its own), each column
        right-justified under its name (a numeric column's name after a
        space), one space between columns."""
        index = [str(v) for v in (self.index if self.index is not None else range(self._n))]
        columns = []
        for name, col in self.columns.items():
            cells = _display_cells(col)
            header = f" {name}" if col.dtype.kind in "biuf" else name  # numeric: a sign's space
            width = max([len(header), *map(len, cells)])
            columns.append([header.rjust(width)] + [c.rjust(width) for c in cells])
        width = max([len(self.index_name or ""), *map(len, index)])
        lines = [" " * width + "".join(" " + c[0] for c in columns)]
        if self.index_name:
            lines.append(self.index_name.ljust(width)
                         + "".join(" " + " " * len(c[0]) for c in columns))
        lines += [index[i].ljust(width) + "".join(" " + c[i + 1] for c in columns)
                  for i in range(self._n)]
        return "\n".join(lines)


class Counts(Table):
    """Rows counted per value of a column, as pandas'
    `table.groupby(key).size()` gives them (the values sorted); printed as
    that Series prints."""

    def __init__(self, table: Table, key: str):
        groups, counts = np.unique(np.asarray(table[key], dtype=object).astype(str),
                                   return_counts=True)
        super().__init__(list(groups), {"": counts.astype(np.int64)}, index_name=key)

    def to_string(self) -> str:
        cells = _display_cells(self.columns[""])
        width = max(map(len, cells), default=0)
        labels = [str(v) for v in self.index]
        label_width = max(map(len, labels), default=0)
        return "\n".join([self.index_name] + [
            label.ljust(label_width) + "   " + cell.rjust(width)
            for label, cell in zip(labels, cells)])


_DECIMAL_TEXT = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")


def _trim_zeros(cells: list[str]) -> list[str]:
    """pandas' _trim_zeros_float: drop trailing zeros from every decimal
    number of a column alike, keeping one digit after the point."""
    def trimmable(values):
        numbers = [x for x in values if _DECIMAL_TEXT.match(x)]
        return bool(numbers) and all(x.endswith("0") for x in numbers)

    while trimmable(cells):
        cells = [x[:-1] if _DECIMAL_TEXT.match(x) else x for x in cells]
    return [x + "0" if _DECIMAL_TEXT.match(x) and x.endswith(".") else x for x in cells]


def _display_cells(col: np.ndarray) -> list[str]:
    """A column's cells as pandas' to_string formats them at its default
    precision of 6: a space where a sign would go, floats to 6 decimals
    with the column's common trailing zeros trimmed (in e-notation where a
    value is under 1e-6, or over 1e6 in a column that grows too wide),
    NaN as NaN."""
    if col.dtype.kind == "f":
        values = col.astype(np.float64)
        nan = np.isnan(values)

        def cells(spec: str) -> list[str]:
            return _trim_zeros(["NaN" if m else spec.format(v) for v, m in zip(values, nan)])

        out = cells("{: .6f}")
        size = np.abs(values[~nan])
        too_long = max(map(len, out), default=0) > 6 + 6
        if ((size < 1e-6) & (size > 0)).any() or (too_long and (size > 1e6).any()):
            out = cells("{: .6e}")
        return out
    if col.dtype.kind in "iu":
        return [f"{int(v): d}" for v in col]
    return ["NaN" if isinstance(v, float) and v != v else f" {v}" for v in col]
