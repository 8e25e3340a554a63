"""Atomic-file reader (.inter/.user/.item typed TSVs), numpy only.

Port of `oovrec_tpu/data/atomic.py:19-106`: the first line holds one
``field:type`` cell per column, with the types token / float / token_seq
/ float_seq; sequence cells are `seq_separator`-joined values.

The JAX package reads the file with `pandas.read_csv` (or its native
reader where that serves), and this reader keeps pandas' semantics:
  * a cell that pandas reads as missing (empty, ``NA``, ``NaN``, ``null``,
    ... `NA_VALUES`) is NaN in a float column and None in a token column
    (pandas' NaN, which the dataset's remap turns into the token
    ``"nan"``, as `astype(str)` does in the JAX package); a sequence cell
    that is missing is an empty sequence;
  * floats go through Python's `float`, which rounds correctly; the
    pandas C parser's "high" converter agrees with it on every file of
    the repo (`tests/test_torch_dataset.py` holds them bit for bit);
  * empty lines are skipped, short rows are filled with missing cells,
    and a file with a double quote is split by `csv`, which unquotes as
    `read_csv` does.
"""

from __future__ import annotations

import csv
import io
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from oovrec_tpu_torch.utils.enums import FeatureType

# the strings `pandas.read_csv` reads as missing by default
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})

Columns = Dict[str, np.ndarray]


def _rows(text: str, sep: str, n_cols: int) -> List[List[str]]:
    """The body's rows, each of `n_cols` cells (short rows padded with
    empty, that is missing, cells)."""
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    if '"' in text:
        reader = csv.reader(io.StringIO(text), delimiter=sep, quotechar='"')
        rows = [r for r in reader if r]
    else:
        rows = [line.split(sep) for line in text.split("\n") if line]
    for i, r in enumerate(rows):
        if len(r) != n_cols:
            if len(r) > n_cols:
                raise ValueError(f"row {i + 2} has {len(r)} cells, the header {n_cols}")
            rows[i] = r + [""] * (n_cols - len(r))
    return rows


def _float_column(cells) -> np.ndarray:
    try:
        return np.array(cells, dtype=np.float64)
    except ValueError:
        return np.array(
            [float("nan") if c in NA_VALUES else float(c) for c in cells],
            dtype=np.float64,
        )


def load_atomic_file(
    filepath: str,
    field_separator: str = "\t",
    seq_separator: str = " ",
    load_col: Optional[Set[str]] = None,
    unload_col: Optional[Set[str]] = None,
    encoding: str = "utf-8",
) -> Tuple[Columns, Dict[str, FeatureType]]:
    """Load one atomic file → (columns, field → type of the loaded ones).

    Columns in header order: token columns as object arrays of str (None
    where missing), float columns as float64, sequence columns as object
    arrays of per-row arrays (tokens as str arrays, floats as float64)."""
    with open(filepath, "r", encoding=encoding) as f:
        head = f.readline().rstrip("\n")
        body = f.read()

    header = head.split(field_separator)
    picked: List[Tuple[int, str, FeatureType]] = []
    for j, field_type in enumerate(header):
        field, _, ftype_s = field_type.partition(":")
        ftype = FeatureType(ftype_s)
        if load_col is not None and field not in load_col:
            continue
        if unload_col is not None and field in unload_col:
            continue
        picked.append((j, field, ftype))
    if not picked:
        return {}, {}

    rows = _rows(body, field_separator, len(header))
    out: Columns = {}
    field2type: Dict[str, FeatureType] = {}
    for j, field, ftype in picked:
        cells = [r[j] for r in rows]
        field2type[field] = ftype
        if ftype == FeatureType.FLOAT:
            out[field] = _float_column(cells)
        elif ftype == FeatureType.TOKEN:
            col = np.empty(len(cells), dtype=object)
            col[:] = [None if c in NA_VALUES else c for c in cells]
            out[field] = col
        else:
            col = np.empty(len(cells), dtype=object)
            for i, c in enumerate(cells):
                parts = [] if c in NA_VALUES else list(filter(None, c.split(seq_separator)))
                if ftype == FeatureType.TOKEN_SEQ:
                    col[i] = np.array(parts)
                else:
                    col[i] = np.array(list(map(float, parts)), dtype=np.float64)
            out[field] = col
    return out, field2type
