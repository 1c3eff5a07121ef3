"""CSV reader/writer (reference parallel CSV reader,
src/execution/operator/persistent/csv_reader + COPY TO/FROM,
src/execution/operator/persistent/physical_copy_*.cpp). Port of
adacom_tpu/io/csv_io.py: host code over numpy; COPY TO writes the same
bytes as the JAX package.

Reading is chunk-parallel: the file is split at newline boundaries into one
byte-range per worker thread; each worker parses its range independently and
column conversion happens vectorized per chunk (numpy), so the Python-level
work is bounded by the csv module's C tokenizer. Type inference runs the
reference's sniffing order on a sample: BIGINT -> DOUBLE -> DATE -> VARCHAR.
"""

from __future__ import annotations

import csv
import io
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from adacom_tpu_torch import types as tt

_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")


def _split_ranges(data: bytes, n_chunks: int) -> List[Tuple[int, int]]:
    n = len(data)
    if n == 0:
        return []
    bounds = [0]
    for k in range(1, n_chunks):
        pos = min(n, k * n // n_chunks)
        nl = data.find(b"\n", pos)
        if nl == -1:
            break
        bounds.append(nl + 1)
    bounds.append(n)
    out = []
    for a, z in zip(bounds, bounds[1:]):
        if z > a:
            out.append((a, z))
    return out


def _parse_chunk(data: bytes, rng: Tuple[int, int], delim: str) -> List[List[str]]:
    text = data[rng[0]: rng[1]].decode("utf-8", errors="replace")
    return list(csv.reader(io.StringIO(text), delimiter=delim))


def _infer_type(samples: List[str]):
    """Reference CSV sniffer order: BIGINT -> DOUBLE -> DATE -> VARCHAR."""
    non_empty = [s for s in samples if s != ""]
    if not non_empty:
        return tt.VARCHAR
    try:
        for s in non_empty:
            int(s)
        return tt.BIGINT
    except ValueError:
        pass
    try:
        for s in non_empty:
            float(s)
        return tt.DOUBLE
    except ValueError:
        pass
    if all(_DATE_RE.match(s) for s in non_empty):
        return tt.DATE
    return tt.VARCHAR


def read_csv(path: str, header: Optional[bool] = None, delim: str = ",",
             threads: int = 0, types: Optional[List] = None):
    """Parse a CSV file.

    Returns (names, types, columns, validity) with columns as python lists
    of str cells converted per inferred type: numeric columns become numpy
    arrays, VARCHAR stays a list of str, DATE becomes days-since-epoch.
    With `types` (COPY FROM into a table: one logical type per column),
    column i is parsed as types[i] instead (main/coerce.py: exact DECIMAL
    text, ISO dates, integers checked for range); an empty field is NULL
    and a field the type cannot hold raises ValueError."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    n_threads = threads or min(8, max(1, len(data) // (4 << 20) + 1))
    ranges = _split_ranges(data, n_threads)
    if len(ranges) > 1:
        with ThreadPoolExecutor(max_workers=len(ranges)) as pool:
            parts = list(pool.map(lambda r: _parse_chunk(data, r, delim),
                                  ranges))
    else:
        parts = [_parse_chunk(data, r, delim) for r in ranges]
    rows: List[List[str]] = [r for part in parts for r in part if r]
    if not rows:
        return [], [], [], []
    ncol = max(len(r) for r in rows)
    # header detection: explicit flag, else first row non-numeric + rest not
    if header is None:
        first = rows[0]
        header = any(_infer_type([c]) is tt.VARCHAR and c != "" for c in first) \
            and len(rows) > 1 and not all(
                _infer_type([c]) is tt.VARCHAR for r in rows[1:3] for c in r)
    if header:
        names = [c.strip() or f"column{i}" for i, c in enumerate(rows[0])]
        rows = rows[1:]
    else:
        names = [f"column{i}" for i in range(ncol)]
    names = names + [f"column{i}" for i in range(len(names), ncol)]
    if any(len(r) != ncol for r in rows):
        rows = [r + [""] * (ncol - len(r)) for r in rows]
    cols: List[List[str]] = [list(c) for c in zip(*rows)] if rows else \
        [[] for _ in range(ncol)]
    out_types, out_cols, out_valid = [], [], []
    from adacom_tpu_torch.sql.binder import days_from_iso

    for i in range(ncol):
        cells = cols[i]
        empty = np.asarray(cells, dtype=object) == ""
        valid = ~empty if empty.any() else None
        if types is not None and i < len(types):
            out_types.append(types[i])
            out_cols.append(_typed(cells, valid, types[i], names[i]))
            out_valid.append(valid)
            continue
        sample = cols[i][:2048]
        ty = _infer_type(sample)
        if ty is tt.BIGINT:
            try:
                arr = np.asarray([int(c) if c != "" else 0 for c in cells],
                                 dtype=np.int64)
            except ValueError:
                ty = tt.VARCHAR
        if ty is tt.DOUBLE:
            try:
                arr = np.asarray([float(c) if c != "" else 0.0 for c in cells],
                                 dtype=np.float64)
            except ValueError:
                ty = tt.VARCHAR
        if ty is tt.DATE:
            try:
                arr = np.asarray([days_from_iso(c) if c != "" else 0
                                  for c in cells], dtype=np.int32)
            except Exception:
                ty = tt.VARCHAR
        if ty is tt.VARCHAR:
            arr = cells  # list[str]; dictionary-encoded by the table layer
            valid = None if valid is None else valid
        out_types.append(ty)
        out_cols.append(arr)
        out_valid.append(valid)
    return names, out_types, out_cols, out_valid


def _typed(cells: List[str], valid, ty, name: str):
    """One column's fields parsed as the logical type `ty`; NULL fields
    (valid False) get the type's zero."""
    from adacom_tpu_torch.main import coerce

    if ty.is_string:
        return cells
    present = cells if valid is None else \
        np.asarray(cells, dtype=object)[valid].tolist()
    try:
        vals = coerce.from_text(present, ty)
    except ValueError as e:
        raise ValueError(f"column {name}: {e}") from None
    if valid is None:
        return vals
    out = np.zeros(len(cells), vals.dtype)
    out[valid] = vals
    return out


def write_csv(path: str, names: List[str], rendered_cols: List[np.ndarray],
              header: bool = True, delim: str = ","):
    """COPY ... TO: write rendered (display-form) columns."""
    n = len(rendered_cols[0]) if rendered_cols else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=delim)
        if header:
            w.writerow(names)
        for i in range(n):
            w.writerow(["" if c[i] is None else c[i] for c in rendered_cols])
    return n
