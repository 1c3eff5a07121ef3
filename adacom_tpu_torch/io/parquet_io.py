"""Parquet reader/writer (reference extension/parquet — here a thin
adapter over pyarrow; the engine's own columnar/codec machinery applies
once the data lands in a Table, so there is no separate parquet scan
operator). Port of adacom_tpu/io/parquet_io.py; pyarrow is imported only
when a parquet file is read or written, so the rest of the port runs
without it.

Returns/accepts the io-module column convention (see io/csv_io.py):
(names, types, columns, validity) with numeric columns as numpy arrays,
VARCHAR as list[str], DATE as int32 days-since-epoch."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from adacom_tpu_torch import types as tt


def _arrow():
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet as pq
        return pq
    except Exception as e:  # pragma: no cover - environment-dependent
        raise RuntimeError(
            "parquet support requires pyarrow, which is not available"
        ) from e


def _from_arrow_column(col) -> tuple:
    """arrow ChunkedArray -> (engine type, column, validity)."""
    import pyarrow as pa

    arr = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    t = arr.type
    valid = None
    if arr.null_count:
        valid = np.asarray(arr.is_valid())
    if pa.types.is_boolean(t):
        vals = np.asarray(arr.fill_null(False))
        return tt.BOOLEAN, vals.astype(np.bool_), valid
    if pa.types.is_integer(t):
        vals = np.asarray(arr.fill_null(0)).astype(np.int64)
        return tt.BIGINT, vals, valid
    if pa.types.is_floating(t):
        vals = np.asarray(arr.fill_null(0.0)).astype(np.float64)
        return tt.DOUBLE, vals, valid
    if pa.types.is_date(t):
        days = np.asarray(arr.cast(pa.int32()).fill_null(0) if arr.null_count
                          else arr.cast(pa.int32())).astype(np.int32)
        if arr.null_count:
            days = np.asarray(arr.fill_null(0).cast(pa.int32())
                              ).astype(np.int32)
        return tt.DATE, days, valid
    if pa.types.is_timestamp(t):
        # truncate to days (engine DATE granularity)
        us = np.asarray(arr.cast(pa.timestamp("us")).fill_null(0)
                        ).astype("datetime64[us]")
        days = (us.astype("datetime64[D]").astype(np.int64)).astype(np.int32)
        return tt.DATE, days, valid
    if pa.types.is_decimal(t):
        vals = np.asarray([float(x) if x is not None else 0.0
                           for x in arr.to_pylist()], dtype=np.float64)
        return tt.DOUBLE, vals, valid
    # strings and everything else: stringify
    cells = ["" if x is None else str(x) for x in arr.to_pylist()]
    return tt.VARCHAR, cells, valid


def read_parquet(path: str, columns: Optional[List[str]] = None):
    """Read a parquet file -> (names, types, cols, valids)."""
    pq = _arrow()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    table = pq.read_table(path, columns=columns)
    names, types, cols, valids = [], [], [], []
    for name in table.column_names:
        ty, vals, valid = _from_arrow_column(table.column(name))
        names.append(name)
        types.append(ty)
        cols.append(vals)
        valids.append(valid)
    return names, types, cols, valids


def write_parquet(path: str, names: List[str], types: List, cols: List,
                  valids: List) -> int:
    """Write engine columns to a parquet file; returns the row count.

    cols follow the io convention; validity masks become arrow nulls."""
    pq = _arrow()
    import pyarrow as pa

    arrays = []
    n = 0
    for ty, col, valid in zip(types, cols, valids):
        mask = None if valid is None else ~np.asarray(valid, dtype=bool)
        if ty is tt.DATE:
            days = np.asarray(col, dtype=np.int32)
            arr = pa.array(days, mask=mask).cast(pa.date32())
            n = len(days)
        elif ty is tt.VARCHAR or isinstance(col, list):
            cells = [None if (mask is not None and mask[i]) else str(c)
                     for i, c in enumerate(col)]
            arr = pa.array(cells, type=pa.string())
            n = len(cells)
        else:
            vals = np.asarray(col)
            arr = pa.array(vals, mask=mask)
            n = len(vals)
        arrays.append(arr)
    t = pa.Table.from_arrays(arrays, names=list(names))
    pq.write_table(t, path)
    return n
