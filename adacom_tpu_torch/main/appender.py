"""Appender: bulk columnar ingest (reference Appender, src/main/appender.cpp:51;
BeginRow/EndRow buffered, flushed in chunks — here also a first-class
columnar `append_column` path, the TPU-native way to ingest)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

FLUSH_ROWS = 1 << 18


class Appender:
    def __init__(self, connection, table_name: str):
        self.con = connection
        self.table = connection.db.catalog.get_table(table_name)
        connection._txn_touch(self.table)
        self._row: List[Any] = []
        self._buffers: List[List[Any]] = [[] for _ in self.table.column_order]
        self._buffered = 0
        self._closed = False

    # -------- row-wise API (reference parity) --------
    def begin_row(self):
        self._row = []

    def append(self, value):
        self._row.append(value)

    def end_row(self):
        if len(self._row) != len(self.table.column_order):
            raise ValueError("row arity mismatch")
        for buf, v in zip(self._buffers, self._row):
            buf.append(v)
        self._buffered += 1
        if self._buffered >= FLUSH_ROWS:
            self._flush_rows()

    def append_row(self, *values):
        self.begin_row()
        for v in values:
            self.append(v)
        self.end_row()

    # -------- columnar bulk API --------
    def append_column(self, name: str, values: np.ndarray,
                      validity: Optional[np.ndarray] = None):
        """Single-column table bulk append (or call append_columns)."""
        self.append_columns({name: values},
                            {name: validity} if validity is not None else None)

    def append_columns(self, data: Dict[str, np.ndarray],
                       validity: Optional[Dict[str, np.ndarray]] = None):
        self._flush_rows()
        self.table.append_batch(
            {k.lower(): v for k, v in data.items()},
            {k.lower(): v for k, v in (validity or {}).items()} or None,
        )

    # -------- lifecycle --------
    def _flush_rows(self):
        if not self._buffered:
            return
        data = {}
        vd = {}
        for cname, buf in zip(self.table.column_order, self._buffers):
            col = self.table.columns[cname]
            has_null = any(v is None for v in buf)
            if col.dictionary is not None:
                arr = col.dictionary.encode(["" if v is None else str(v) for v in buf])
            else:
                dt = col.ltype.np_dtype
                if col.ltype.name == "DECIMAL":
                    arr = np.asarray(
                        [0 if v is None else int(round(float(v) * 10 ** col.ltype.scale)) for v in buf],
                        dtype=dt,
                    )
                else:
                    arr = np.asarray([0 if v is None else v for v in buf]).astype(dt)
            data[cname] = arr
            if has_null:
                vd[cname] = np.asarray([v is not None for v in buf], dtype=bool)
        self.table.append_batch(data, vd if vd else None)
        self._buffers = [[] for _ in self.table.column_order]
        self._buffered = 0

    def flush(self):
        self._flush_rows()
        self.table.flush()

    def close(self):
        if not self._closed:
            self.flush()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
