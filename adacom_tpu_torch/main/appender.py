"""Appender: bulk columnar ingest (reference Appender, src/main/appender.cpp:51;
BeginRow/EndRow buffered, flushed in chunks — here also a first-class
columnar `append_column` path, the TPU-native way to ingest).

Each flush is a write of its connection: inside the connection's
transaction it is the transaction's, outside one it is logged at once; a
table another transaction owns refuses it (SQLError) and keeps none of
its rows."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from adacom_tpu_torch.main import coerce
from adacom_tpu_torch.main.connection import SQLError
from adacom_tpu_torch.storage.table import TransactionConflict

FLUSH_ROWS = 1 << 18


class Appender:
    def __init__(self, connection, table_name: str):
        self.con = connection
        self.table = connection.db.catalog.get_table(table_name)
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
        self._append(
            {k.lower(): v for k, v in data.items()},
            {k.lower(): v for k, v in (validity or {}).items()} or None,
        )

    def _append(self, data, validity):
        try:
            self.table.append_batch(data, validity,
                                    token=self.con._txn_touch(self.table))
        except TransactionConflict as e:
            raise SQLError(str(e)) from e

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
                # INSERT ... VALUES's rule (main/coerce.py)
                arr = coerce.from_values(buf, col.ltype)
            data[cname] = arr
            if has_null:
                vd[cname] = np.asarray([v is not None for v in buf], dtype=bool)
        self._append(data, vd if vd else None)
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
