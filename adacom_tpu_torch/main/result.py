"""Query results (reference MaterializedQueryResult, src/main/query_result.cpp)."""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from adacom_tpu_torch import types as tt


class QueryResult:
    def __init__(self, names, types, cols, valids, dicts):
        self.names: List[str] = names
        self.types: List[tt.LogicalType] = types
        self._cols: List[np.ndarray] = cols
        self._valids: List[Optional[np.ndarray]] = valids
        self._dicts = dicts

    @property
    def row_count(self) -> int:
        return len(self._cols[0]) if self._cols else 0

    def column(self, i: int) -> np.ndarray:
        """Raw column array (dictionary codes for VARCHAR)."""
        return self._cols[i]

    def columns(self) -> List[np.ndarray]:
        return list(self._cols)

    def fetchnumpy(self) -> dict:
        out = {}
        for n, t, c, v, d in zip(self.names, self.types, self._cols,
                                 self._valids, self._dicts):
            arr = self._render_col(t, c, v, d)
            out[n] = arr
        return out

    def _render_col(self, t, c, v, d):
        if t.is_string and d is not None:
            arr = np.asarray(d.decode(c.astype(np.int64)), dtype=object)
        elif t.name == "DECIMAL":
            arr = c.astype(np.float64) / (10 ** t.scale)
        elif t is tt.DATE:
            from adacom_tpu_torch.sql.binder import iso_from_days

            arr = np.asarray([iso_from_days(x) for x in c], dtype=object)
        elif t is tt.BOOLEAN:
            arr = c.astype(bool)
        else:
            arr = c
        if v is not None:
            arr = arr.astype(object)
            arr[~v] = None
        return arr

    def fetchall(self) -> List[tuple]:
        rendered = [self._render_col(t, c, v, d) for t, c, v, d in
                    zip(self.types, self._cols, self._valids, self._dicts)]
        n = self.row_count
        return [tuple(col[i] for col in rendered) for i in range(n)]

    def to_dicts(self) -> List[dict]:
        rendered = [self._render_col(t, c, v, d) for t, c, v, d in
                    zip(self.types, self._cols, self._valids, self._dicts)]
        return [dict(zip(self.names, (col[i] for col in rendered)))
                for i in range(self.row_count)]

    def fetch_arrow_table(self):
        """Arrow interop (reference src/common/arrow/*): zero-copy-ish
        pyarrow.Table of the result."""
        import pyarrow as pa

        cols = {}
        for n, t, c, v, d in zip(self.names, self.types, self._cols,
                                 self._valids, self._dicts):
            rendered = self._render_col(t, c, v, d)
            cols[n] = pa.array(list(rendered))
        return pa.table(cols)

    arrow = fetch_arrow_table

    def fetchdf(self):
        """pandas DataFrame of the result (pythonpkg .df() parity)."""
        import pandas as pd

        data = {}
        for n, t, c, v, d in zip(self.names, self.types, self._cols,
                                 self._valids, self._dicts):
            data[n] = list(self._render_col(t, c, v, d))
        return pd.DataFrame(data)

    df = fetchdf

    def fetchone(self) -> Optional[tuple]:
        rows = self.fetchall()
        return rows[0] if rows else None

    def scalar(self) -> Any:
        row = self.fetchone()
        return row[0] if row else None

    def __repr__(self):
        cols = ", ".join(f"{n} {t}" for n, t in zip(self.names, self.types))
        return f"<QueryResult [{cols}] rows={self.row_count}>"
