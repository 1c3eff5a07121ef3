"""PEP 249 (DB-API 2.0) binding (port of adacom_tpu/dbapi.py).

Parity target: the reference's language bindings (tools/pythonpkg exposes a
DB-API-style interface; tools/sqlite3_api_wrapper mimics the sqlite3 API).
``adacom_tpu_torch.dbapi.connect()`` is a drop-in for
``sqlite3.connect()``-style code: cursors, qmark parameters, description,
fetch*, context managers. ``platform`` picks the database's device
("cuda" by default; "cuda" without a card raises).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import adacom_tpu_torch as att
from adacom_tpu_torch.main.connection import SQLError

apilevel = "2.0"
threadsafety = 1
paramstyle = "qmark"


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


def _quote(v: Any) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v).replace("'", "''")
    return f"'{s}'"


def _substitute(sql: str, params: Sequence[Any]) -> str:
    """qmark substitution, skipping string literals."""
    out = []
    it = iter(params)
    in_str = False
    i = 0
    while i < len(sql):
        ch = sql[i]
        if ch == "'":
            in_str = not in_str
            out.append(ch)
        elif ch == "?" and not in_str:
            try:
                out.append(_quote(next(it)))
            except StopIteration:
                raise InterfaceError("not enough parameters") from None
        else:
            out.append(ch)
        i += 1
    leftovers = list(it)
    if leftovers:
        raise InterfaceError(f"{len(leftovers)} unused parameters")
    return "".join(out)


class Cursor:
    arraysize = 1

    def __init__(self, connection: "Connection"):
        self._con = connection
        self._result = None
        self._rows: Optional[List[tuple]] = None
        self._pos = 0
        self.rowcount = -1

    @property
    def description(self):
        if self._result is None:
            return None
        return [(n, str(t), None, None, None, None, None)
                for n, t in zip(self._result.names, self._result.types)]

    def execute(self, sql: str, params: Sequence[Any] = ()) -> "Cursor":
        if self._con._raw is None:
            raise InterfaceError("cursor on closed connection")
        if params:
            sql = _substitute(sql, params)
        try:
            self._result = self._con._raw.query(sql)
        except SQLError as e:
            raise DatabaseError(str(e)) from e
        self._rows = self._result.fetchall() if self._result is not None else []
        self._pos = 0
        self.rowcount = len(self._rows)
        return self

    def executemany(self, sql: str, seq_of_params) -> "Cursor":
        for p in seq_of_params:
            self.execute(sql, p)
        return self

    def fetchone(self) -> Optional[tuple]:
        if self._rows is None or self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        size = size or self.arraysize
        out = self._rows[self._pos: self._pos + size] if self._rows else []
        self._pos += len(out)
        return out

    def fetchall(self) -> List[tuple]:
        out = self._rows[self._pos:] if self._rows else []
        self._pos = len(self._rows) if self._rows else 0
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def close(self):
        self._result = None
        self._rows = None


class Connection:
    def __init__(self, path: Optional[str] = None, config=None,
                 platform: Optional[str] = None):
        self._db = att.Database(path=path, config=config, platform=platform)
        self._raw = self._db.connect()

    def cursor(self) -> Cursor:
        return Cursor(self)

    def execute(self, sql: str, params: Sequence[Any] = ()) -> Cursor:
        return self.cursor().execute(sql, params)

    def commit(self):
        if self._raw is not None and self._raw._in_txn:
            self._raw.query("COMMIT")

    def rollback(self):
        if self._raw is not None and self._raw._in_txn:
            self._raw.query("ROLLBACK")

    def close(self):
        if self._raw is not None:
            self._db.close()
            self._raw = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.commit()
        else:
            self.rollback()
        self.close()


def connect(path: Optional[str] = None, config=None,
            platform: Optional[str] = None) -> Connection:
    return Connection(path=path, config=config, platform=platform)
