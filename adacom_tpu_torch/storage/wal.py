"""Write-ahead log: logical-operation durability + replay-on-open.

Port of adacom_tpu/storage/wal.py; the records are the JAX package's, so a
log written by either package replays in the other. Parity with the
reference WAL (src/storage/write_ahead_log.cpp — logical create/insert/
delete/update entries — and wal_replay.cpp:24 replay on open). Layout on
disk (the database is a directory):

    <path>/CURRENT        -> name of the live checkpoint subdirectory
    <path>/ckpt-<n>/      -> columnar checkpoint (storage/checkpoint.py)
    <path>/wal.log        -> this file: length-prefixed npz records

A record is ``<u64 length><npz payload>`` where the npz holds a JSON header
(operation + names) plus the column arrays. Replay stops cleanly at a torn
tail record (crash mid-write). Each open transaction collects its records
in a `RecordGroup` of its own (catalog/catalog.py `Transaction`), which
reaches the file in one write at COMMIT (fsync) and is dropped at
ROLLBACK, so a ROLLBACK never needs compensation records and no other
connection's records wait for, or vanish with, another's transaction.
Outside a transaction a statement's records are written while the lock of
what they change is held (the table's append lock, the catalog's lock), so
the log's order is the order in which the changes took place; a statement
that changes more than one thing at once (an UPDATE's deletes and its new
rows, CREATE TABLE with its constraints or its AS SELECT rows) writes its
records in one call. Where such a group holds more than one record, a
marker record ``{"op": "txn", "n": k}`` goes first, in the same write, and
replay applies the k records after it only when all k are whole: a tail
torn inside a transaction or a multi-record statement replays none of it.
The JAX package's replay skips the marker as an unknown op, so it opens
such a log (a torn group there replays the records before the tear), and
a log it wrote (no markers) replays here record by record. After a
successful checkpoint the WAL is truncated; ``wal_autocheckpoint`` bytes of
WAL trigger an automatic checkpoint.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import struct
import threading
from typing import Dict, List, Optional

import numpy as np

_LEN = struct.Struct("<Q")


class RecordLog:
    """The logical operations (reference write_ahead_log.cpp entry types)
    as records; a subclass says where `_write` puts them."""

    @staticmethod
    def _encode(header: dict, arrays: Dict[str, np.ndarray]) -> bytes:
        bio = io.BytesIO()
        hdr = np.frombuffer(json.dumps(header).encode("utf-8"), dtype=np.uint8)
        np.savez(bio, __header__=hdr, **arrays)
        payload = bio.getvalue()
        return _LEN.pack(len(payload)) + payload

    def _write(self, recs: List[bytes]):
        raise NotImplementedError

    def _emit(self, header: dict, arrays: Optional[Dict[str, np.ndarray]] = None):
        self._write([self._encode(header, arrays or {})])

    def write_group(self, group: "RecordGroup"):
        """`group`'s records, which replay together."""
        self._write(group.records)

    def log_create_table(self, name: str, columns: List[tuple]):
        # columns: [(name, type_name, precision, scale), ...]
        self._emit({"op": "create_table", "name": name, "cols": columns})

    def log_drop_table(self, name: str):
        self._emit({"op": "drop_table", "name": name})

    def log_create_view(self, name: str, sql: str):
        self._emit({"op": "create_view", "name": name, "sql": sql})

    def log_drop_view(self, name: str):
        self._emit({"op": "drop_view", "name": name})

    def log_create_index(self, name: str, table: str, column: str,
                         unique: bool):
        self._emit({"op": "create_index", "name": name, "table": table,
                    "column": column, "unique": unique})

    def log_drop_index(self, name: str):
        self._emit({"op": "drop_index", "name": name})

    def log_insert(self, table: str, data: Dict[str, np.ndarray],
                   validity: Optional[Dict[str, np.ndarray]]):
        arrays = {}
        cols = []
        for c, v in data.items():
            cols.append(c)
            arr = np.asarray(v)
            if arr.dtype.kind == "O":  # decoded strings -> unicode array
                arr = arr.astype(str)
            arrays[f"d.{c}"] = arr
            if validity and validity.get(c) is not None:
                arrays[f"v.{c}"] = np.asarray(validity[c], dtype=bool)
        self._emit({"op": "insert", "table": table, "cols": cols}, arrays)

    def log_truncate(self, table: str):
        """DELETE without WHERE: all rows removed in place, schema and
        indexes survive."""
        self._emit({"op": "truncate", "table": table})

    def log_delete(self, table: str, rows: np.ndarray):
        # GLOBAL row positions: replay re-segments by its own flush timing,
        # so (segment, local row) coordinates do not survive; global
        # offsets do (appends only append, rolled-back txns never log)
        self._emit({"op": "delete", "table": table},
                   {"rows": np.asarray(rows, dtype=np.int64)})


class RecordGroup(RecordLog):
    """Records collected for one `WriteAheadLog.write_group` call: one
    statement's, or one transaction's until its COMMIT."""

    def __init__(self):
        self.records: List[bytes] = []

    def _write(self, recs: List[bytes]):
        self.records.extend(recs)


class WriteAheadLog(RecordLog):
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.RLock()
        self._file = open(path, "ab")

    def _write(self, recs: List[bytes]):
        """Records that replay together, to the file in one write: a
        marker first where there is more than one."""
        if len(recs) > 1:
            recs = [self._encode({"op": "txn", "n": len(recs)}, {})] + recs
        with self._lock:
            self._file.write(b"".join(recs))
            self._file.flush()

    def commit(self, group: RecordGroup):
        """A transaction's records at its COMMIT: one write, then fsync."""
        if not group.records:
            return
        with self._lock:
            self.write_group(group)
            os.fsync(self._file.fileno())

    # ------------------------------------------------------------------
    def size(self) -> int:
        with self._lock:
            self._file.flush()
            return os.path.getsize(self.path)

    def truncate(self):
        """Called after a successful checkpoint: the log is obsolete."""
        with self._lock:
            self._file.close()
            self._file = open(self.path, "wb")

    def close(self):
        with self._lock:
            self._file.close()


# ----------------------------------------------------------------------
# replay (reference WriteAheadLog::Replay, wal_replay.cpp:24)
# ----------------------------------------------------------------------


def _records(raw: bytes):
    """(header, npz) of each whole record of a log, in order; stops at a
    torn or corrupt record (everything before it is durable)."""
    off, total = 0, len(raw)
    while off + _LEN.size <= total:
        (ln,) = _LEN.unpack_from(raw, off)
        if off + _LEN.size + ln > total:
            return  # torn tail record
        payload = raw[off + _LEN.size: off + _LEN.size + ln]
        off += _LEN.size + ln
        try:
            z = np.load(io.BytesIO(payload), allow_pickle=False)
            header = json.loads(bytes(z["__header__"]).decode("utf-8"))
        except Exception:
            return  # corrupt record
        yield header, z


def replay(db, path: str) -> int:
    """Apply WAL records to a freshly-loaded database. Returns the number of
    records applied. Tolerates a torn final record (crash mid-append) and
    applies a marked group of records only when all of it is whole."""
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        raw = f.read()
    applied = 0
    records = _records(raw)
    for header, z in records:
        if header["op"] == "txn":
            group = list(itertools.islice(records, header["n"]))
            if len(group) < header["n"]:
                break  # the group is torn: none of it happened
        else:
            group = [(header, z)]
        for h, zz in group:
            _apply(db, h, zz)
            applied += 1
    return applied


def _apply(db, header: dict, z) -> None:
    """Apply one record."""
    from adacom_tpu_torch import types as tt

    op = header["op"]
    if op == "create_table":
        cols = []
        for cname, tname, prec, scale in header["cols"]:
            if tname == "DECIMAL":
                ty = tt.DECIMAL(prec, scale)
            else:
                ty = tt.type_from_name(tname)
            cols.append((cname, ty))
        db.catalog.create_table(header["name"], cols, if_not_exists=True)
    elif op == "drop_table":
        db.catalog.drop_table(header["name"], if_exists=True)
    elif op == "create_view":
        db.catalog.create_view(header["name"], header["sql"],
                               or_replace=True)
    elif op == "drop_view":
        db.catalog.views.pop(header["name"].lower(), None)
    elif op == "create_index":
        db.catalog.create_index(header["name"], header["table"],
                                header["column"], header["unique"],
                                if_not_exists=True)
    elif op == "drop_index":
        db.catalog.drop_index(header["name"], if_exists=True)
    elif op == "insert":
        table = db.catalog.get_table(header["table"])
        data, validity = {}, {}
        for c in header["cols"]:
            arr = z[f"d.{c}"]
            if arr.dtype.kind == "U":
                arr = arr.astype(object)
            data[c] = arr
            if f"v.{c}" in z.files:
                validity[c] = z[f"v.{c}"]
        table.append_batch(data, validity or None)
    elif op == "truncate":
        db.catalog.get_table(header["table"]).truncate()
    elif op == "delete":
        table = db.catalog.get_table(header["table"])
        table.flush()
        # map global row positions onto the replay's segmentation
        col0 = table.columns[table.column_order[0]]
        grows = np.sort(z["rows"])
        starts = np.cumsum([0] + [s.count for s in col0.segments])
        seg_of = np.searchsorted(starts, grows, side="right") - 1
        for si in np.unique(seg_of):
            local = grows[seg_of == si] - starts[si]
            table.mark_deleted(int(si), local, _log=False)
