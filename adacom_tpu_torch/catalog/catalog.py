"""Schema catalog: tables, views, and the segment catalog hook.

Parity with the reference Catalog (src/catalog/catalog.cpp): CreateTable /
GetEntry / DropTable, and ownership of the ColumnSegmentCatalog
(reference Catalog::GetColumnSegmentCatalog, catalog.cpp:75 — there a
process-global static; here per-database)."""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.catalog.segment_catalog import ColumnSegmentCatalog
from adacom_tpu_torch.storage.index import SortedIndex
from adacom_tpu_torch.storage.table import Table
from adacom_tpu_torch.storage.wal import RecordGroup


class CatalogException(Exception):
    pass


class Catalog:
    def __init__(self, config, buffer_manager):
        self.config = config
        self.bm = buffer_manager
        self._lock = threading.RLock()
        self.tables: Dict[str, Table] = {}
        self.views: Dict[str, str] = {}  # name -> SELECT sql
        self.indexes: Dict[str, SortedIndex] = {}
        self.wal = None  # attached by Database when durable
        self.segment_catalog = ColumnSegmentCatalog(config)
        # reference Catalog::Initialize starts background compaction when
        # adaptive mode is on (catalog.cpp:67-71; there it starts
        # unconditionally due to an empty if — a defect we fix)
        if config.adaptive_succinct_compression_enabled:
            self.segment_catalog.enable_background_compaction()

    def get_column_segment_catalog(self) -> ColumnSegmentCatalog:
        return self.segment_catalog

    def create_table(
        self, name: str, columns: List[tuple], if_not_exists: bool = False,
        unique: Sequence[Tuple[str, str]] = (),
        fill: Optional[Callable[[Table], None]] = None,
    ) -> Table:
        """`unique`: [(index name, column)] of the UNIQUE indexes of the
        table's PRIMARY KEY / UNIQUE constraints (an index name that exists
        is skipped); `fill(table)` appends the rows of CREATE TABLE AS.
        The table, its indexes and its rows reach the WAL in one write (one
        marked group), and the table is published only after all of it."""
        key = name.lower()
        with self._lock:
            if key in self.tables or key in self.views:
                if if_not_exists:
                    return self.tables[key]
                raise CatalogException(f"table {name!r} already exists")
            t = Table(key, columns, self.config, self.bm, self.segment_catalog)
            group = None if self.wal is None else RecordGroup()
            if group is not None:
                group.log_create_table(key, [
                    (c, ty.name, ty.precision, ty.scale) for c, ty in columns
                ])
            t.wal = group
            indexes = {}
            for iname, col in unique:
                iname = iname.lower()
                if iname in self.indexes or iname in indexes:
                    continue
                idx = indexes[iname] = self._new_index(iname, t, col, True)
                t.indexes.append(idx)
                if group is not None:
                    group.log_create_index(iname, key, idx.column, True)
            if fill is not None:
                fill(t)
            if group is not None:
                self.wal.write_group(group)
            t.wal = self.wal
            self.indexes.update(indexes)
            self.tables[key] = t
            return t

    def get_table(self, name: str) -> Table:
        t = self.tables.get(name.lower())
        if t is None:
            raise CatalogException(f"table {name!r} does not exist")
        return t

    def has_table(self, name: str) -> bool:
        return name.lower() in self.tables

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        key = name.lower()
        with self._lock:
            t = self.tables.pop(key, None)
            if t is None:
                if if_exists:
                    return
                raise CatalogException(f"table {name!r} does not exist")
            if self.wal is not None:
                self.wal.log_drop_table(key)
            for iname in [n for n, i in self.indexes.items() if i.table is t]:
                self.indexes.pop(iname)
            cache = getattr(t, "_pool_cache", None)
            if cache is not None:
                cache.clear()
            for c in t.column_order:
                col = t.columns[c]
                for s in col.segments:
                    self.segment_catalog.remove_column_segment(s)
                    self.bm.add_to_data_size(-s.footprint_bytes())
                    s.page_out()

    def create_view(self, name: str, sql: str, or_replace: bool = False):
        key = name.lower()
        with self._lock:
            if key in self.tables:
                raise CatalogException(f"{name!r} is a table")
            if key in self.views and not or_replace:
                raise CatalogException(f"view {name!r} already exists")
            if self.wal is not None:
                self.wal.log_create_view(key, sql)
            self.views[key] = sql

    def create_index(self, name: str, table_name: str, column: str,
                     unique: bool = False, if_not_exists: bool = False
                     ) -> SortedIndex:
        """Reference ART index creation (CREATE INDEX / PRIMARY KEY)."""
        key = name.lower()
        with self._lock:
            if key in self.indexes:
                if if_not_exists:
                    return self.indexes[key]
                raise CatalogException(f"index {name!r} already exists")
            table = self.get_table(table_name)
            idx = self._new_index(key, table, column, unique)
            self.indexes[key] = idx
            table.indexes.append(idx)
            if self.wal is not None:
                self.wal.log_create_index(key, table.name, idx.column, unique)
            return idx

    @staticmethod
    def _new_index(key: str, table: Table, column: str,
                   unique: bool) -> SortedIndex:
        col = column.lower()
        for part in col.split(","):
            if part.strip() not in table.columns:
                raise CatalogException(
                    f"column {part.strip()!r} not in table {table.name!r}")
        idx = SortedIndex(key, table, col, unique)
        idx.build()  # raises ConstraintViolation on existing duplicates
        return idx

    def drop_index(self, name: str, if_exists: bool = False) -> None:
        key = name.lower()
        with self._lock:
            idx = self.indexes.pop(key, None)
            if idx is None:
                if if_exists:
                    return
                raise CatalogException(f"index {name!r} does not exist")
            idx.table.indexes = [i for i in idx.table.indexes if i is not idx]
            if self.wal is not None:
                self.wal.log_drop_index(key)

    def drop_view(self, name: str) -> None:
        key = name.lower()
        with self._lock:
            if self.views.pop(key, None) is not None and self.wal is not None:
                self.wal.log_drop_view(key)

    def attach_wal(self, wal) -> None:
        """Durable mode: route DDL/DML through the write-ahead log."""
        with self._lock:
            self.wal = wal
            for t in self.tables.values():
                t.wal = wal

    def get_view(self, name: str) -> Optional[str]:
        return self.views.get(name.lower())

    def shutdown(self):
        self.segment_catalog.disable_background_compaction()
