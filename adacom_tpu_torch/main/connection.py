"""Connection: the query entry point (reference Connection::Query,
src/main/connection.cpp:74 -> ClientContext::Query, client_context.cpp:792).
Port of adacom_tpu/main/connection.py.

Statement flow mirrors SURVEY.md §3.1: parse -> bind -> optimize ->
execute, with a *plan cache* keyed on the literal-parameterized SQL
template (+ structural literal values + catalog version) so repeated
point lookups skip everything but execution — the TPU answer to the
reference's 10k-sequential-lookup benchmarks."""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.exec.device_scan import declines
from adacom_tpu_torch.exec.executor import Executor, Mat
from adacom_tpu_torch.main.result import QueryResult
from adacom_tpu_torch.sql import ast
from adacom_tpu_torch.catalog.catalog import CatalogException
from adacom_tpu_torch.sql.binder import Binder, BindError
from adacom_tpu_torch.sql.optimizer import optimize
from adacom_tpu_torch.sql.parser import parse


# the Chrome trace PRAGMA tpu_profile_stop writes into the trace directory
TRACE_FILE = "trace.json"


class SQLError(Exception):
    pass


class Connection:
    def __init__(self, database):
        self.db = database
        self.executor = Executor(database)
        self._in_txn = False
        self._txn_snapshot = None
        self.last_profile: Optional[dict] = None
        # MVCC identity: write-ownership token + reader visibility key
        self._token = id(self)
        self.executor.conn_token = self._token
        self._prepared: dict = {}  # name -> PreparedStatement

    # ------------------------------------------------------------------
    def query(self, sql: str) -> Optional[QueryResult]:
        """Execute one or more statements; returns the last result."""
        # raw-text parse cache: repeated query texts (skewed point-lookup
        # workloads re-issue hot values verbatim) skip the lexer+parser;
        # ASTs are immutable post-parse so sharing them is safe
        parsed = self.db.parse_cache.get(sql)
        if parsed is None:
            try:
                parsed = parse(sql)
            except Exception as e:
                raise SQLError(f"parse error: {e}") from e
            if len(self.db.parse_cache) > 8192:
                self.db.parse_cache.clear()
            self.db.parse_cache[sql] = parsed
        stmts, key, lits, structural = parsed
        if any(isinstance(s, (ast.InsertStmt, ast.UpdateStmt)) for s in stmts):
            # INSERT/UPDATE consume literal lists that may be huge and
            # unique; don't let them pin cache memory
            self.db.parse_cache.pop(sql, None)
        from adacom_tpu_torch.storage.index import ConstraintViolation

        result = None
        for i, stmt in enumerate(stmts):
            try:
                result = self._execute_stmt(stmt, key, lits, structural, i, sql)
            except ConstraintViolation as e:
                raise SQLError(str(e)) from e
        return result

    execute = query
    sql = query

    def table(self, name: str):
        """Relation API root (reference Connection::Table,
        src/main/connection.cpp): lazy composable query building."""
        from adacom_tpu_torch.main.relation import Relation

        self.db.catalog.get_table(name)  # existence check
        return Relation(self, f"SELECT * FROM {name}")

    def from_query(self, sql: str):
        from adacom_tpu_torch.main.relation import Relation

        return Relation(self, sql)

    def values(self, rows):
        """Relation over literal rows (reference Connection::Values)."""
        from adacom_tpu_torch.main.relation import Relation

        body = ", ".join(
            "(" + ", ".join(
                "NULL" if v is None else
                (f"'" + str(v).replace("'", "''") + "'"
                 if isinstance(v, str) else repr(v))
                for v in row) + ")"
            for row in rows)
        return Relation(self, f"SELECT * FROM (VALUES {body}) __v")

    def prepare(self, sql: str) -> "PreparedStatement":
        """Reference Connection::Prepare (src/main/connection.cpp):
        '?' placeholders become parameters supplied at execute()."""
        return PreparedStatement(self, sql)

    def appender(self, table_name: str):
        from adacom_tpu_torch.main.appender import Appender

        return Appender(self, table_name)

    # ------------------------------------------------------------------
    def _execute_stmt(self, stmt, key, lits, structural, stmt_idx, sql):
        t0 = time.perf_counter()
        self.db.buffer_manager.begin_statement()
        if isinstance(stmt, ast.SelectStmt):
            res = self._execute_select(stmt, key, lits, structural, stmt_idx, sql)
        elif isinstance(stmt, ast.CreateTableStmt):
            res = self._execute_create_table(stmt, lits)
        elif isinstance(stmt, ast.CreateViewStmt):
            self.db.catalog.create_view(stmt.name, stmt.select_sql, stmt.or_replace)
            self._bump_catalog_version()
            res = None
        elif isinstance(stmt, ast.InsertStmt):
            res = self._execute_insert(stmt, lits)
        elif isinstance(stmt, ast.DeleteStmt):
            res = self._execute_delete(stmt, lits)
        elif isinstance(stmt, ast.UpdateStmt):
            res = self._execute_update(stmt, lits)
        elif isinstance(stmt, ast.CreateIndexStmt):
            from adacom_tpu_torch.storage.index import ConstraintViolation

            try:
                self.db.catalog.create_index(
                    stmt.name, stmt.table, stmt.column, stmt.unique,
                    stmt.if_not_exists)
            except ConstraintViolation as e:
                raise SQLError(str(e)) from e
            self._bump_catalog_version()
            res = None
        elif isinstance(stmt, ast.DropStmt):
            if stmt.kind == "view":
                self.db.catalog.drop_view(stmt.name)
            elif stmt.kind == "index":
                self.db.catalog.drop_index(stmt.name, stmt.if_exists)
            else:
                self.db.catalog.drop_table(stmt.name, stmt.if_exists)
            self._bump_catalog_version()
            res = None
        elif isinstance(stmt, ast.TransactionStmt):
            res = self._execute_txn(stmt)
        elif isinstance(stmt, ast.PragmaStmt):
            res = self._execute_pragma(stmt)
        elif isinstance(stmt, ast.SetStmt):
            self.db.config.set_option(stmt.name, stmt.value)
            res = None
        elif isinstance(stmt, ast.ExplainStmt):
            res = self._execute_explain(stmt, lits)
        elif isinstance(stmt, ast.CopyStmt):
            res = self._execute_copy(stmt, lits)
        elif isinstance(stmt, ast.CheckpointStmt):
            self.db.checkpoint()
            res = None
        elif isinstance(stmt, ast.DescribeStmt):
            res = self._execute_describe(stmt)
        elif isinstance(stmt, ast.PrepareStmt):
            self._prepared[stmt.name.lower()] = PreparedStatement(
                self, stmt.sql)
            res = None
        elif isinstance(stmt, ast.ExecuteStmt):
            ps = self._prepared.get(stmt.name.lower())
            if ps is None:
                raise SQLError(f"no prepared statement {stmt.name!r}")
            binder = Binder(self.db.catalog, self.db.config)
            from adacom_tpu_torch.sql.binder import Scope

            scope = Scope()
            vals = [_const_eval(binder, a, scope) for a in (stmt.args or [])]
            res = ps.execute(*vals)
        else:
            raise SQLError(f"unsupported statement {type(stmt).__name__}")
        if isinstance(stmt, (ast.InsertStmt, ast.DeleteStmt, ast.UpdateStmt,
                             ast.CreateTableStmt, ast.DropStmt)) and \
                not self._in_txn:
            self.db.maybe_autocheckpoint()
        if self.db.config.enable_profiling:
            prof = self.last_profile if isinstance(stmt, ast.SelectStmt) and \
                self.last_profile else {}
            prof.update({
                "statement": type(stmt).__name__,
                "total_s": time.perf_counter() - t0,
            })
            self.last_profile = prof
        return res

    # ------------------------------------------------------------------
    def _bump_catalog_version(self):
        v = getattr(self.db.catalog, "version", 0)
        self.db.catalog.version = v + 1

    def _plan_select(self, stmt: ast.SelectStmt, key, lits, structural, stmt_idx):
        # which slots join the key is a property of the TEMPLATE (the binder
        # bakes literal values it saw at structural positions into the plan);
        # once learned, later lookups build the full key without rebinding
        known = self.db.template_slots.get((key, stmt_idx))
        slots = structural if known is None else known
        cache_key = (
            key, stmt_idx,
            tuple(sorted((s, repr(lits[s])) for s in slots)),
            getattr(self.db.catalog, "version", 0),
        )
        with self.db.plan_cache_lock:
            hit = self.db.plan_cache.get(cache_key)
        if hit is not None:
            return hit
        binder = Binder(self.db.catalog, self.db.config)
        plan = binder.bind_select(stmt)
        all_structural = set(structural) | binder.structural
        plan = optimize(plan, all_structural)
        full_key = (
            key, stmt_idx,
            tuple(sorted((s, repr(lits[s])) for s in all_structural)),
            getattr(self.db.catalog, "version", 0),
        )
        with self.db.plan_cache_lock:
            self.db.template_slots[(key, stmt_idx)] = frozenset(all_structural)
            self.db.plan_cache[full_key] = plan
            if len(self.db.plan_cache) > 4096:
                self.db.plan_cache.clear()
            if len(self.db.template_slots) > 8192:
                self.db.template_slots.clear()
        return plan

    def _execute_select(self, stmt, key, lits, structural, stmt_idx,
                        sql=None) -> QueryResult:
        profiling = self.db.config.enable_profiling
        t0 = time.perf_counter()
        try:
            plan = self._plan_select(stmt, key, lits, structural, stmt_idx)
        except (BindError, CatalogException) as e:
            raise SQLError(str(e)) from e
        t_plan = time.perf_counter()
        if profiling:
            self.executor.profile = {}
        try:
            mat = self.executor.execute(plan, lits)
        finally:
            if profiling:
                op_profile = self.executor.profile
                self.executor.profile = None
        if profiling:
            # QueryProfiler parity (src/main/query_profiler.cpp): per-phase
            # timers + per-operator tree (QueryTreeToString)
            self.last_profile = {
                "statement": "SelectStmt",
                "phases": {"plan_s": t_plan - t0,
                           "execute_s": time.perf_counter() - t_plan},
                "operators": _render_plan(plan, profile=op_profile),
            }
        res = QueryResult(mat.names, mat.types, mat.cols, mat.valids, mat.dicts)
        if self.db.config.query_verification_enabled:
            from adacom_tpu_torch.main.verification import (
                VerificationError, verify_select)

            try:
                verify_select(self, stmt, lits, res.fetchall(),
                              sql=sql, stmt_idx=stmt_idx)
            except VerificationError as e:
                raise SQLError(str(e)) from e
        return res

    # ------------------------------------------------------------------
    def _execute_create_table(self, stmt: ast.CreateTableStmt, lits=()):
        if stmt.as_select is not None:
            binder = Binder(self.db.catalog, self.db.config)
            plan = optimize(binder.bind_select(stmt.as_select), set())
            mat = self.executor.execute(plan, lits)
            cols = [(n, t) for n, t in zip(mat.names, mat.types)]
            table = self.db.catalog.create_table(stmt.name, [], stmt.if_not_exists)
            # rebuild with proper column defs
            self.db.catalog.drop_table(stmt.name)
            table = self.db.catalog.create_table(
                stmt.name, cols, stmt.if_not_exists
            )
            self._append_mat(table, mat)
            self._bump_catalog_version()
            return None
        cols = []
        for cname, ctype, targs in stmt.columns:
            cols.append((cname, tt.type_from_name(ctype, targs)))
        self.db.catalog.create_table(stmt.name, cols, stmt.if_not_exists)
        # PRIMARY KEY / UNIQUE constraints become unique sorted indexes
        # (reference: constraints create ART indexes on the table)
        for kind, col in (stmt.constraints or ()):
            prefix = "pk" if kind == "primary_key" else "uq"
            self.db.catalog.create_index(
                f"{prefix}_{stmt.name}_{col}".lower(), stmt.name, col,
                unique=True, if_not_exists=True)
        self._bump_catalog_version()
        return None

    def _append_mat(self, table, mat: Mat):
        data = {}
        validity = {}
        for name, t, c, v, d in zip(mat.names, mat.types, mat.cols, mat.valids, mat.dicts):
            tcol = table.columns[name.lower()] if name.lower() in table.columns else None
            if tcol is None:
                # align by position
                pass
            if v is not None:
                validity[name] = v
            data[name] = c
        # align by position against table column order
        by_pos = {}
        vd = {}
        for i, cname in enumerate(table.column_order):
            src = mat.cols[i]
            t = mat.types[i]
            col = table.columns[cname]
            if col.dictionary is not None and mat.dicts[i] is not None and \
               col.dictionary is not mat.dicts[i]:
                src = col.dictionary.encode(mat.dicts[i].decode(src))
            by_pos[cname] = src
            if mat.valids[i] is not None:
                vd[cname] = mat.valids[i]
        table.append_batch(by_pos, vd if vd else None)
        table.flush()

    def _execute_insert(self, stmt: ast.InsertStmt, lits=()):
        table = self.db.catalog.get_table(stmt.table)
        self._txn_touch(table)
        if stmt.select is not None:
            binder = Binder(self.db.catalog, self.db.config)
            plan = optimize(binder.bind_select(stmt.select), set())
            mat = self.executor.execute(plan, lits)
            if stmt.columns is not None and [c.lower() for c in stmt.columns] != table.column_order:
                raise SQLError("INSERT column list must match table order")
            self._append_mat(table, mat)
            return None
        cols = stmt.columns or table.column_order
        cols = [c.lower() for c in cols]
        n = len(stmt.rows)
        data: Dict[str, list] = {c: [] for c in cols}
        valid: Dict[str, list] = {c: [] for c in cols}
        binder = Binder(self.db.catalog, self.db.config)
        from adacom_tpu_torch.sql.binder import Scope

        scope = Scope()
        for row in stmt.rows:
            if len(row) != len(cols):
                raise SQLError("INSERT arity mismatch")
            for c, e in zip(cols, row):
                val = _const_eval(binder, e, scope, lits)
                data[c].append(val)
                valid[c].append(val is not None)
        batch = {}
        vbatch = {}
        any_null = False
        for c in cols:
            col = table.columns.get(c)
            if col is None:
                raise SQLError(f"unknown column {c}")
            vals = data[c]
            vmask = np.asarray(valid[c], dtype=bool)
            if col.dictionary is not None:
                arr = col.dictionary.encode(["" if v is None else str(v) for v in vals])
            else:
                dt = col.ltype.np_dtype
                if col.ltype.name == "DECIMAL":
                    scaled = [0 if v is None else int(round(float(v) * 10 ** col.ltype.scale)) for v in vals]
                    arr = np.asarray(scaled, dtype=dt)
                elif col.ltype is tt.DATE:
                    from adacom_tpu_torch.sql.binder import days_from_iso

                    arr = np.asarray(
                        [0 if v is None else (days_from_iso(v) if isinstance(v, str) else int(v)) for v in vals],
                        dtype=dt,
                    )
                else:
                    arr = np.asarray([0 if v is None else v for v in vals]).astype(dt)
            batch[c] = arr
            if not vmask.all():
                any_null = True
                vbatch[c] = vmask
        missing = [c for c in table.column_order if c not in batch]
        for c in missing:
            col = table.columns[c]
            batch[c] = np.zeros(n, dtype=col.ltype.np_dtype)
            vbatch[c] = np.zeros(n, dtype=bool)
            any_null = True
        table.append_batch(batch, vbatch if any_null else None)
        return None

    def _filter_row_matches(self, table_name: str, where, lits=()):
        """Evaluate a WHERE clause on the device scan (on the host tier for
        a scan the device path declines, as SELECT does); yields (table,
        seg_idx, row_idx_np) per segment with matches."""
        table = self.db.catalog.get_table(table_name)
        table.flush()
        get = self._bind_filter_plan(table_name, where)
        ex = self.executor
        if declines(get):
            snap = ex._pin_snapshot(table)
            candidates = ex._zonemap_candidates(get, lits, snap)
            for i, _cols, rows in ex._host_scan_morsels(get, lits, candidates,
                                                        snap):
                if len(rows):
                    yield table, i, rows
            return
        for ids, _counts, (mask, _cols) in ex._scan_batches(get, lits):
            hits = torch.nonzero(mask).cpu().numpy()  # (seg in chunk, row)
            bounds = np.searchsorted(hits[:, 0], np.arange(1, len(ids)))
            for i, rows in zip(ids, np.split(hits[:, 1], bounds)):
                if len(rows):
                    yield table, i, rows

    def _bind_filter_plan(self, table_name, where):
        from adacom_tpu_torch.sql import bound as b

        binder = Binder(self.db.catalog, self.db.config)
        sel = ast.SelectStmt(
            select_list=[(ast.Star(), None)],
            from_ref=ast.BaseTable(table_name, None),
            where=where,
        )
        plan = optimize(binder.bind_select(sel), set())
        for node in b.walk(plan):
            if isinstance(node, b.LogicalGet):
                return node
        raise SQLError("internal: no scan in DML plan")

    def _execute_delete(self, stmt: ast.DeleteStmt, lits=()):
        table = self.db.catalog.get_table(stmt.table)
        self._txn_touch(table)
        if stmt.where is None:
            # truncate IN PLACE: indexes and views on the table survive
            # (the old drop-and-recreate silently lost UNIQUE enforcement)
            table.truncate()
            self._bump_catalog_version()
            return None
        # collect matches first, publish once: the statement's delete masks
        # become visible to reader snapshots atomically
        updates = [(i, rows) for _t, i, rows
                   in self._filter_row_matches(stmt.table, stmt.where, lits)]
        if updates:
            table.mark_deleted_many(updates)
        return None

    def _execute_update(self, stmt: ast.UpdateStmt, lits=()):
        # UPDATE = select matching rows, delete them, re-append modified
        table = self.db.catalog.get_table(stmt.table)
        self._txn_touch(table)
        cols_sql = ", ".join(table.column_order)
        where_part = ""
        sel = ast.SelectStmt(
            select_list=[(ast.Star(), None)],
            from_ref=ast.BaseTable(stmt.table, None),
            where=stmt.where,
        )
        binder = Binder(self.db.catalog, self.db.config)
        plan = optimize(binder.bind_select(sel), set())
        mat = self.executor.execute(plan, lits)
        if mat.nrows == 0:
            return None
        # delete matched rows
        for table_, i, rows in self._filter_row_matches(stmt.table, stmt.where, lits):
            table_.mark_deleted(i, rows)
        # apply assignments on the materialized rows
        from adacom_tpu_torch.sql.binder import Scope

        scope = Scope.from_op(plan, None)
        name_to_pos = {n.lower(): i for i, n in enumerate(mat.names)}
        for cname, e in stmt.assignments:
            be = binder.bind_expr(e, scope)
            outs = self.executor._eval_on_mat([be], mat, lits)
            v, m = outs[0]
            arr = np.asarray(v)
            pos = name_to_pos[cname.lower()]
            col = table.columns[cname.lower()]
            if arr.ndim == 0:
                arr = np.full(mat.nrows, arr)
            if col.ltype.name == "DECIMAL" and be.ty.name != "DECIMAL":
                arr = np.round(arr.astype(np.float64) * 10 ** col.ltype.scale).astype(np.int64)
            mat.cols[pos] = arr.astype(col.ltype.np_dtype)
            mat.valids[pos] = None if m is None else np.asarray(m)
        self._append_mat(table, mat)
        return None

    # ------------------------------------------------------------------
    def _txn_touch(self, table):
        if self._in_txn and self._txn_snapshot is not None:
            from adacom_tpu_torch.storage.table import TransactionConflict

            name = table.name
            try:
                # pins the committed watermark + delete-mask snapshot so
                # concurrent readers keep seeing only committed state,
                # and rejects a second concurrent writer (reference
                # optimistic write-write conflict abort)
                table.begin_write_txn(self._token)
            except TransactionConflict as e:
                raise SQLError(str(e)) from e
            if name not in self._txn_snapshot:
                # seal staged rows into segments first: rollback truncation
                # drops the staging buffers, which would otherwise lose
                # pre-transaction rows that were still staged
                table.flush()
                self._txn_snapshot[name] = (
                    table.row_count(),
                    {k: v.copy() for k, v in table._deletes.items()},
                )

    def _execute_txn(self, stmt: ast.TransactionStmt):
        wal = self.db.wal
        if stmt.action == "begin":
            self._in_txn = True
            self._txn_snapshot = {}
            if wal is not None:
                wal.begin()
        elif stmt.action == "commit":
            snap = self._txn_snapshot or {}
            for name in snap:
                try:
                    self.db.catalog.get_table(name).end_write_txn(
                        self._token)
                except Exception:
                    pass
            self._in_txn = False
            self._txn_snapshot = None
            if wal is not None:
                wal.commit()
            self.db.maybe_autocheckpoint()
        elif stmt.action == "rollback":
            if wal is not None:
                wal.abort()
            if self._txn_snapshot:
                for name, (nrows, deletes) in self._txn_snapshot.items():
                    try:
                        table = self.db.catalog.get_table(name)
                    except Exception:
                        continue
                    self._truncate_to(table, nrows)
                    table._deletes = deletes
                    table.end_write_txn(self._token)
            self._in_txn = False
            self._txn_snapshot = None
        return None

    def _truncate_to(self, table, nrows: int):
        # staged rows may include pre-snapshot data (appends unseal the
        # trailing partial segment back into staging): seal everything
        # into segments first, then truncate by row position
        table.flush()
        for cname in table.column_order:
            col = table.columns[cname]
            total = 0
            keep = []
            for s in col.segments:
                if total + s.count <= nrows:
                    keep.append(s)
                    total += s.count
                elif total < nrows:
                    # partial segment: re-stage the prefix
                    prefix = s._host_values[: nrows - total]
                    pv = s._validity_np[: nrows - total] if s._validity_np is not None else None
                    col.segments = keep
                    col.stage(prefix, pv)
                    total = nrows
                    s.page_out()
                    break
                else:
                    s.page_out()
            col.segments = [s for s in col.segments if s in keep] if total >= nrows else col.segments

    # ------------------------------------------------------------------
    def _execute_pragma(self, stmt: ast.PragmaStmt):
        name = stmt.name.lower()
        cat = self.db.catalog.get_column_segment_catalog()
        if name in ("compact_all_segments", "compact_all"):
            cat.compact_all_segments()
            return None
        if name == "uncompact_all":
            for t in self.db.catalog.tables.values():
                t.uncompact_all()
            return None
        if name == "enable_background_compaction":
            cat.enable_background_compaction()
            return None
        if name == "disable_background_compaction":
            cat.disable_background_compaction()
            return None
        if name == "segment_stats":
            print(cat.print_stats())
            return None
        if name == "tpu_profile_start":
            # device trace capture: torch.profiler over the host and, on a
            # CUDA database, the card (the JAX package's PRAGMA runs
            # jax.profiler); the PRAGMA keeps the JAX package's name
            from torch.profiler import ProfilerActivity, profile

            if self.db._profiler is not None:
                raise SQLError("a tpu_profile trace is already running")
            path = (str(stmt.args[0]).strip("'\"") if stmt.args else
                    os.path.join(tempfile.gettempdir(), "adacom_trace"))
            activities = [ProfilerActivity.CPU]
            if self.db.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            self.db._profiler, self.db._trace_dir = prof, path
            return None
        if name == "tpu_profile_stop":
            prof = self.db._profiler
            if prof is None:
                raise SQLError("tpu_profile_stop without tpu_profile_start")
            if self.db.device.type == "cuda":
                torch.cuda.synchronize(self.db.device)
            prof.stop()
            self.db._profiler = None
            path = self.db._trace_dir
            os.makedirs(path, exist_ok=True)
            prof.export_chrome_trace(os.path.join(path, TRACE_FILE))
            return self._text_result("trace_dir", path)
        if name == "database_size":
            return self._scalar_result("database_size", tt.BIGINT,
                                       cat.get_total_data_size())
        if name == "compression_info":
            # per-segment codec report (reference PRAGMA show + the fork's
            # ColumnSegmentCatalog::Print, column_segment_catalog.cpp:138)
            only = str(stmt.args[0]).strip("'\"").lower() if stmt.args else None
            rows = []
            for tname, table in self.db.catalog.tables.items():
                if only and tname.lower() != only:
                    continue
                table.flush()
                for cname in table.column_order:
                    for si, seg in enumerate(table.columns[cname].segments):
                        rows.append((tname, cname, si,
                                     seg.codec or "uncompressed", seg.state,
                                     seg.count, seg.footprint_bytes(),
                                     seg.num_reads))
            names = ["table_name", "column_name", "segment_id", "codec",
                     "state", "rows", "bytes", "reads"]
            types = [tt.VARCHAR, tt.VARCHAR, tt.INTEGER, tt.VARCHAR,
                     tt.VARCHAR, tt.BIGINT, tt.BIGINT, tt.BIGINT]
            n = len(rows)
            idx = np.arange(n, dtype=np.uint32)
            cols = [
                idx, idx,
                np.asarray([r[2] for r in rows], dtype=np.int32),
                idx, idx,
                np.asarray([r[5] for r in rows], dtype=np.int64),
                np.asarray([r[6] for r in rows], dtype=np.int64),
                np.asarray([r[7] for r in rows], dtype=np.int64),
            ]
            dicts = [_TextDict([str(r[0]) for r in rows]),
                     _TextDict([str(r[1]) for r in rows]), None,
                     _TextDict([str(r[3]) for r in rows]),
                     _TextDict([str(r[4]) for r in rows]), None, None, None]
            return QueryResult(names, types, cols, [None] * 8, dicts)
        if name in ("enable_profiling", "enable_profile"):
            self.db.config.enable_profiling = True
            return None
        if name == "disable_profiling":
            self.db.config.enable_profiling = False
            return None
        if stmt.value is not None:
            self.db.config.set_option(name, stmt.value)
            return None
        if stmt.is_call and stmt.args:
            self.db.config.set_option(name, stmt.args[0])
            return None
        raise SQLError(f"unknown pragma {name}")

    def _scalar_result(self, name, ty, value):
        return QueryResult([name], [ty], [np.asarray([value])], [None], [None])

    def _execute_copy(self, stmt: ast.CopyStmt, lits=()):
        """COPY t FROM/TO 'file' (reference physical_copy_from_file /
        physical_copy_to_file over the parallel CSV reader)."""
        from adacom_tpu_torch.io import csv_io

        opts = stmt.options or {}
        delim = str(opts.get("delimiter", opts.get("delim", ",")))
        fmt = str(opts.get("format", "")).lower()
        if not fmt:
            low = stmt.path.lower()
            if low.endswith(".parquet"):
                fmt = "parquet"
            elif low.endswith(".json") or low.endswith(".ndjson"):
                fmt = "json"
        if stmt.direction == "from":
            table = self.db.catalog.get_table(stmt.table)
            header = opts.get("header")
            if fmt == "parquet":
                from adacom_tpu_torch.io import parquet_io

                names, types, cols, valids = parquet_io.read_parquet(
                    stmt.path)
            elif fmt == "json":
                from adacom_tpu_torch.io import json_io

                names, types, cols, valids = json_io.read_json(stmt.path)
            else:
                names, types, cols, valids = csv_io.read_csv(
                    stmt.path, header=header, delim=delim)
            if len(cols) != len(table.column_order):
                raise SQLError(
                    f"COPY: file has {len(cols)} columns, table "
                    f"{stmt.table} has {len(table.column_order)}")
            data = dict(zip(table.column_order, cols))
            validity = {c: v for c, v in zip(table.column_order, valids)
                        if v is not None}
            table.append_batch(data, validity or None)
            table.flush()
            n = len(cols[0]) if cols else 0
            return self._scalar_result("count", tt.BIGINT, n)
        # COPY ... TO
        if stmt.select is not None:
            sel = stmt.select
        else:
            self.db.catalog.get_table(stmt.table)  # existence check
            sel = ast.SelectStmt(select_list=[(ast.Star(), None)],
                                 from_ref=ast.BaseTable(stmt.table, None))
        binder = Binder(self.db.catalog, self.db.config)
        plan = optimize(binder.bind_select(sel), set())
        mat = self.executor.execute(plan, lits)
        res = QueryResult(mat.names, mat.types, mat.cols, mat.valids,
                          mat.dicts)
        if fmt == "parquet":
            from adacom_tpu_torch.io import parquet_io

            cols_out, types_out = [], []
            for t, c, d in zip(res.types, res._cols, res._dicts):
                arr = np.asarray(c)
                if d is not None:
                    strs = d.strings_array()
                    arr = [str(strs[int(i)]) if 0 <= int(i) < len(strs)
                           else "" for i in arr]
                elif getattr(t, "name", "") == "DECIMAL":
                    arr = arr.astype(np.float64) / (10.0 ** t.scale)
                    t = tt.DOUBLE
                cols_out.append(arr)
                types_out.append(t)
            n = parquet_io.write_parquet(stmt.path, res.names, types_out,
                                         cols_out, res._valids)
            return self._scalar_result("count", tt.BIGINT, n)
        rendered = [res._render_col(t, c, v, d) for t, c, v, d in
                    zip(res.types, res._cols, res._valids, res._dicts)]
        n = csv_io.write_csv(stmt.path, res.names, rendered,
                             header=bool(opts.get("header", True)),
                             delim=delim)
        return self._scalar_result("count", tt.BIGINT, n)

    def _execute_explain(self, stmt: ast.ExplainStmt, lits=()):
        if not isinstance(stmt.target, ast.SelectStmt):
            raise SQLError("EXPLAIN supports SELECT only")
        binder = Binder(self.db.catalog, self.db.config)
        plan = optimize(binder.bind_select(stmt.target), set())
        profile = None
        if stmt.analyze:
            # EXPLAIN ANALYZE: run the plan with per-operator timers
            # (reference physical_explain_analyze.cpp + OperatorProfiler)
            self.executor.profile = {}
            try:
                t0 = time.perf_counter()
                self.executor.execute(plan, list(lits))
                total = time.perf_counter() - t0
            finally:
                profile = self.executor.profile
                self.executor.profile = None
            text = _render_plan(plan, profile=profile)
            text += f"\nTotal Time: {total * 1e3:.3f} ms"
        else:
            text = _render_plan(plan)
        return QueryResult(
            ["explain"], [tt.VARCHAR],
            [np.arange(1, dtype=np.uint32)], [None],
            [_TextDict([text])],
        )

    def _text_result(self, name: str, value: str):
        return QueryResult([name], [tt.VARCHAR],
                           [np.arange(1, dtype=np.uint32)], [None],
                           [_TextDict([value])])

    def _execute_describe(self, stmt: ast.DescribeStmt):
        if not stmt.table:  # SHOW TABLES
            names = sorted(self.db.catalog.tables) + \
                sorted(getattr(self.db.catalog, "views", {}))
            return QueryResult(
                ["name"], [tt.VARCHAR],
                [np.arange(len(names), dtype=np.uint32)], [None],
                [_TextDict(names)],
            )
        table = self.db.catalog.get_table(stmt.table)
        names = table.column_order
        types = [str(table.columns[c].ltype) for c in names]
        nd = _TextDict(names)
        td = _TextDict(types)
        return QueryResult(
            ["column_name", "column_type"], [tt.VARCHAR, tt.VARCHAR],
            [np.arange(len(names), dtype=np.uint32),
             np.arange(len(types), dtype=np.uint32)],
            [None, None], [nd, td],
        )


class _TextDict:
    """Minimal read-only dictionary for synthesized VARCHAR results."""

    def __init__(self, strings):
        self._strings = list(strings)

    def decode(self, codes):
        return [self._strings[int(c)] for c in codes]

    def __len__(self):
        return len(self._strings)


def _const_eval(binder, e, scope, lits=()):
    """Evaluate a constant expression from INSERT ... VALUES; '?'
    placeholders and parameterized literals read their slot in `lits`."""
    from adacom_tpu_torch.sql.lexer import PLACEHOLDER

    be = binder.bind_expr(e, scope)
    from adacom_tpu_torch.sql import bound as b

    def ev(x):
        if isinstance(x, b.BLiteral):
            if x.param is not None and x.param < len(lits) and \
                    lits[x.param] is not PLACEHOLDER:
                return lits[x.param]
            return x.value
        if isinstance(x, b.BUnary) and x.op == "-":
            return -ev(x.operand)
        if isinstance(x, b.BCast):
            v = ev(x.operand)
            if v is None:
                return None
            if x.ty.name == "DECIMAL":
                return float(v)
            if x.ty is tt.DATE and isinstance(v, str):
                from adacom_tpu_torch.sql.binder import days_from_iso

                return days_from_iso(v)
            if x.ty.integer:
                return int(v)
            if x.ty.is_float:
                return float(v)
            return v
        if isinstance(x, b.BBinary):
            l, r = ev(x.left), ev(x.right)
            if l is None or r is None:
                return None
            return {"+": lambda: l + r, "-": lambda: l - r, "*": lambda: l * r,
                    "/": lambda: l / r, "%": lambda: l % r}[x.op]()
        raise SQLError("INSERT VALUES must be constant expressions")

    return ev(be)


def _render_plan(plan, indent=0, profile=None) -> str:
    import dataclasses as dc

    from adacom_tpu_torch.sql import bound as b

    pad = "  " * indent
    name = type(plan).__name__.replace("Logical", "")
    extra = ""
    if isinstance(plan, b.LogicalGet):
        extra = f" {plan.table_name}{plan.column_ids}"
        if plan.filters:
            extra += f" filters={len(plan.filters)}"
    prof = ""
    if profile is not None:
        entry = profile.get(id(plan))
        if entry is not None:
            incl, rows = entry
            child_s = sum(
                profile.get(id(getattr(plan, f.name)), (0.0, 0))[0]
                for f in dc.fields(plan)
                if isinstance(getattr(plan, f.name), b.LogicalOp))
            prof = (f"  [rows={rows} time={incl * 1e3:.3f}ms "
                    f"self={(incl - child_s) * 1e3:.3f}ms]")
    lines = [f"{pad}{name}{extra}  -> {list(plan.names)}{prof}"]
    for f in dc.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, b.LogicalOp):
            lines.append(_render_plan(v, indent + 1, profile))
    return "\n".join(lines)


class PreparedStatement:
    """Parse-once statement with '?' parameter slots (reference
    PreparedStatement, src/main/prepared_statement.cpp). The engine's
    literal-parameterized plan cache makes execution a pure cache hit:
    binding happened once, values flow through the literal slots."""

    def __init__(self, connection, sql: str):
        from adacom_tpu_torch.sql.lexer import PLACEHOLDER
        from adacom_tpu_torch.sql.parser import parse

        self.con = connection
        self.sql = sql
        self._parsed = parse(sql)
        _stmts, _key, lits, _structural = self._parsed
        self.n_params = sum(1 for v in lits if v is PLACEHOLDER)
        self._slots = [i for i, v in enumerate(lits) if v is PLACEHOLDER]

    def execute(self, *params):
        if len(params) != self.n_params:
            raise SQLError(
                f"prepared statement takes {self.n_params} parameters, "
                f"got {len(params)}")
        stmts, key, lits, structural = self._parsed
        lits2 = list(lits)
        for s, p in zip(self._slots, params):
            lits2[s] = p
        res = None
        for i, stmt in enumerate(stmts):
            res = self.con._execute_stmt(stmt, key, lits2, structural, i,
                                         self.sql)
        return res

    __call__ = execute
