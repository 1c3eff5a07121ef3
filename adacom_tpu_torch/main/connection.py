"""Connection: the query entry point (reference Connection::Query,
src/main/connection.cpp:74 -> ClientContext::Query, client_context.cpp:792).
Port of adacom_tpu/main/connection.py.

Statement flow mirrors SURVEY.md §3.1: parse -> bind -> optimize ->
execute, with a *plan cache* keyed on the literal-parameterized SQL
template (+ structural literal values + catalog version) so repeated
point lookups skip everything but execution — the TPU answer to the
reference's 10k-sequential-lookup benchmarks."""

from __future__ import annotations

import itertools
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.exec.device_scan import declines
from adacom_tpu_torch.exec.executor import Executor, Mat
from adacom_tpu_torch.main import coerce
from adacom_tpu_torch.main.result import QueryResult
from adacom_tpu_torch.sql import ast
from adacom_tpu_torch.catalog.catalog import CatalogException, Transaction
from adacom_tpu_torch.sql.binder import Binder, BindError
from adacom_tpu_torch.sql.optimizer import optimize
from adacom_tpu_torch.sql.parser import parse
from adacom_tpu_torch.storage.table import TransactionConflict
from adacom_tpu_torch.utils import trace as qtrace


# the Chrome trace PRAGMA tpu_profile_stop writes into the trace directory
TRACE_FILE = "trace.json"


class SQLError(Exception):
    pass


# connection tokens: one per connection for the life of the process, so a
# new connection never inherits what a collected one owned (id() may repeat)
_TOKENS = itertools.count(1)


class Connection:
    def __init__(self, database):
        self.db = database
        self.executor = Executor(database)
        # the open transaction (BEGIN .. COMMIT/ROLLBACK), None in autocommit
        self._txn: Optional[Transaction] = None
        self.last_profile: Optional[dict] = None
        # MVCC identity: write-ownership token + reader visibility key
        self._token = next(_TOKENS)
        self.executor.conn_token = self._token
        # statement numbers on this connection (the spans' query ids)
        self._statement_ids = itertools.count(1)
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
        try:
            return self._dispatch(stmt, key, lits, structural, stmt_idx, sql)
        except TransactionConflict as e:
            raise SQLError(str(e)) from e

    def _new_trace(self) -> qtrace.StatementTrace:
        return qtrace.StatementTrace(
            f"{self._token}.{next(self._statement_ids)}")

    def _dispatch(self, stmt, key, lits, structural, stmt_idx, sql):
        """Run one statement; under PRAGMA enable_profiling in a
        `query` span of a new StatementTrace (or, for a statement that
        another runs, such as EXECUTE's, of the running one), whose
        profile becomes last_profile."""
        outer = self.executor.trace
        tr = outer
        if tr is None and self.db.config.enable_profiling:
            tr = self.executor.trace = self._new_trace()
        sp = None if tr is None else tr.begin("query")
        try:
            res = self._run_stmt(stmt, key, lits, structural, stmt_idx, sql,
                                 tr)
        finally:
            self.executor.trace = outer
        if sp is not None:
            tr.end(sp)
            if tr is not outer:
                self.last_profile = self._profile(stmt, tr, sp)
        return res

    def _profile(self, stmt, tr: qtrace.StatementTrace, root: dict) -> dict:
        """last_profile of a statement (QueryProfiler parity,
        src/main/query_profiler.cpp): a SELECT's per-phase timers and
        per-operator tree (QueryTreeToString), every statement's total,
        spans and counters."""
        prof = {"statement": type(stmt).__name__, "query_id": tr.query_id}
        if isinstance(stmt, ast.SelectStmt):
            prof["phases"] = qtrace.phases(tr.spans, root)
            prof["operators"] = tr.operators
        prof.update({"total_s": qtrace.seconds(root), "spans": tr.spans,
                     "counters": tr.counters})
        qtrace.keep(prof)
        return prof

    def _run_stmt(self, stmt, key, lits, structural, stmt_idx, sql, tr):
        self.db.buffer_manager.begin_statement(tr)
        txn = self._txn
        if isinstance(stmt, ast.SelectStmt):
            res = self._execute_select(stmt, key, lits, structural, stmt_idx, sql)
        elif isinstance(stmt, ast.CreateTableStmt):
            res = self._execute_create_table(stmt, lits)
        elif isinstance(stmt, ast.CreateViewStmt):
            self.db.catalog.create_view(stmt.name, stmt.select_sql,
                                        stmt.or_replace, txn=txn)
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
                    stmt.if_not_exists, txn=txn)
            except ConstraintViolation as e:
                raise SQLError(str(e)) from e
            self._bump_catalog_version()
            res = None
        elif isinstance(stmt, ast.DropStmt):
            if stmt.kind == "view":
                self.db.catalog.drop_view(stmt.name, txn=txn)
            elif stmt.kind == "index":
                self.db.catalog.drop_index(stmt.name, stmt.if_exists,
                                           txn=txn)
            else:
                self.db.catalog.drop_table(stmt.name, stmt.if_exists,
                                           txn=txn)
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
            if not self.db.checkpoint():
                raise SQLError("cannot CHECKPOINT while a write transaction "
                               "is open")
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
                self._txn is None:
            self.db.maybe_autocheckpoint()
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
        tr = self.executor.trace
        lock = self.db.plan_cache_lock
        with lock if tr is None else tr.timed(lock):
            hit = self.db.plan_cache.get(cache_key)
        if hit is not None:
            if tr is not None:
                tr.set(plan_cache_hit=1)
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
        with lock if tr is None else tr.timed(lock):
            self.db.template_slots[(key, stmt_idx)] = frozenset(all_structural)
            self.db.plan_cache[full_key] = plan
            if len(self.db.plan_cache) > 4096:
                self.db.plan_cache.clear()
            if len(self.db.template_slots) > 8192:
                self.db.template_slots.clear()
        if tr is not None:
            tr.set(plan_cache_hit=0)
        return plan

    def _execute_select(self, stmt, key, lits, structural, stmt_idx,
                        sql=None) -> QueryResult:
        tr = self.executor.trace
        sp = None if tr is None else tr.begin("plan")
        try:
            plan = self._plan_select(stmt, key, lits, structural, stmt_idx)
        except (BindError, CatalogException) as e:
            raise SQLError(str(e)) from e
        if sp is not None:
            tr.end(sp)
            sp = tr.begin("execute")
        mat = self.executor.execute(plan, lits)
        if sp is not None:
            tr.end(sp)
            tr.operators = _render_plan(
                plan, profile=qtrace.operator_profile(tr.spans, sp["id"]))
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
            self.db.catalog.create_table(
                stmt.name, cols, stmt.if_not_exists,
                fill=lambda table: self._append_mat(table, mat),
                txn=self._txn)
            self._bump_catalog_version()
            return None
        cols = []
        for cname, ctype, targs in stmt.columns:
            cols.append((cname, tt.type_from_name(ctype, targs)))
        # PRIMARY KEY / UNIQUE constraints become unique sorted indexes
        # (reference: constraints create ART indexes on the table)
        unique = [(f"{'pk' if kind == 'primary_key' else 'uq'}_"
                   f"{stmt.name}_{col}", col)
                  for kind, col in (stmt.constraints or ())]
        self.db.catalog.create_table(stmt.name, cols, stmt.if_not_exists,
                                     unique=unique, txn=self._txn)
        self._bump_catalog_version()
        return None

    def _append_mat(self, table, mat: Mat, token: Optional[int] = None):
        """Append a SELECT's rows by position; a column of another type is
        cast into the table column's, by UPDATE's rule (main/coerce.py).
        `token`: the writing transaction's (Table.append_batch)."""
        by_pos = {}
        vd = {}
        for i, cname in enumerate(table.column_order):
            src, t, d = mat.cols[i], mat.types[i], mat.dicts[i]
            col = table.columns[cname]
            if t.is_string and col.ltype.is_string:
                if col.dictionary is not None and d is not None and \
                        col.dictionary is not d:
                    src = col.dictionary.encode(d.decode(src))
            elif t != col.ltype:
                try:
                    src = coerce.cast(src, mat.valids[i], t, col.ltype,
                                      mat.nrows, d, col.dictionary)
                except ValueError as e:
                    raise SQLError(f"INSERT INTO {table.name} ({cname}): "
                                   f"{e}") from e
            by_pos[cname] = src
            if mat.valids[i] is not None:
                vd[cname] = mat.valids[i]
        table.append_batch(by_pos, vd if vd else None, token=token)
        table.flush()

    def _execute_insert(self, stmt: ast.InsertStmt, lits=()):
        table = self.db.catalog.get_table(stmt.table)
        token = self._txn_touch(table)
        if stmt.select is not None:
            binder = Binder(self.db.catalog, self.db.config)
            plan = optimize(binder.bind_select(stmt.select), set())
            mat = self.executor.execute(plan, lits)
            if stmt.columns is not None and [c.lower() for c in stmt.columns] != table.column_order:
                raise SQLError("INSERT column list must match table order")
            self._append_mat(table, mat, token)
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
                # the rules of UPDATE and COPY (main/coerce.py)
                try:
                    arr = coerce.from_values(vals, col.ltype)
                except ValueError as e:
                    raise SQLError(f"INSERT INTO {stmt.table} ({c}): {e}") \
                        from e
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
        table.append_batch(batch, vbatch if any_null else None, token=token)
        return None

    def _filter_row_matches(self, table_name: str, where, lits=()):
        """Evaluate a WHERE clause on the device scan (on the host tier for
        a scan the device path declines, as SELECT does) over one pinned
        snapshot; returns (get, snapshot, [(seg_idx, row_idx_np)]) for the
        segments with matches."""
        table = self.db.catalog.get_table(table_name)
        table.flush()
        get = self._bind_filter_plan(table_name, where)
        ex = self.executor
        snap = ex._pin_snapshot(table)
        matches = []
        if declines(get):
            candidates = ex._zonemap_candidates(get, lits, snap)
            for i, _cols, rows in ex._host_scan_morsels(get, lits, candidates,
                                                        snap):
                if len(rows):
                    matches.append((i, rows))
            return get, snap, matches
        for ids, _counts, (mask, _cols) in ex._scan_batches(get, lits, snap):
            hits = torch.nonzero(mask).cpu().numpy()  # (seg in chunk, row)
            bounds = np.searchsorted(hits[:, 0], np.arange(1, len(ids)))
            for i, rows in zip(ids, np.split(hits[:, 1], bounds)):
                if len(rows):
                    matches.append((i, rows))
        return get, snap, sorted(matches, key=lambda m: m[0])

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
        token = self._txn_touch(table)
        if stmt.where is None and token is None:
            # truncate IN PLACE: indexes and views on the table survive
            # (the old drop-and-recreate silently lost UNIQUE enforcement)
            table.truncate()
            self._bump_catalog_version()
            return None
        if stmt.where is None:
            # inside a transaction every row is deleted through the delete
            # masks, which ROLLBACK restores (a truncate cannot be undone)
            table.flush()
            col0 = table.columns[table.column_order[0]]
            updates = [(i, np.arange(s.count))
                       for i, s in enumerate(col0.segments) if s.count]
            if updates:
                table.mark_deleted_many(updates, token=token)
            return None
        # collect matches first, publish once: the statement's delete masks
        # become visible to reader snapshots atomically
        _get, _snap, updates = self._filter_row_matches(stmt.table,
                                                        stmt.where, lits)
        if updates:
            table.mark_deleted_many(updates, token=token)
        return None

    def _execute_update(self, stmt: ast.UpdateStmt, lits=()):
        """UPDATE = the matched rows' new versions appended and their old
        ones deleted, in one step (Table.replace_rows). The rows and their
        values come from the snapshot the WHERE ran on; every new value is
        cast into its column's type before anything changes, so an UPDATE
        that raises leaves the table, its indexes and the WAL as they
        were (the JAX package deletes the rows first and loses them when
        the append raises)."""
        from adacom_tpu_torch.sql.binder import Scope

        table = self.db.catalog.get_table(stmt.table)
        token = self._txn_touch(table)
        get, snap, updates = self._filter_row_matches(stmt.table, stmt.where,
                                                      lits)
        if not updates:
            return None
        mat = _rows_of(snap, get, updates)
        binder = Binder(self.db.catalog, self.db.config)
        scope = Scope.from_op(get, stmt.table)
        data = dict(zip(get.column_ids, mat.cols))
        valid = dict(zip(get.column_ids, mat.valids))
        for cname, e in stmt.assignments:
            cname = cname.lower()
            if cname not in data:
                raise SQLError(f"unknown column {cname}")
            be = binder.bind_expr(e, scope)
            col = table.columns[cname]
            text = _literal_text(be, lits) if col.ltype.name == "DECIMAL" \
                else None
            if text is not None:
                # all of a literal's digits, as INSERT keeps them
                v, m = text, None
            else:
                (v, m), = self.executor._eval_on_mat([be], mat, lits)
            ok = None if m is None else np.broadcast_to(
                np.asarray(m, bool), (mat.nrows,))
            try:
                data[cname] = coerce.cast(v, ok, be.ty, col.ltype, mat.nrows,
                                          binder._expr_dict(be),
                                          col.dictionary)
            except ValueError as err:
                raise SQLError(f"UPDATE {stmt.table} SET {cname}: {err}") \
                    from err
            valid[cname] = None if ok is None or ok.all() else ok.copy()
        table.replace_rows(updates, data,
                           {c: v for c, v in valid.items() if v is not None}
                           or None, token=token)
        return None

    # ------------------------------------------------------------------
    def _txn_touch(self, table) -> Optional[int]:
        """The write token of this connection's next write to `table`: in a
        transaction, its first write makes the table the transaction's
        (TransactionConflict if another transaction owns it; concurrent
        readers keep seeing the committed rows); outside one None, an
        autocommit write, which the table refuses while a transaction owns
        it."""
        if self._txn is None:
            return None
        self.db.catalog.own(self._txn, table)
        return self._txn.token

    def _execute_txn(self, stmt: ast.TransactionStmt):
        if stmt.action == "begin":
            if self._txn is not None:
                raise SQLError("a transaction is already open")
            self._txn = Transaction(self._token, self.db.wal is not None)
            return None
        txn = self._txn
        if txn is None:
            return None
        commit = stmt.action == "commit"
        # a COMMIT whose WAL write raises leaves the transaction open
        self.db.catalog.end_transaction(txn, commit)
        self._txn = None
        if commit:
            self.db.maybe_autocheckpoint()
        elif txn.undo:
            self._bump_catalog_version()  # plans of undone tables/views
        return None

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
            # every field takes its column's type (main/coerce.py): the
            # JAX package appends the sniffed types as they are, so a
            # DECIMAL column got DOUBLEs unscaled
            try:
                if fmt == "parquet":
                    from adacom_tpu_torch.io import parquet_io

                    names, types, cols, valids = parquet_io.read_parquet(
                        stmt.path)
                elif fmt == "json":
                    from adacom_tpu_torch.io import json_io

                    names, types, cols, valids = json_io.read_json(stmt.path)
                else:
                    names, types, cols, valids = csv_io.read_csv(
                        stmt.path, header=header, delim=delim,
                        types=table.column_types)
                if len(cols) != len(table.column_order):
                    raise SQLError(
                        f"COPY: file has {len(cols)} columns, table "
                        f"{stmt.table} has {len(table.column_order)}")
                if fmt in ("parquet", "json"):
                    cols = [_copy_cast(c, v, src, dst, names[i])
                            for i, (c, v, src, dst) in enumerate(zip(
                                cols, valids, types, table.column_types))]
            except ValueError as e:
                raise SQLError(f"COPY {stmt.table}: {e}") from e
            data = dict(zip(table.column_order, cols))
            validity = {c: v for c, v in zip(table.column_order, valids)
                        if v is not None}
            table.append_batch(data, validity or None,
                               token=self._txn_touch(table))
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
        if stmt.analyze:
            # EXPLAIN ANALYZE: run the plan in operator spans (reference
            # physical_explain_analyze.cpp + OperatorProfiler), of the
            # statement's trace under profiling, else of a trace of its own
            ex = self.executor
            tr = ex.trace
            if tr is None:
                ex.trace = self._new_trace()
            since = len(ex.trace.spans)
            try:
                t0 = time.perf_counter()
                ex.execute(plan, list(lits))
                total = time.perf_counter() - t0
                text = _render_plan(plan, profile=qtrace.operator_profile(
                    ex.trace.spans, since))
            finally:
                ex.trace = tr
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


def _literal_text(be, lits) -> Optional[str]:
    """The text of a numeric literal written with a fraction (sql/lexer.py
    NumText), negated or not; None for any other expression."""
    from adacom_tpu_torch.sql import bound as b

    neg = isinstance(be, b.BUnary) and be.op == "-"
    if neg:
        be = be.operand
    if not isinstance(be, b.BLiteral):
        return None
    v = lits[be.param] if be.param is not None and be.param < len(lits) \
        else be.value
    if not getattr(v, "text", None):
        return None
    return (-v).text if neg else v.text


def _copy_cast(col, valid, src, dst, name):
    """A column read from Parquet or JSON (typed by its reader) as values
    of the table column's type `dst`."""
    if src == dst or (src.is_string and dst.is_string):
        return col
    try:
        return coerce.cast(col, valid, src, dst, len(col))
    except ValueError as e:
        raise ValueError(f"column {name}: {e}") from None


def _rows_of(snap, get, updates) -> Mat:
    """The rows `updates` ([(segment index, rows)]) of a pinned snapshot,
    every column of the scan `get`, as a Mat."""
    cols, valids = [], []
    for c in get.column_ids:
        segs = [snap.segment(c, i) for i, _rows in updates]
        cols.append(np.concatenate([
            s._host_compute_values()[rows]
            for s, (_i, rows) in zip(segs, updates)]))
        masks = [s.host_validity() for s in segs]
        valids.append(None if all(m is None for m in masks) else
                      np.concatenate([
                          np.ones(len(rows), bool) if m is None else m[rows]
                          for m, (_i, rows) in zip(masks, updates)]))
    return Mat(list(get.names), list(get.types),
               list(getattr(get, "dicts", [None] * len(get.names))), cols,
               valids)


def _const_eval(binder, e, scope, lits=()):
    """Evaluate a constant expression from INSERT ... VALUES; '?'
    placeholders and parameterized literals read their slot in `lits`."""
    from adacom_tpu_torch.sql.lexer import PLACEHOLDER

    be = binder.bind_expr(e, scope)
    from adacom_tpu_torch.sql import bound as b
    from adacom_tpu_torch.sql.binder import days_from_iso, iso_from_days

    def ev(x):
        if isinstance(x, b.BLiteral):
            v = x.value
            if x.param is not None and x.param < len(lits) and \
                    lits[x.param] is not PLACEHOLDER:
                v = lits[x.param]
            if x.ty is tt.DATE and isinstance(v, str):
                return days_from_iso(v)  # a DATE evaluates to its days
            return v
        if isinstance(x, b.BUnary) and x.op == "-":
            return -ev(x.operand)
        if isinstance(x, b.BCast):
            v = ev(x.operand)
            if v is None:
                return None
            if x.ty.name == "DECIMAL":
                return float(v)
            if x.ty is tt.DATE and isinstance(v, str):
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

    v = ev(be)
    if be.ty is tt.DATE and isinstance(v, (int, np.integer)):
        return iso_from_days(v)  # as the literal's text, for any column
    return v


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
