"""Query executor: logical plan -> the device tiers + host operators.

Port of adacom_tpu/exec/executor.py (reference physical planner + pipeline
executor, src/execution/physical_plan_generator.cpp). It carries:

- scans over a pinned table snapshot with vectorized zonemap pruning
  (CheckZonemapSegments, row_group.cpp:287), routed as the JAX package's
  (_materialize_scan): the host tier (numpy plus the native C++ filters
  over the segments' host copies) answers point lookups and, with
  host_materialize set, every materialization; otherwise, and where a
  host filter leaves numpy (_FallbackToDevice), the generic device path
  (exec/device_scan.py) decodes, filters and compacts;
- filter, project, order, top-N, limit, sample, VALUES, DISTINCT, the set
  operations and window functions (exec/window.py) over materialized
  batches, with the external sort and the spilled join of exec/spill.py
  under a memory_limit;
- joins (exec/join.py): the index join, the streamed probe, the
  materializing hash join and cross product, and the streamed
  join -> aggregate pipeline;
- aggregates over a scan route as the JAX package's do
  (_aggregate_over_scan): an ungrouped sum/count/min/max over one packed
  4-byte integer column runs the fused table scan (ops/fused_scan.py,
  kernel B1); other ungrouped SUM/COUNT aggregates over polynomials of
  packed columns run the multi grouped scan (ops/grouped_scan.py, B3);
  grouped aggregates over a small dense domain run the grouped scan (B2)
  or, failing that, B3. Non-dense domains, DISTINCT and holistic
  aggregates take the host hash aggregate over a host scan; everything
  else the fused kernels decline runs on the generic device path.
  Aggregates over a join take the streamed pipeline, else the host
  aggregate.

Every plan node the JAX package's executor routes is routed here, and
with a mesh (Database(mesh=...)) at the same decisions as the JAX
package: the fused kernels B1-B3 and the streamed pipelines decline, the
generic scan-aggregate runs distributed over the mesh's shards
(exec/device_scan.py) and large equi-joins on unique build keys shuffle
over it (exec/join.py, parallel/ops.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.ops import bitpack, fused_scan, grouped_scan
from adacom_tpu_torch.sql import bound as b
from adacom_tpu_torch.exec.expr import ExprCompiler, CompiledExpr, compute_dtype_of
from adacom_tpu_torch.exec.device_scan import DeviceScan, declines, pool_cache
from adacom_tpu_torch.exec.join import Join, _hash_join_pairs, _row_keys
from adacom_tpu_torch.exec.mat import ExecError, Mat, _FallbackToDevice


# ======================================================================
# executor
# ======================================================================


class Executor(DeviceScan, Join):
    def __init__(self, database):
        self.db = database
        self.config = database.config
        # per-operator profiling sink: id(node) -> (inclusive_s, rows_out)
        # (reference OperatorProfiler, src/main/query_profiler.cpp; enabled
        # by EXPLAIN ANALYZE / PRAGMA enable_profiling)
        self.profile: Optional[Dict[int, tuple]] = None

    # ------------------------------------------------------------------
    def execute(self, plan: b.LogicalOp, lits: List[Any]) -> Mat:
        self._prepare_subqueries(plan, lits)
        return self._exec(plan, lits)

    def _prepare_subqueries(self, plan: b.LogicalOp, lits) -> None:
        """Evaluate uncorrelated scalar/exists/in subqueries and stash their
        results on the BSubquery nodes before compiled expressions run."""
        has = getattr(plan, "_has_subqueries", None)
        if has is False:  # cached: plan contains none (point-lookup hot path)
            return
        if has is None:
            plan._has_subqueries = any(
                isinstance(sq, b.BSubquery)
                for node in b.walk(plan)
                for e in b.iter_node_exprs(node)
                for sq in b.expr_walk(e)
            )
            if not plan._has_subqueries:
                return
        for node in b.walk(plan):
            for e in b.iter_node_exprs(node):
                for sq in b.expr_walk(e):
                    if not isinstance(sq, b.BSubquery):
                        continue
                    mat = self.execute(sq.plan, lits)
                    if sq.kind == "exists":
                        hit = mat.nrows > 0
                        sq.cached_value = np.asarray(not hit if sq.negated else hit)
                    elif sq.kind == "scalar":
                        if mat.nrows == 0 or (
                            mat.valids[0] is not None and not mat.valids[0][0]
                        ):
                            sq.cached_value = None
                        else:
                            sq.cached_value = np.asarray(mat.cols[0][0])
                    else:  # 'in' not rewritten to a join: membership array
                        col = mat.cols[0]
                        if mat.valids[0] is not None:
                            col = col[mat.valids[0]]
                        sq.cached_value = np.unique(col)

    def _exec(self, node: b.LogicalOp, lits) -> Mat:
        if self.profile is None:
            return self._dispatch(node, lits)
        import time as _time

        t0 = _time.perf_counter()
        mat = self._dispatch(node, lits)
        dt, rows = _time.perf_counter() - t0, mat.nrows
        prev = self.profile.get(id(node))
        if prev is not None:  # node re-executed (e.g. subquery): accumulate
            dt, rows = dt + prev[0], rows + prev[1]
        self.profile[id(node)] = (dt, rows)
        return mat

    def _dispatch(self, node: b.LogicalOp, lits) -> Mat:
        if isinstance(node, b.LogicalGet):
            return self._materialize_scan(node, lits)
        if isinstance(node, b.LogicalSample):
            return self._exec_sample(node, lits)
        if isinstance(node, b.LogicalValues):
            return self._exec_values(node, lits)
        if isinstance(node, b.LogicalFilter):
            return self._exec_filter(node, lits)
        if isinstance(node, b.LogicalProject):
            return self._exec_project(node, lits)
        if isinstance(node, b.LogicalAggregate):
            return self._exec_aggregate(node, lits)
        if isinstance(node, b.LogicalJoin):
            return self._exec_join(node, lits)
        if isinstance(node, b.LogicalOrder):
            return self._exec_order(node, lits)
        if isinstance(node, b.LogicalTopN):
            return self._exec_topn(node, lits)
        if isinstance(node, b.LogicalLimit):
            return self._exec_limit(node, lits)
        if isinstance(node, b.LogicalDistinct):
            return self._exec_distinct(node, lits)
        if isinstance(node, b.LogicalSetOp):
            return self._exec_setop(node, lits)
        if isinstance(node, b.LogicalWindow):
            return self._exec_window(node, lits)
        raise ExecError(f"no executor for {type(node).__name__}")

    # ==================================================================
    # scans
    # ==================================================================

    def _compiled_filter(self, get: b.LogicalGet) -> Optional[CompiledExpr]:
        cache = getattr(get, "_filter_cc", None)
        if cache is not None:
            return cache or None
        if not get.filters:
            get._filter_cc = False
            return None
        cond = get.filters[0]
        for c in get.filters[1:]:
            cond = b.BBinary(tt.BOOLEAN, "and", cond, c)
        cc = ExprCompiler().compile(cond)
        get._filter_cc = cc
        return cc

    def _pin_snapshot(self, table):
        """Pin a consistent TableSnapshot for this scan (storage/table.py
        TableSnapshot): segment tuples + delete masks captured atomically,
        MVCC-clamped to the committed watermark for non-owning readers.
        Every reader access below resolves through the snapshot — live
        ``columns[c].segments`` lists mutate under concurrent appends
        (unseal-partial pops the tail) and raced the round-4 scans."""
        return table.read_snapshot(getattr(self, "conn_token", None))

    def _zonemap_candidates(self, get: b.LogicalGet, lits, snap=None) -> List[int]:
        """Vectorized segment skipping from (col op literal) conjuncts
        over a pinned snapshot (the snapshot already applies the MVCC
        committed-watermark clamp)."""
        if snap is None:
            snap = self._pin_snapshot(get.table)
        n_seg = snap.segment_count()
        keep = np.ones(n_seg, dtype=bool)
        for f in get.filters:
            probe = _zonemap_probe(f, lits)
            if probe is None:
                continue
            col_idx, op, val = probe
            col_name = get.column_ids[col_idx]
            mins, maxs = self._table_zonemaps(get.table, col_name, snap)
            if op == "=":
                keep &= (mins[:n_seg] <= val) & (val <= maxs[:n_seg])
            elif op in ("<", "<="):
                keep &= mins[:n_seg] <= val if op == "<=" \
                    else mins[:n_seg] < val
            elif op in (">", ">="):
                keep &= maxs[:n_seg] >= val if op == ">=" \
                    else maxs[:n_seg] > val
        # nonzero beats a python loop at point-lookup rates (10k qps over
        # 1526 segments made the comprehension ~20% of lookup cost)
        return np.nonzero(keep)[0].tolist()

    def _table_zonemaps(self, table, col_name, snap=None):
        segs = snap.segments(col_name) if snap is not None \
            else tuple(table.columns[col_name].segments)
        col = table.columns[col_name]
        cache = getattr(col, "_zonemap_cache", None)
        # the tail segment can be REPLACED in place (unseal-partial +
        # append reseals it larger with new bounds) without changing the
        # segment count — key on the tail's identity and count too, or a
        # stale zonemap hides freshly appended rows from scans/DML
        # (found by tools/fuzz_dml.py seed 1)
        tail = segs[-1] if segs else None
        key = (len(segs), id(tail), tail.count if tail is not None else 0)
        if cache is not None and cache[0] == key:
            return cache[1], cache[2]
        # longdouble: 64-bit mantissa keeps u64 zonemap bounds exact
        mins = np.array([s.vmin for s in segs], dtype=np.longdouble)
        maxs = np.array([s.vmax for s in segs], dtype=np.longdouble)
        col._zonemap_cache = (key, mins, maxs)
        return mins, maxs

    def _materialize_scan(self, get: b.LogicalGet, lits) -> Mat:
        """Host tier for selective lookups and, with host_materialize set,
        every materialization (the output is host-resident either way);
        otherwise the device scan, which also takes a host scan whose
        filter leaves numpy. Scans the device path declines stay on the
        host."""
        limit = self.config.host_scan_segment_limit
        declined = declines(get)
        on_host = self.config.host_materialize or declined
        if on_host or (limit and get.filters):
            snap = self._pin_snapshot(get.table)
            candidates = self._zonemap_candidates(get, lits, snap)
            if on_host or len(candidates) <= limit:
                try:
                    return self._materialize_scan_host(get, lits, candidates,
                                                       snap)
                except _FallbackToDevice:
                    if declined:
                        raise
        return self._materialize_scan_device(get, lits)

    def _materialize_scan_host(self, get: b.LogicalGet, lits, candidates,
                               snap) -> Mat:
        """NumPy evaluation over segment host copies (one segment per
        morsel, in parallel on the task scheduler)."""
        ncols = len(get.column_ids)
        per_col: List[List[np.ndarray]] = [[] for _ in range(ncols)]
        per_valid: List[List[Optional[np.ndarray]]] = [[] for _ in range(ncols)]
        any_valid = [False] * ncols
        for _i, cols, rows in self._host_scan_morsels(get, lits, candidates,
                                                      snap):
            for c in range(ncols):
                per_col[c].append(cols[c][0][rows])
                v = cols[c][1]
                if v is not None:
                    any_valid[c] = True
                per_valid[c].append(None if v is None else v[rows])
        dicts = getattr(get, "dicts", [None] * ncols)
        cols_np = [
            np.concatenate(per_col[c]) if per_col[c]
            else np.empty(0, compute_dtype_of(get.types[c]))
            for c in range(ncols)
        ]
        valids_np: List[Optional[np.ndarray]] = []
        for c in range(ncols):
            if not any_valid[c]:
                valids_np.append(None)
            else:
                valids_np.append(np.concatenate([
                    v if v is not None else np.ones(len(a), bool)
                    for v, a in zip(per_valid[c], per_col[c])
                ]))
        return Mat(list(get.names), list(get.types), list(dicts), cols_np, valids_np)

    def _host_scan_morsels(self, get: b.LogicalGet, lits, candidates, snap):
        """The host tier's filter over segment host copies: [(segment
        index, [(values, valid | None)] per column, kept row indices)] in
        candidate order."""
        table = get.table
        filt = self._compiled_filter(get)
        params = filt.prep_args(lits) if filt is not None else ()
        # single eq-conjunct fast path -> native C++ filter kernel
        eq_probe = None
        index_hits = None
        if len(get.filters) == 1:
            p = _zonemap_probe(get.filters[0], lits)
            if p is not None and p[1] == "=" and float(p[2]).is_integer():
                eq_probe = (p[0], int(p[2]))
            if p is not None and p[1] == "=":
                # index-scan rewrite (reference table_scan.cpp:388): a sorted
                # index answers the equality probe with binary searches
                idxo = table.index_on(get.column_ids[p[0]])
                if idxo is None and self.config.auto_index_threshold and \
                        len(candidates) >= 4:
                    # adaptive auto-index: repeated selective eq probes on
                    # a column whose zonemaps can't prune (e.g. the
                    # FBWorkload prefix-random u64 trace scans EVERY
                    # segment per lookup) earn a SortedIndex — the
                    # access-counter adaptivity of the segment catalog,
                    # applied to point lookups
                    colo = table.columns[get.column_ids[p[0]]]
                    probes = getattr(colo, "_eq_probe_count", 0) + 1
                    colo._eq_probe_count = probes
                    if probes >= self.config.auto_index_threshold:
                        from adacom_tpu_torch.storage.index import SortedIndex

                        idxo = SortedIndex(
                            f"__auto_{table.name}_{colo.name}", table,
                            colo.name)
                        idxo.build()
                        table.indexes.append(idxo)
                        self.db.dist_stats["auto_index_built"] = \
                            self.db.dist_stats.get("auto_index_built", 0) + 1
                if idxo is not None:
                    index_hits = dict(idxo.lookup_eq(p[2]))
                    candidates = [i for i in candidates if i in index_hits]
        def scan_morsel(i):
            """One segment = one morsel (reference NextParallelScan hands
            out one row group per task, row_group_collection.cpp:112)."""
            segs = [snap.segment(c, i) for c in get.column_ids]
            cols = []
            for s in segs:
                hv = s.host_plain()
                hvv = s.host_validity()
                cols.append((hv, hvv))
            dm = snap.delete_mask(i)
            rows = None
            if index_hits is not None:
                rows = index_hits[i]
                v = cols[p[0]][1]
                if v is not None:  # NULL slots hold fill values: drop them
                    rows = rows[v[rows]]
                if dm is not None:
                    inb = rows < len(dm)
                    keep = np.ones(len(rows), dtype=bool)
                    keep[inb] = ~dm[rows[inb]]
                    rows = rows[keep]
            if rows is None and eq_probe is not None and dm is None:
                fcol, fval = eq_probe
                fvals, fvalid = cols[fcol]
                if fvalid is None and fvals.dtype == np.uint32 and 0 <= fval < (1 << 32):
                    from adacom_tpu_torch import native as _native

                    rows = _native.filter_eq_u32(fvals, fval)
            if rows is None and len(get.filters) >= 2 and dm is None:
                # multi-conjunct scans: adaptive runtime-ordered conjunct
                # evaluation (reference AdaptiveFilter, adaptive_filter.cpp)
                af = getattr(get, "_adaptive_filter", None)
                if af is None:
                    from adacom_tpu_torch.exec.adaptive_filter import AdaptiveFilter

                    af = get._adaptive_filter = AdaptiveFilter(get.filters)
                rows = af.select(cols, lits)
                if rows is None:
                    raise _FallbackToDevice()
            if rows is None:
                if filt is not None:
                    try:
                        fv, fm = filt.fn(cols, params)
                    except Exception:
                        raise _FallbackToDevice()
                    if not isinstance(fv, (np.ndarray, np.generic, bool)):
                        raise _FallbackToDevice()
                    mask = np.asarray(fv)
                    if mask.ndim == 0:
                        mask = np.full(segs[0].count, bool(mask))
                    if fm is not None:
                        mask = mask & fm
                else:
                    mask = np.ones(segs[0].count, dtype=bool)
                if dm is not None:
                    # the segment may have grown since rows were deleted
                    # (unseal-partial-and-append); pad the bitmap
                    dmx = np.zeros(len(mask), dtype=bool)
                    dmx[: min(len(dm), len(mask))] = dm[: len(mask)]
                    mask = mask & ~dmx
                rows = np.nonzero(mask)[0]
            return i, cols, rows

        from adacom_tpu_torch.parallel.scheduler import TaskScheduler

        return TaskScheduler.get().map_segments(
            scan_morsel, candidates, threads=self.config.threads)

    # ==================================================================
    # filter / project over materialized input
    # ==================================================================

    def _eval_on_mat(self, exprs: List[b.BExpr], mat: Mat, lits):
        """Evaluate expressions over a materialized batch, in numpy."""
        cols_np = [(c, v) for c, v in zip(mat.cols, mat.valids)]
        outs = []
        for e in exprs:
            cc = getattr(e, "_cc", None)
            if cc is None:
                cc = ExprCompiler().compile(e)
                e._cc = cc
            outs.append(cc.fn(cols_np, cc.prep_args(lits)))
        return outs

    def _exec_filter(self, node: b.LogicalFilter, lits) -> Mat:
        mat = self._exec(node.child, lits)
        if mat.nrows == 0:
            return mat
        (v, m), = self._eval_on_mat([node.condition], mat, lits)
        mask = np.asarray(v)
        if m is not None:
            mask = mask & np.asarray(m)
        if mask.ndim == 0:
            mask = np.full(mat.nrows, bool(mask))
        idx = np.nonzero(mask)[0]
        return mat.take(idx)

    def _exec_project(self, node: b.LogicalProject, lits) -> Mat:
        mat = self._exec(node.child, lits)
        return self._project_mat(node, mat, lits)

    def _project_mat(self, node: b.LogicalProject, mat: Mat, lits) -> Mat:
        outs = self._eval_on_mat(node.exprs, mat, lits)
        n = mat.nrows
        cols = []
        valids = []
        for (v, m), ty in zip(outs, node.types):
            a = np.asarray(v)
            if a.ndim == 0:
                a = np.full(n, a)
            cols.append(a)
            if m is None:
                valids.append(None)
            else:
                mm = np.asarray(m)
                if mm.ndim == 0:
                    mm = np.full(n, bool(mm))
                valids.append(mm if not mm.all() else None)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), list(dicts), cols, valids)

    def _exec_sample(self, node: b.LogicalSample, lits) -> Mat:
        """Deterministic-seed row sample (reservoir-sample parity; a
        fixed seed keeps repeated queries and verifier variants stable,
        and both packages sample the same rows)."""
        mat = self._exec(node.child, lits)
        n = mat.nrows
        rng = np.random.default_rng(0xADAC)
        if node.is_percent:
            k = int(round(n * node.amount / 100.0))
        else:
            k = min(node.amount, n)
        if k >= n:
            return mat
        idx = np.sort(rng.choice(n, size=k, replace=False))
        out = mat.take(idx)
        out.names = list(node.names)
        return out

    def _exec_values(self, node: b.LogicalValues, lits) -> Mat:
        if not node.names:
            # SELECT without FROM: one row, no columns (the JAX package
            # returns no row here)
            return Mat([], [], [], [], [], 1)
        # (VALUES ...) table ref: literal rows materialize as columns
        # (reference value_relation / expression lists)
        cols: List[np.ndarray] = []
        valids: List[Optional[np.ndarray]] = []
        dicts: List[Any] = []
        node_dicts = getattr(node, "dicts", [None] * len(node.names))
        for ci, ty in enumerate(node.types):
            vals = []
            for row in node.rows:
                ex = row[ci]
                if not isinstance(ex, b.BLiteral):
                    raise ExecError("VALUES cells must be literals")
                vals.append(lits[ex.param] if ex.param is not None
                            else ex.value)
            mask = np.asarray([v is not None for v in vals])
            if ty.is_string:
                # cells are dictionary CODES (binder encoded the strings)
                cols.append(np.asarray(
                    [0 if v is None else int(v) for v in vals],
                    dtype=np.uint32))
                dicts.append(node_dicts[ci])
            else:
                dt = compute_dtype_of(ty)
                scale = 10 ** ty.scale if ty.name == "DECIMAL" else 1
                cols.append(np.asarray([
                    0 if v is None else
                    (int(round(float(v) * scale)) if scale != 1 else v)
                    for v in vals]).astype(dt))
                dicts.append(None)
            valids.append(None if mask.all() else mask)
        return Mat(list(node.names), list(node.types), dicts, cols, valids)

    # ==================================================================
    # aggregation
    # ==================================================================

    def _exec_aggregate(self, node: b.LogicalAggregate, lits) -> Mat:
        child = node.child
        # fused scan-aggregate fast path
        if isinstance(child, b.LogicalGet):
            return self._aggregate_over_scan(node, child, lits)
        if isinstance(child, (b.LogicalJoin, b.LogicalProject)):
            mat = self._try_streaming_join_agg(node, child, lits)
            if mat is not None:
                return mat
        mat = self._exec(child, lits)
        return self._aggregate_host(node, mat, lits)

    def _agg_specs(self, node: b.LogicalAggregate):
        """Flatten BoundAggregates into primitive partial specs.

        Returns (specs, finishers): specs = [(kind, arg_expr|None, acc_dtype,
        distinct)], finishers map primitive partial values -> final
        aggregate values."""
        specs: List[Tuple[str, Optional[b.BExpr], Any, bool]] = []
        finishers = []
        for a in node.aggregates:
            if a.func == "count_star":
                si = len(specs)
                specs.append(("count", None, np.int64, False))
                finishers.append(lambda p, si=si: p[si])
            elif a.func == "count":
                si = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))
                finishers.append(lambda p, si=si: p[si])
            elif a.func == "sum":
                acc = np.float64 if a.ty.is_float else np.int64
                si = len(specs)
                specs.append(("sum", a.arg, acc, a.distinct))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))
                # grouped: groups with zero non-null args keep sum 0 (SQL
                # NULL-sum for all-null groups is a TODO with valid masks)
                finishers.append(
                    lambda p, si=si, ci=ci: p[si]
                    if isinstance(p[ci], np.ndarray) else (p[si] if p[ci] > 0 else None)
                )
            elif a.func == "avg":
                si = len(specs)
                specs.append(("sum", a.arg, np.float64, a.distinct))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))
                scale = 10.0 ** a.arg.ty.scale if a.arg.ty.name == "DECIMAL" else 1.0

                def fin(p, si=si, ci=ci, scale=scale):
                    cnt = p[ci]
                    if isinstance(cnt, np.ndarray):
                        safe = np.where(cnt > 0, cnt, 1)
                        return np.where(cnt > 0, (p[si] / scale) / safe, np.nan)
                    return (p[si] / scale) / cnt if cnt > 0 else None
                finishers.append(fin)
            elif a.func in ("min", "max"):
                dt = compute_dtype_of(a.arg.ty)
                acc = np.float64 if np.dtype(dt).kind == "f" else np.int64
                si = len(specs)
                specs.append((a.func, a.arg, acc, False))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))

                def fin(p, si=si, ci=ci):
                    cnt = p[ci]
                    if isinstance(cnt, np.ndarray):
                        return p[si]
                    return p[si] if cnt > 0 else None
                finishers.append(fin)
            elif a.func in ("stddev", "stddev_samp", "var_samp", "variance"):
                si = len(specs)
                specs.append(("sum", a.arg, np.float64, a.distinct))
                qi = len(specs)
                specs.append(("sumsq", a.arg, np.float64, a.distinct))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))
                is_std = a.func in ("stddev", "stddev_samp")

                def fin(p, si=si, qi=qi, ci=ci, is_std=is_std):
                    n = p[ci]
                    if isinstance(n, np.ndarray):
                        safe = np.where(n > 1, n, 2)
                        var = (p[qi] - p[si] * p[si] / np.where(n > 0, n, 1)) / (safe - 1)
                        var = np.where(n > 1, var, np.nan)
                        return np.sqrt(var) if is_std else var
                    if n <= 1:
                        return None
                    var = (p[qi] - p[si] * p[si] / n) / (n - 1)
                    return float(np.sqrt(var)) if is_std else float(var)
                finishers.append(fin)
            elif a.func == "first":
                si = len(specs)
                specs.append(("min", a.arg, np.int64, False))  # deterministic pick
                finishers.append(lambda p, si=si: p[si])
            elif a.func == "approx_count_distinct":
                si = len(specs)
                specs.append(("hll", a.arg, np.int64, False))
                finishers.append(lambda p, si=si: p[si])
            elif a.func.startswith("quantile_"):
                interp, qs = a.func.split(":")
                interp = interp.rsplit("_", 1)[1]  # cont | disc
                si = len(specs)
                specs.append((f"q:{interp}:{qs}", a.arg, np.float64, False))
                # cont quantile of a DECIMAL arg unscales to a double
                scale = 10.0 ** a.arg.ty.scale if (
                    interp == "cont" and a.arg.ty.name == "DECIMAL") else 1.0

                def fin(p, si=si, scale=scale):
                    v = p[si]
                    if isinstance(v, np.ndarray):
                        return v / scale if scale != 1.0 else v
                    if v is None or (isinstance(v, float) and np.isnan(v)):
                        return None
                    return v / scale if scale != 1.0 else v
                finishers.append(fin)
            elif a.func in ("bool_and", "bool_or"):
                kind = "min" if a.func == "bool_and" else "max"
                si = len(specs)
                specs.append((kind, a.arg, np.int64, False))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, False))

                def fin(p, si=si, ci=ci):
                    cnt = p[ci]
                    if isinstance(cnt, np.ndarray):
                        return (p[si] != 0).astype(np.uint32)
                    if cnt == 0:
                        return None
                    return 1 if p[si] != 0 else 0
                finishers.append(fin)
            else:
                raise ExecError(f"aggregate {a.func}")
        return specs, finishers

    def _group_domain(self, node: b.LogicalAggregate,
                      get: Optional[b.LogicalGet]):
        """Dense-domain info (mins, strides, sizes, domain) for the group
        keys, or None when some key has no small dense domain."""
        if get is not None:
            # seal staged appends first: zonemap stats only cover segments
            # (unflushed staging made the domain collapse to one group)
            get.table.flush()
        mins, sizes = [], []
        for g in node.groups:
            if isinstance(g, b.BColumn) and g.dictionary is not None:
                mins.append(0)
                sizes.append(max(1, len(g.dictionary)))
                continue
            if g.ty.integer and get is not None and isinstance(g, b.BColumn):
                col = get.table.columns[get.column_ids[g.index]]
                if not col.segments:
                    mins.append(0)
                    sizes.append(1)
                    continue
                lo = min(s.vmin for s in col.segments)
                hi = max(s.vmax for s in col.segments)
                mins.append(int(lo))
                sizes.append(int(hi - lo + 1))
                continue
            if g.ty is tt.BOOLEAN:
                mins.append(0)
                sizes.append(2)
                continue
            return None
        domain = 1
        for s in sizes:
            domain *= s
        if domain > (1 << 22):
            return None
        strides = []
        acc = 1
        for s in reversed(sizes):
            strides.append(acc)
            acc *= s
        strides.reverse()
        return mins, strides, sizes, domain

    def _aggregate_over_scan(self, node, get: b.LogicalGet, lits) -> Mat:
        """Route an aggregate over a scan as the JAX package does: the
        fused device tiers first (ungrouped: B1, then B3; grouped over a
        dense domain: B2, then B3); the host aggregate over a host scan for
        non-dense domains, DISTINCT and holistic aggregates; the generic
        device path for the rest. On a CUDA database without a mesh a dense
        domain wider than the fused tiers take runs on the host below
        device_agg_min_rows rows (the JAX package's TPU gate), and plans
        over UBIGINT run on the host (no exact device dtype)."""
        specs, finishers = self._agg_specs(node)
        grouped = bool(node.groups)
        dense = self._group_domain(node, get) if grouped else None
        holistic = any(k == "hll" or k.startswith("q:")
                       for k, *_x in specs)
        distinct = any(d for *_x, d in specs)
        if not holistic and not distinct:
            mat = None
            if not grouped:
                mat = self._try_pallas_scan_agg(node, get, lits, specs,
                                                finishers)
                if mat is None:
                    mat = self._try_pallas_multi_agg(node, get, lits, specs,
                                                     finishers, None)
            elif dense is not None:
                mat = self._try_pallas_grouped_agg(node, get, lits, specs,
                                                   finishers, dense)
                if mat is None:
                    mat = self._try_pallas_multi_agg(node, get, lits, specs,
                                                     finishers, dense)
            if mat is not None:
                return mat
        args = [arg for _k, arg, _a, _d in specs if arg is not None]
        if (grouped and dense is None) or distinct or holistic or \
                declines(get, [*node.groups, *args]) or (
                    grouped and self.db.device.type == "cuda" and
                    self.db.mesh is None and
                    dense[3] > grouped_scan.MAX_MULTI_GROUPS and
                    get.table.row_count() < self.config.device_agg_min_rows):
            mat = self._materialize_scan(get, lits)
            return self._aggregate_host(node, mat, lits)
        return self._aggregate_generic(node, get, lits, specs, finishers,
                                       dense)

    # ------------------------------------------------------------------
    # fused-scan fast path (ops/fused_scan.py): ungrouped sum/count/min/max
    # over a single packed u32/i32 column with an optional range
    # predicate — the compressed-scan hot loop (reference
    # SuccinctScanPartial + aggregate sink) as ONE kernel launch per
    # packed-width class over the whole table.
    # ------------------------------------------------------------------
    def _try_pallas_scan_agg(self, node, get: b.LogicalGet, lits,
                             specs, finishers) -> Optional[Mat]:
        if not getattr(self.config, "pallas_scan_enabled", False):
            return None
        if self.db.mesh is not None:
            return None  # mesh mode: the distributed pooled path scans
        if len(get.column_ids) != 1:
            return None
        ty = get.types[0]
        if not ty.integer or np.dtype(compute_dtype_of(ty)).itemsize != 4:
            return None
        for kind, arg, acc, distinct in specs:
            if distinct or kind not in ("count", "count_arg", "sum",
                                        "min", "max"):
                return None
            if arg is not None and not (
                isinstance(arg, b.BColumn) and arg.index == 0
            ):
                return None
        # fold all filter conjuncts into one inclusive integer range
        folded = _fold_ranges(get.filters, lits)
        if folded is None or set(folded[0]) - {0}:
            return None
        (lo, hi), empty = folded[0].get(0, (None, None)), folded[1]

        table = get.table
        snap = self._pin_snapshot(table)
        col_name = get.column_ids[0]
        # eligibility sweep BEFORE touching device state
        candidates = self._zonemap_candidates(get, lits, snap)
        segs = []
        for i in candidates:
            if snap.delete_mask(i) is not None:
                return None
            s = snap.segment(col_name, i)
            if not s.is_compacted() or s.codec not in (None, "succinct"):
                return None
            segs.append(s)
        any_null = any(s._validity_np is not None for s in segs)

        tot_sum, tot_cnt = 0, 0   # tot_cnt = valid [& predicate] rows
        raw_rows = 0              # all visible rows (count(*) w/o pred)
        gmin = gmax = None
        if not empty:
            classes: Dict[int, list] = {}
            for s in segs:
                meta, arrays = s.reader_arrays()
                if meta[0] != "packed" or len(meta[1][0]) != 1:
                    return None
                (w,), L, _dt = meta[1]
                mf = s._packed.min_factor
                raw_rows += s.count
                if w == 0:
                    # constant segment: answered on the host
                    n_valid = (s.count if s._validity_np is None
                               else int(s._validity_np.sum()))
                    if (lo is None or mf >= lo) and (hi is None or mf <= hi):
                        tot_cnt += n_valid
                        tot_sum += mf * n_valid
                        gmin = mf if gmin is None else min(gmin, mf)
                        gmax = mf if gmax is None else max(gmax, mf)
                else:
                    vplane = s.validity_arrays()
                    classes.setdefault(w, []).append(
                        (arrays[0], s.count, mf, L, s.serial, s.version,
                         None if vplane is None else vplane[0]))
            # stacked planes per width class, reused while no segment of
            # the class changes; keyed on monotonic segment serials, which
            # (unlike id()) are never reused
            cache = pool_cache(table)
            need_minmax = any(k in ("min", "max")
                              for k, _a, _acc, _d in specs)
            for w, entries in classes.items():
                L_pad = max(e[3] for e in entries)
                cls_valid = any(e[6] is not None for e in entries)
                key = ("scan", w, L_pad, cls_valid,
                       tuple((e[4], e[5]) for e in entries))
                stacked = cache.get(key)
                if stacked is None:
                    vstk = None
                    if cls_valid:
                        ones = torch.full((1, L_pad), -1, dtype=torch.int32,
                                          device=entries[0][0].device)
                        vstk = _stack_planes([ones if e[6] is None else e[6]
                                              for e in entries], L_pad)
                    stacked = (_stack_planes([e[0] for e in entries], L_pad),
                               vstk)
                    cache.put(key, stacked)
                wstk, vstk = stacked
                counts = np.asarray([e[1] for e in entries], np.int64)
                mins = np.asarray([e[2] for e in entries], np.int64)
                lanes = np.asarray([e[3] for e in entries], np.int64)
                s_, c_, mn_, mx_ = fused_scan.scan_table(
                    wstk, counts, mins, lo, hi, lanes=lanes,
                    minmax=need_minmax, valids=vstk)
                tot_sum += s_
                tot_cnt += c_
                if c_ > 0:
                    gmin = mn_ if gmin is None else min(gmin, mn_)
                    gmax = mx_ if gmax is None else max(gmax, mx_)

        has_pred = lo is not None or hi is not None
        prim = []
        for kind, arg, acc, _d in specs:
            if kind == "count":
                # count(*): every visible row unless a predicate filters
                prim.append(np.int64(tot_cnt if has_pred else raw_rows))
            elif kind == "count_arg":
                prim.append(np.int64(
                    tot_cnt if (has_pred or any_null) else raw_rows))
            elif kind == "sum":
                prim.append(np.asarray(tot_sum, dtype=acc)[()])
            elif kind == "min":
                prim.append(np.asarray(0 if gmin is None else gmin,
                                       dtype=acc)[()])
            else:  # max
                prim.append(np.asarray(0 if gmax is None else gmax,
                                       dtype=acc)[()])
        out_vals = [f(prim) for f in finishers]
        cols, valids = _agg_finalize_row(node, out_vals)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), dicts, cols, valids)

    # ------------------------------------------------------------------
    # grouped fused-scan tiers (ops/grouped_scan.py, kernels B2 and B3):
    # the reference's perfect-hash aggregate over a small dense group
    # domain (perfect_aggregate_hashtable.cpp) fused with the succinct
    # decode, one kernel launch per representation class
    # ------------------------------------------------------------------
    def _try_pallas_grouped_agg(self, node, get: b.LogicalGet, lits,
                                specs, finishers, dense) -> Optional[Mat]:
        """SELECT g, sum(v), count(*) GROUP BY g over one packed group
        column and one packed 4-byte integer value column, with a small
        integer domain and an optional value-range filter (kernel B2)."""
        if not getattr(self.config, "pallas_scan_enabled", False):
            return None
        if self.db.mesh is not None:
            return None  # mesh mode: the distributed pooled path scans
        if len(node.groups) != 1:
            return None
        g = node.groups[0]
        if not isinstance(g, b.BColumn):
            return None
        mins_d, _strides, _sizes, domain = dense
        if domain > grouped_scan.MAX_GROUPS or domain < 1:
            return None
        gi = g.index
        vi = None
        for kind, arg, acc, distinct in specs:
            if distinct or kind not in ("count", "count_arg", "sum"):
                return None
            if arg is not None:
                if not isinstance(arg, b.BColumn):
                    return None
                if vi is None:
                    vi = arg.index
                elif arg.index != vi:
                    return None
        if vi is None or vi == gi:
            return None
        ty_v = get.types[vi]
        if not ty_v.integer or np.dtype(compute_dtype_of(ty_v)).itemsize != 4:
            return None
        if not get.types[gi].integer:
            return None
        # filters fold into one value-column range
        folded = _fold_ranges(get.filters, lits)
        if folded is None or set(folded[0]) - {vi}:
            return None
        (lo, hi), empty = folded[0].get(vi, (None, None)), folded[1]

        table = get.table
        snap = self._pin_snapshot(table)
        g_name, v_name = get.column_ids[gi], get.column_ids[vi]
        candidates = self._zonemap_candidates(get, lits, snap)
        pairs = []
        for i in candidates:
            if snap.delete_mask(i) is not None:
                return None
            sg = snap.segment(g_name, i)
            sv = snap.segment(v_name, i)
            for s in (sg, sv):
                if s._validity_np is not None or not s.is_compacted() or \
                        s.codec not in (None, "succinct"):
                    return None
            pairs.append((sg, sv))

        sums = np.zeros(domain, np.int64)
        cnts = np.zeros(domain, np.int64)
        if not empty:
            classes: Dict[tuple, list] = {}
            for sg, sv in pairs:
                gmeta, garr = sg.reader_arrays()
                vmeta, varr = sv.reader_arrays()
                for meta in (gmeta, vmeta):
                    if meta[0] != "packed" or len(meta[1][0]) != 1:
                        return None
                (gw,), Lg, _ = gmeta[1]
                (vw,), Lv, _ = vmeta[1]
                if gw == 0 or vw == 0 or Lg != Lv:
                    return None
                classes.setdefault((gw, vw), []).append(
                    (garr[0], varr[0], sv.count, sg._packed.min_factor,
                     sv._packed.min_factor, Lg, sg.serial, sg.version,
                     sv.serial, sv.version))
            cache = pool_cache(table)
            for (gw, vw), entries in classes.items():
                L_pad = max(e[5] for e in entries)
                key = ("grouped", gw, vw, L_pad,
                       tuple(e[6:] for e in entries))
                stacked = cache.get(key)
                if stacked is None:
                    stacked = (_stack_planes([e[0] for e in entries], L_pad),
                               _stack_planes([e[1] for e in entries], L_pad))
                    cache.put(key, stacked)
                gstk, vstk = stacked
                counts = np.asarray([e[2] for e in entries], np.int64)
                # kernel group ids are DOMAIN slots: code + (gmin - base)
                gmins = np.asarray([e[3] - mins_d[0] for e in entries],
                                   np.int64)
                vmins = np.asarray([e[4] for e in entries], np.int64)
                lanes = np.asarray([e[5] for e in entries], np.int64)
                out = grouped_scan.grouped_scan_table(
                    gstk, vstk, counts, gmins, vmins, domain, lo, hi,
                    lanes=lanes)
                sums += out[:, 0]
                cnts += out[:, 1]

        self.db.dist_stats["pallas_grouped_agg"] = \
            self.db.dist_stats.get("pallas_grouped_agg", 0) + 1
        present = cnts > 0
        gidx = np.nonzero(present)[0]
        prim = []
        for kind, arg, acc, _d in specs:
            if kind in ("count", "count_arg"):
                prim.append(cnts[gidx])
            else:  # sum
                prim.append(sums[gidx].astype(acc))
        agg_cols = [f(prim) for f in finishers]
        cols: List[np.ndarray] = [
            (gidx + mins_d[0]).astype(compute_dtype_of(g.ty))]
        valids: List[Optional[np.ndarray]] = [None]
        for a, v in zip(node.aggregates, agg_cols):
            cols.append(np.asarray(v))
            valids.append(None)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), dicts, cols, valids)

    def _try_pallas_multi_agg(self, node, get: b.LogicalGet, lits,
                              specs, finishers, dense) -> Optional[Mat]:
        """Multi-plane multi-aggregate grouped scan (TPC-H Q1-class, kernel
        B3): N SUM/COUNT aggregates whose arguments are polynomials over
        DECIMAL/integer scan columns (sum(price*(1-disc)*(1+tax)) expands
        to signed combinations of monomial sums), grouped by a small dense
        domain over up to 6 key columns, with conjunctive per-column range
        filters, all fused with the succinct decode of every referenced
        plane in one kernel pass (reference: perfect_aggregate_hashtable
        .cpp + expression_executor.cpp, collapsed into the scan)."""
        if not getattr(self.config, "pallas_scan_enabled", False):
            return None
        if self.db.mesh is not None:
            return None  # mesh mode: the distributed pooled path scans
        grouped = bool(node.groups)
        if grouped:
            if dense is None:
                return None
            mins_d, strides, sizes, domain = dense
        else:
            mins_d, strides, sizes, domain = [], [], [], 1
        if not (1 <= domain <= grouped_scan.MAX_MULTI_GROUPS):
            return None
        for g in node.groups:
            if not isinstance(g, b.BColumn):
                return None
        gcols = [g.index for g in node.groups]

        # ---- decompose aggregate args into monomial plans ----
        mono_ids: Dict[tuple, int] = {}
        spec_plans = []
        vcheck_cols = set()  # columns whose validity must be absent
        for kind, arg, acc, distinct in specs:
            if distinct:
                return None
            if kind == "count":
                spec_plans.append(None)
                continue
            if kind == "count_arg":
                if arg is None:
                    return None
                pd = _poly_decompose(arg, lits)
                if pd is None:
                    return None
                for m in pd[0]:
                    vcheck_cols.update(m)
                spec_plans.append(None)
                continue
            if kind != "sum":
                return None
            pd = _poly_decompose(arg, lits)
            if pd is None:
                return None
            terms, scale = pd
            declared = arg.ty.scale if arg.ty.name == "DECIMAL" else 0
            if scale != declared:
                return None
            plan = []
            for mono, coef in terms.items():
                if coef == 0:
                    continue
                if len(mono) > grouped_scan.MAX_MONO_DEGREE:
                    return None
                mi = (None if len(mono) == 0
                      else mono_ids.setdefault(mono, len(mono_ids)))
                plan.append((int(coef), mi))
                vcheck_cols.update(mono)
            spec_plans.append(plan)
        monos = [m for m, _i in sorted(mono_ids.items(), key=lambda kv: kv[1])]

        # ---- fold filters into per-column integer ranges ----
        folded = _fold_ranges(get.filters, lits)
        if folded is None:
            return None
        ranges, empty_all = folded
        if len(ranges) > grouped_scan.MAX_MULTI_PLANES:
            return None

        mono_cols = sorted({c for m in monos for c in m})
        plane_cols = sorted(set(mono_cols) | set(ranges))
        if not plane_cols and not gcols:
            # nothing to unpack (bare count(*)): no word planes to derive
            # the lane count from; the host answers counts from metadata
            return None
        if len(plane_cols) > grouped_scan.MAX_MULTI_PLANES or \
                len(gcols) > grouped_scan.MAX_GROUP_PLANES:
            return None
        plane_pos = {c: p for p, c in enumerate(plane_cols)}
        kmonos = tuple(tuple(plane_pos[c] for c in m) for m in monos)
        kpreds = tuple(plane_pos[c] for c in sorted(ranges))
        vcheck_only = sorted(vcheck_cols - set(plane_cols) - set(gcols))

        # plane types must be exact integers (scaled DECIMAL / int / date
        # / dict codes); floats can't ride the integer kernel
        for c in plane_cols + gcols:
            ty = get.types[c]
            if ty.is_float or (ty.is_string and c not in gcols):
                return None

        # ---- per-segment eligibility sweep + class pooling ----
        snap = self._pin_snapshot(get.table)
        candidates = self._zonemap_candidates(get, lits, snap)
        classes: Dict[tuple, list] = {}
        plane_vmax = [0] * len(plane_cols)
        for i in candidates:
            if snap.delete_mask(i) is not None:
                return None
            entry_planes = []
            for c in gcols + plane_cols + vcheck_only:
                s = snap.segment(get.column_ids[c], i)
                if s._validity_np is not None:
                    return None
                if c in vcheck_only and c not in plane_cols:
                    continue
                if not s.is_compacted() or s.codec not in (None, "succinct"):
                    return None
                meta, arrs = s.reader_arrays()
                if meta[0] != "packed":
                    return None
                widths, L, _dt = meta[1]
                if len(widths) > 1 and widths[1] != 0:
                    return None  # true 64-bit span: host tier
                w = widths[0]
                mf = s._packed.min_factor
                word = arrs[0] if w > 0 else None
                entry_planes.append((c, w, L, int(mf), int(s.vmax), word,
                                     s.serial, s.version))
            key = tuple((c, w) for c, w, *_r in entry_planes)
            classes.setdefault(key, []).append(
                (i, snap.segment_rows(i), entry_planes))

        n_group_planes = len(gcols)
        for entries in classes.values():
            for _i, _cnt, planes in entries:
                for pj, (c, w, L, mf, vmax, _wd, _sid, _v) in \
                        enumerate(planes):
                    if pj < n_group_planes:
                        if mf - (mins_d[pj] if grouped else 0) < 0:
                            return None
                    else:
                        p = pj - n_group_planes
                        if c in mono_cols and (mf < 0 or vmax >= (1 << 31)):
                            return None
                        plane_vmax[p] = max(plane_vmax[p], vmax)
        # per-row monomial product must stay exact in u32
        for m in monos:
            prod = 1
            for c in m:
                prod *= max(1, plane_vmax[plane_pos[c]])
            if prod >= (1 << 32):
                return None

        kstrides = tuple(int(s) for s in strides) if grouped else ()
        launches = []
        if not empty_all:
            cache = pool_cache(get.table)
            for ckey, entries in classes.items():
                if not any(w > 0 for _c, w in ckey):
                    # all-constant planes: no words to size the lane grid
                    return None
                scal = np.zeros((len(entries), grouped_scan.SCAL_COLS),
                                np.uint32)
                seg_sig = []
                for ei, (i, cnt_i, planes) in enumerate(entries):
                    scal[ei, grouped_scan._SC_COUNT] = cnt_i
                    scal[ei, grouped_scan._SC_LORIG] = bitpack.lanes_for(cnt_i)
                    seg_empty = False
                    for pj, (c, w, L, mf, vmax, _wd, sid, sver) in \
                            enumerate(planes):
                        seg_sig.append((sid, sver))
                        if pj < n_group_planes:
                            scal[ei, grouped_scan._SC_GMIN + pj] = \
                                mf - (mins_d[pj] if grouped else 0)
                        else:
                            p = pj - n_group_planes
                            if c in mono_cols:
                                # gated to [0, 2^31) above
                                scal[ei, grouped_scan._SC_VMIN + p] = mf
                            rr = ranges.get(c)
                            if rr is not None:
                                q = kpreds.index(p)
                                lo_v = -(1 << 62) if rr[0] is None else rr[0]
                                hi_v = (1 << 62) if rr[1] is None else rr[1]
                                lo_c = min(max(lo_v - mf, 0), 0xFFFFFFFF)
                                hi_c = min(hi_v - mf, 0xFFFFFFFF)
                                if hi_c < lo_c:
                                    seg_empty = True
                                else:
                                    scal[ei, grouped_scan._SC_PRED + 2 * q] = lo_c
                                    scal[ei, grouped_scan._SC_PRED + 2 * q + 1] = \
                                        max(0, hi_c)
                    if seg_empty:
                        scal[ei, grouped_scan._SC_COUNT] = 0
                        scal[ei, grouped_scan._SC_PRED:] = 0
                stack_key = ("multi", ckey, tuple(seg_sig))
                stacked = cache.get(stack_key)
                if stacked is None:
                    L_pad = max([L for _i2, _c2, planes in entries
                                 for _c3, w, L, *_r3 in planes if w > 0])
                    gstacks, vstacks = [], []
                    for pj in range(len(entries[0][2])):
                        stackp = None
                        if entries[0][2][pj][1] > 0:
                            stackp = _stack_planes(
                                [e[2][pj][5] for e in entries], L_pad)
                        (gstacks if pj < n_group_planes
                         else vstacks).append(stackp)
                    stacked = (gstacks, vstacks)
                    cache.put(stack_key, stacked)
                launches.append((stacked[0], stacked[1], scal))
            # shape checks before any launch: a shape the kernel does not
            # take goes to the host tier; a failing launch raises
            try:
                for gstacks, vstacks, scal in launches:
                    grouped_scan.check_multi(gstacks, vstacks, scal, domain,
                                             kstrides, kmonos, kpreds)
            except ValueError:
                return None
        sums = np.zeros((domain, len(monos)), np.int64)
        cnts = np.zeros(domain, np.int64)
        for gstacks, vstacks, scal in launches:
            out = grouped_scan.multi_grouped_scan_table(
                gstacks, vstacks, scal, domain, kstrides, kmonos, kpreds)
            sums += out[:, :len(monos)]
            cnts += out[:, len(monos)]

        # ---- finish ----
        def spec_prim(plan, gsel):
            if plan is None:
                return cnts[gsel]
            acc = np.zeros_like(cnts[gsel])
            for coef, mi in plan:
                acc = acc + coef * (cnts[gsel] if mi is None
                                    else sums[gsel, mi])
            return acc

        self.db.dist_stats["pallas_multi_agg"] = \
            self.db.dist_stats.get("pallas_multi_agg", 0) + 1
        if not grouped:
            prim = []
            for plan in spec_plans:
                v = spec_prim(plan, slice(None))
                prim.append(int(v[0]))
            out_vals = [f(prim) for f in finishers]
            cols, valids = _agg_finalize_row(node, out_vals)
            dicts = getattr(node, "dicts", [None] * len(node.names))
            return Mat(list(node.names), list(node.types), dicts, cols,
                       valids)
        present = cnts > 0
        gidx = np.nonzero(present)[0]
        prim = [spec_prim(plan, gidx) for plan in spec_plans]
        agg_cols = [f(prim) for f in finishers]
        cols = []
        valids = []
        for gi, g in enumerate(node.groups):
            vals = (gidx // strides[gi]) % sizes[gi] + mins_d[gi]
            cols.append(vals.astype(compute_dtype_of(g.ty)))
            valids.append(None)
        for a, v in zip(node.aggregates, agg_cols):
            cols.append(np.asarray(v))
            valids.append(None)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), dicts, cols, valids)

    def _aggregate_host(self, node: b.LogicalAggregate, mat: Mat, lits) -> Mat:
        """Host hash aggregate over a materialized batch (large domains,
        non-scan children)."""
        specs, finishers = self._agg_specs(node)
        uniq, prim = self._agg_partials(node, mat, lits, specs)
        return self._finish_agg(node, specs, finishers, uniq, prim)

    def _agg_partials(self, node: b.LogicalAggregate, mat: Mat, lits,
                      specs):
        """Group keys + primitive partial arrays for one batch — the
        local (per-morsel) half of the reference's local->global sink
        merge (partitionable_hashtable.cpp). Returns (uniq_key_arrays,
        prim_arrays); ungrouped batches return ([], [len-1 arrays])."""
        n = mat.nrows
        # evaluate group exprs + agg args (deduped by identity, matching the
        # consumption order below)
        arg_exprs = []
        seen_ids = set()
        for _, a, _, _d in specs:
            if a is not None and id(a) not in seen_ids:
                seen_ids.add(id(a))
                arg_exprs.append(a)
        exprs = list(node.groups) + arg_exprs
        outs = self._eval_on_mat(exprs, mat, lits) if exprs else []
        gvals = []
        for k in range(len(node.groups)):
            v, m = outs[k]
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.full(n, arr)
            gvals.append((arr, None if m is None else np.asarray(m)))
        arg_map = {}
        k = len(node.groups)
        for kind, a, acc, _d in specs:
            if a is not None and id(a) not in arg_map:
                v, m = outs[k]
                arr = np.asarray(v)
                if arr.ndim == 0:
                    arr = np.full(n, arr)
                arg_map[id(a)] = (arr, None if m is None else np.asarray(m))
                k += 1

        if node.groups:
            key_arrays = [g[0] for g in gvals]
            uniq, gid = _unique_rows(key_arrays)
            n_groups = len(uniq[0]) if uniq else 0
        else:
            gid = np.zeros(n, dtype=np.int64)
            uniq = []
            n_groups = 1

        prim = []
        for kind, a, acc, distinct in specs:
            if kind == "count":
                prim.append(np.bincount(gid, minlength=n_groups).astype(np.int64))
                continue
            vals, valid = arg_map[id(a)] if a is not None else (None, None)
            if distinct and kind in ("count_arg", "sum", "sumsq"):
                # keep only the first occurrence of each (group, value) pair
                first = np.zeros(n, dtype=bool)
                first[_unique_row_indices([gid, vals])] = True
                valid = first if valid is None else (first & valid)
            if kind == "count_arg":
                w = np.ones(n) if valid is None else valid.astype(np.float64)
                prim.append(np.bincount(gid, weights=w, minlength=n_groups).astype(np.int64))
            elif kind in ("sum", "sumsq"):
                v = vals.astype(acc)
                if kind == "sumsq":
                    v = v * v
                if valid is not None:
                    v = np.where(valid, v, 0)
                if np.dtype(acc) in (np.dtype(np.int64), np.dtype(np.float64)):
                    from adacom_tpu_torch import native as _native

                    out = _native.group_sum(gid, v, n_groups).astype(acc)
                else:
                    out = np.zeros(n_groups, dtype=acc)
                    np.add.at(out, gid, v)
                prim.append(out)
            elif kind in ("min", "max"):
                v = vals.astype(acc)
                sent = (_max_sentinel(acc) if kind == "min"
                        else _min_sentinel(acc))
                if valid is not None:
                    v = np.where(valid, v, sent)
                out = np.full(n_groups, sent, dtype=acc)
                ufunc = np.minimum if kind == "min" else np.maximum
                ufunc.at(out, gid, v)
                prim.append(out)
            elif kind == "hll":
                prim.append(_hll_count(gid, vals, valid, n_groups))
            elif kind.startswith("q:"):
                _q, interp, qs = kind.split(":")
                prim.append(_group_quantile(gid, vals, valid, n_groups,
                                            float(qs), interp))
            else:
                raise ExecError(kind)
        return uniq, prim

    def _combine_partials(self, node, specs, keys_parts, prims_parts):
        """Merge per-morsel partials into one (uniq, prim) — the global
        half of the local->global sink merge. Mergeable kinds only
        (count/sum/sumsq/min/max); callers gate out distinct/holistic."""
        ng = len(node.groups)
        if ng == 0:
            prim = []
            for si, (kind, _a, acc, _d) in enumerate(specs):
                vals = np.asarray([pp[si][0] for pp in prims_parts])
                if kind == "min":
                    merged = vals.min()
                elif kind == "max":
                    merged = vals.max()
                else:
                    merged = vals.sum()
                prim.append(np.asarray([merged]))
            return [], prim
        keys = [np.concatenate([kp[g] for kp in keys_parts])
                for g in range(ng)]
        uniq, gid = _unique_rows(keys)
        n_groups = len(uniq[0]) if uniq else 0
        prim = []
        for si, (kind, _a, acc, _d) in enumerate(specs):
            v = np.concatenate([pp[si] for pp in prims_parts])
            if kind in ("min", "max"):
                sent = (_max_sentinel(v.dtype) if kind == "min"
                        else _min_sentinel(v.dtype))
                out = np.full(n_groups, sent, dtype=v.dtype)
                ufunc = np.minimum if kind == "min" else np.maximum
                ufunc.at(out, gid, v)
            elif v.dtype in (np.dtype(np.int64), np.dtype(np.float64)):
                from adacom_tpu_torch import native as _native

                out = _native.group_sum(gid, v, n_groups).astype(v.dtype)
            else:
                out = np.zeros(n_groups, dtype=v.dtype)
                np.add.at(out, gid, v)
            prim.append(out)
        return uniq, prim

    def _finish_agg(self, node, specs, finishers, uniq, prim) -> Mat:
        if not node.groups:
            scal = [p[0] if isinstance(p, np.ndarray) else p for p in prim]
            out_vals = [f(scal) for f in finishers]
            cols, valids = _agg_finalize_row(node, out_vals)
            dicts = getattr(node, "dicts", [None] * len(node.names))
            return Mat(list(node.names), list(node.types), dicts, cols, valids)

        agg_cols = [f(prim) for f in finishers]
        cols = list(uniq)
        valids: List[Optional[np.ndarray]] = [None] * len(node.groups)
        for a, v in zip(node.aggregates, agg_cols):
            arr = np.asarray(v)
            if a.func in ("min", "max", "first") and arr.dtype.kind in "iu":
                arr = arr.astype(compute_dtype_of(a.ty))
            elif a.func.startswith("quantile_disc") and \
                    np.dtype(compute_dtype_of(a.ty)).kind in "iu":
                arr = np.round(arr).astype(compute_dtype_of(a.ty))
            cols.append(arr)
            valids.append(None)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), dicts, cols, valids)

    # ==================================================================
    # order / limit
    # ==================================================================

    def _sort_indices(self, node_keys, mat: Mat, lits, limit=None) -> np.ndarray:
        keys = []
        for e, desc, nulls_first in reversed(node_keys):
            (v, m), = self._eval_on_mat([e], mat, lits)
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.full(mat.nrows, arr)
            d = self._expr_dict_of(e, mat)
            if d is not None:
                rank = d.rank_array()
                arr = rank[np.minimum(arr, len(rank) - 1)] if len(rank) else arr
            if desc:
                if arr.dtype.kind in "iu" and m is None:
                    arr = -arr.astype(np.int64)  # exact for integer keys
                else:
                    arr = -arr.astype(np.float64)
            # nulls: default NULLS LAST for ASC, NULLS FIRST for DESC (DuckDB)
            if m is not None:
                valid = np.asarray(m)
                nf = nulls_first if nulls_first is not None else desc
                arr = arr.astype(np.float64)
                arr = np.where(valid, arr, -np.inf if nf else np.inf)
            keys.append(arr)
        if not keys:
            return np.arange(mat.nrows)
        budget = getattr(self.config, "memory_limit", None)
        if budget and sum(k.nbytes for k in keys) * 3 > budget // 2 and \
                len(keys[0]) > (1 << 18):
            # out-of-core: external sample sort to a disk-backed
            # permutation (reference merge_sorter.cpp capability)
            from adacom_tpu_torch.exec import spill

            P = max(2, (sum(k.nbytes for k in keys) * 3)
                    // max(budget // 8, 1))
            return spill.external_sort_indices(keys, P)
        if len(keys) == 1 and len(keys[0]) >= 4096:
            u = _order_preserving_u64(keys[0])
            if u is not None:
                from adacom_tpu_torch import native as _native

                return _native.argsort_u64(u)  # LSD radix (RadixSort parity)
        idx = np.lexsort(keys)
        return idx

    def _expr_dict_of(self, e: b.BExpr, mat: Mat):
        if isinstance(e, b.BColumn) and e.index < len(mat.dicts):
            return mat.dicts[e.index] if (e.ty.is_string) else None
        return None

    def _exec_order(self, node: b.LogicalOrder, lits) -> Mat:
        mat = self._exec(node.child, lits)
        if mat.nrows <= 1:
            return mat
        idx = self._sort_indices(node.keys, mat, lits)
        if isinstance(idx, np.memmap):
            # spilled sort: chunk-gather rows into disk-backed columns
            from adacom_tpu_torch.exec import spill

            return Mat(
                list(mat.names), list(mat.types), list(mat.dicts),
                [spill.gather(c, idx) for c in mat.cols],
                [None if v is None else spill.gather(v, idx)
                 for v in mat.valids],
            )
        return mat.take(idx)

    def _exec_topn(self, node: b.LogicalTopN, lits) -> Mat:
        mat = self._exec(node.child, lits)
        idx = self._sort_indices(node.keys, mat, lits)
        idx = idx[node.offset : node.offset + node.limit]
        return mat.take(idx)

    def _exec_limit(self, node: b.LogicalLimit, lits) -> Mat:
        mat = self._exec(node.child, lits)
        off = 0
        if node.offset is not None:
            off = int(_const_value(node.offset, lits))
        lim = mat.nrows
        if node.limit is not None:
            lim = int(_const_value(node.limit, lits))
        return mat.take(np.arange(off, min(off + lim, mat.nrows)))

    # ==================================================================
    # distinct / set operations
    # ==================================================================

    def _exec_distinct(self, node: b.LogicalDistinct, lits) -> Mat:
        mat = self._exec(node.child, lits)
        if mat.nrows == 0:
            return mat
        uniq_idx = _unique_row_indices(_row_identity(mat.cols, mat.valids))
        return mat.take(np.sort(uniq_idx))

    def _exec_setop(self, node: b.LogicalSetOp, lits) -> Mat:
        """UNION / EXCEPT / INTERSECT [ALL]. Rows compare as SQL's set
        operations compare them: a NULL equals a NULL and no value (the
        JAX package compares the values stored under NULLs)."""
        left = self._exec(node.left, lits)
        right = self._exec(node.right, lits)
        # harmonize dictionaries: right columns re-encoded into left dicts
        rdicts = getattr(node.right, "dicts", [None] * len(right.cols))
        rcols = []
        for c, (lc, rc) in enumerate(zip(left.cols, right.cols)):
            ld = left.dicts[c] if c < len(left.dicts) else None
            if ld is not None and rdicts[c] is not None and \
                    ld is not rdicts[c]:
                rc = ld.encode(rdicts[c].decode(rc))
            rcols.append(np.asarray(rc).astype(lc.dtype, copy=False))
        if node.op == "union":
            cols = [np.concatenate([lc, rc])
                    for lc, rc in zip(left.cols, rcols)]
            valids = [
                None if lv is None and rv is None else np.concatenate([
                    lv if lv is not None else np.ones(left.nrows, bool),
                    rv if rv is not None else np.ones(right.nrows, bool),
                ])
                for lv, rv in zip(left.valids, right.valids)
            ]
            mat = Mat(list(node.names), list(node.types),
                      getattr(node, "dicts", [None] * len(node.names)),
                      cols, valids)
            if not node.all:
                mat = mat.take(np.sort(_unique_row_indices(
                    _row_identity(mat.cols, mat.valids))))
            return mat
        # except / intersect via verified equi-join membership over the
        # rows' identity columns (a validity column wherever either side
        # has one)
        both = [lv is not None or rv is not None
                for lv, rv in zip(left.valids, right.valids)]
        li, _ri = _hash_join_pairs(
            _row_identity(left.cols, left.valids, both),
            _row_identity(rcols, right.valids, both), self.config,
            db=self.db)
        in_right = np.zeros(left.nrows, dtype=bool)
        in_right[li] = True
        keep = ~in_right if node.op == "except" else in_right
        mat = left.take(np.nonzero(keep)[0])
        if not node.all and mat.nrows:
            mat = mat.take(np.sort(_unique_row_indices(
                _row_identity(mat.cols, mat.valids))))
        mat.names = list(node.names)
        return mat

    # ==================================================================
    # window functions
    # ==================================================================

    def _exec_window(self, node: b.LogicalWindow, lits) -> Mat:
        """Reference: PhysicalWindow (physical_window.cpp) — here one sort
        per window (partition-major) + vectorized segmented computation
        (exec/window.py)."""
        mat = self._exec(node.child, lits)
        n = mat.nrows
        cols = list(mat.cols)
        valids = list(mat.valids)
        for w in node.windows:
            if n == 0:
                cols.append(np.empty(0, compute_dtype_of(w.ty)))
                valids.append(None)
                continue
            col, valid = self._compute_window(w, mat, lits)
            cols.append(col)
            valids.append(valid)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), list(dicts), cols,
                   valids, n)

    def _compute_window(self, w: b.BoundWindow, mat: Mat, lits):
        from adacom_tpu_torch.exec import window as W

        n = mat.nrows
        # ---- partition ids
        if w.partitions:
            pouts = self._eval_on_mat(w.partitions, mat, lits)
            key_cols = []
            for v, m in pouts:
                a = np.asarray(v)
                if a.ndim == 0:
                    a = np.full(n, a)
                if m is not None:
                    mm = np.asarray(m)
                    if mm.ndim == 0:
                        mm = np.full(n, bool(mm))
                    key_cols.append(np.where(mm, a, np.zeros((), a.dtype)))
                    key_cols.append(mm.astype(np.uint8))
                else:
                    key_cols.append(a)
            part_id = np.unique(_row_keys(key_cols), return_inverse=True)[1]
        else:
            part_id = np.zeros(n, np.int64)

        # ---- order keys (comparable-transformed, priority order)
        okeys = []
        for e, desc, nulls_first in w.order_keys:
            (v, m), = self._eval_on_mat([e], mat, lits)
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.full(n, arr)
            d = self._expr_dict_of(e, mat)
            if d is not None:
                rank = d.rank_array()
                arr = rank[np.minimum(arr, len(rank) - 1)] if len(rank) else arr
            if desc:
                if arr.dtype.kind in "iu" and m is None:
                    arr = -arr.astype(np.int64)
                else:
                    arr = -arr.astype(np.float64)
            if m is not None:
                valid = np.asarray(m)
                nf = nulls_first if nulls_first is not None else desc
                arr = arr.astype(np.float64)
                arr = np.where(valid, arr, -np.inf if nf else np.inf)
            okeys.append(arr)

        sidx = np.lexsort(tuple(reversed(okeys)) + (part_id,))
        p = part_id[sidx]
        pos = np.arange(n, dtype=np.int64)
        starts = W.seg_starts_of(p)
        pstart, pend = W.expand_starts(starts, n)

        if okeys:
            new_peer = np.r_[True, p[1:] != p[:-1]]
            for k in okeys:
                ks = k[sidx]
                new_peer[1:] |= ks[1:] != ks[:-1]
            ps = np.flatnonzero(new_peer)
            peer_start, peer_end = W.expand_starts(ps.astype(np.int64), n)
            has_order = True
        else:
            peer_start, peer_end = pstart, pend
            has_order = False

        # ---- value / constant arguments
        const_args: list = []
        value_args: list = []
        if w.func == "ntile":
            const_args = [int(_const_value(w.args[0], lits))]
        elif w.func in ("lag", "lead"):
            value_args = [w.args[0]]
            off = int(_const_value(w.args[1], lits)) if len(w.args) > 1 else 1
            default = _const_value(w.args[2], lits) if len(w.args) > 2 else None
            const_args = [off, default]
        elif w.func == "nth_value":
            value_args = [w.args[0]]
            const_args = [int(_const_value(w.args[1], lits))]
        elif w.args:
            value_args = [w.args[0]]

        args_sorted = []
        for e in value_args:
            (v, m), = self._eval_on_mat([e], mat, lits)
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.full(n, arr)
            mm = None
            if m is not None:
                mm = np.asarray(m)
                if mm.ndim == 0:
                    mm = np.full(n, bool(mm))
                mm = mm[sidx]
            args_sorted.append((arr[sidx], mm))

        out_s, valid_s = W.compute_sorted(
            w.func, args_sorted, w.frame, has_order,
            pos, pstart, pend, peer_start, peer_end,
            is_decimal_sum=(w.ty.name == "DECIMAL"), const_args=const_args,
        )
        # decimal average: the scaled-integer sum divides out the scale
        if w.func == "avg" and w.args and w.args[0].ty.name == "DECIMAL":
            out_s = out_s / (10.0 ** w.args[0].ty.scale)

        out_s = np.asarray(out_s)
        want = compute_dtype_of(w.ty)
        if out_s.dtype != want and w.ty.name != "VARCHAR":
            out_s = out_s.astype(want)
        out = np.empty(n, out_s.dtype)
        out[sidx] = out_s
        valid = None
        if valid_s is not None:
            valid = np.empty(n, bool)
            valid[sidx] = valid_s
            if valid.all():
                valid = None
        return out, valid



def _max_sentinel(dt):
    dt = np.dtype(dt)
    return np.finfo(dt).max if dt.kind == "f" else np.iinfo(dt).max


def _min_sentinel(dt):
    dt = np.dtype(dt)
    return np.finfo(dt).min if dt.kind == "f" else np.iinfo(dt).min


def _stack_planes(planes, L_pad: int) -> torch.Tensor:
    """Stack same-width (width, lanes) int32 word planes, zero-padded on the
    lane axis to L_pad, into one (n, width, L_pad) tensor."""
    return torch.stack([
        p if p.shape[1] == L_pad
        else torch.nn.functional.pad(p, (0, L_pad - p.shape[1]))
        for p in planes])


def _fold_ranges(filters, lits):
    """Fold (column op literal) conjuncts into one inclusive integer range
    per column -> ({col_index: (lo, hi)}, empty), None for an open side;
    None when some conjunct is not such a comparison. `empty` is True when
    some column's range admits no integer."""
    ranges: Dict[int, list] = {}
    empty = False
    for f in filters:
        p = _zonemap_probe(f, lits)
        if p is None:
            return None
        ci, op, val = p
        r = ranges.setdefault(ci, [None, None])
        if op == "=":
            iv = int(np.floor(val))
            if np.longdouble(iv) != val:
                empty = True
            else:
                r[0] = iv if r[0] is None else max(r[0], iv)
                r[1] = iv if r[1] is None else min(r[1], iv)
        elif op == "<":
            b_ = int(np.ceil(val)) - 1
            r[1] = b_ if r[1] is None else min(r[1], b_)
        elif op == "<=":
            b_ = int(np.floor(val))
            r[1] = b_ if r[1] is None else min(r[1], b_)
        elif op == ">":
            b_ = int(np.floor(val)) + 1
            r[0] = b_ if r[0] is None else max(r[0], b_)
        elif op == ">=":
            b_ = int(np.ceil(val))
            r[0] = b_ if r[0] is None else max(r[0], b_)
    for r in ranges.values():
        if r[0] is not None and r[1] is not None and r[0] > r[1]:
            empty = True
    return {c: (r[0], r[1]) for c, r in ranges.items()}, empty


def _agg_finalize_row(node, out_vals):
    cols = []
    valids = []
    for a, v in zip(node.aggregates, out_vals):
        if v is None:
            cols.append(np.zeros(1, compute_dtype_of(a.ty)))
            valids.append(np.zeros(1, bool))
        else:
            cols.append(np.asarray([v]))
            valids.append(None)
    return cols, valids


def _poly_decompose(e: b.BExpr, lits):
    """Expand an integer/DECIMAL scalar expression over scan columns into
    polynomial terms in the SCALED-integer domain.

    Mirrors the engine's decimal arithmetic exactly (exec/expr.py binary
    eval + the binder's typing): '+'/'-' rescale both sides to the max
    scale, '*' multiplies scaled values (scales add). Returns
    (terms, scale) where terms maps a sorted tuple of scan-column indices
    (the monomial; () is the constant term) to an integer coefficient —
    so sum(price * (1 - disc) * (1 + tax)) decomposes to
    1e4*S(price) - 1e2*S(price*disc) + 1e2*S(price*tax) - S(price*disc*tax)
    — or None when the expression doesn't fit (floats, division,
    functions, strings)."""
    if isinstance(e, b.BColumn):
        ty = e.ty
        if ty.is_float or ty.is_string or not (
                ty.integer or ty.name == "DECIMAL"):
            return None
        return {(e.index,): 1}, (ty.scale if ty.name == "DECIMAL" else 0)
    if isinstance(e, b.BLiteral):
        v = lits[e.param] if e.param is not None else e.value
        if v is None or isinstance(v, str):
            return None
        if isinstance(v, float):
            if not float(v).is_integer():
                return None
            v = int(v)
        if e.ty.name == "DECIMAL":
            return {(): int(v)}, e.ty.scale
        if not e.ty.integer:
            return None
        return {(): int(v)}, 0
    if isinstance(e, b.BBinary) and e.op in ("+", "-", "*"):
        lp = _poly_decompose(e.left, lits)
        rp = _poly_decompose(e.right, lits)
        if lp is None or rp is None:
            return None
        lt, ls = lp
        rt, rs = rp
        if e.op in ("+", "-"):
            s = max(ls, rs)
            out: Dict[tuple, int] = {}
            for m, c in lt.items():
                out[m] = out.get(m, 0) + c * 10 ** (s - ls)
            sgn = 1 if e.op == "+" else -1
            for m, c in rt.items():
                out[m] = out.get(m, 0) + sgn * c * 10 ** (s - rs)
            return out, s
        out = {}
        for m1, c1 in lt.items():
            for m2, c2 in rt.items():
                m = tuple(sorted(m1 + m2))
                out[m] = out.get(m, 0) + c1 * c2
        return out, ls + rs
    return None


def _zonemap_probe(f: b.BExpr, lits):
    """Recognize (col op literal) for zonemap skipping; returns
    (col_index, op, value) or None."""
    if not isinstance(f, b.BBinary) or f.op not in ("=", "<", "<=", ">", ">="):
        return None
    l, r = f.left, f.right
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    if isinstance(l, b.BLiteral) and isinstance(r, b.BColumn):
        l, r = r, l
        op = flip[f.op]
    elif isinstance(l, b.BColumn) and isinstance(r, b.BLiteral):
        op = f.op
    else:
        return None
    lit = r
    val = lits[lit.param] if lit.param is not None else lit.value
    if isinstance(val, str):
        if lit.ty is tt.DATE:
            from adacom_tpu_torch.sql.binder import days_from_iso

            val = days_from_iso(val)
        else:
            return None
    if val is None:
        return None
    if l.ty.name == "DECIMAL" and isinstance(val, (int, float)) and lit.ty.name != "DECIMAL":
        val = val * (10 ** l.ty.scale)
    return l.index, op, np.longdouble(val)


def _hll_count(gid, vals, valid, n_groups, m: int = 64) -> np.ndarray:
    """Per-group HyperLogLog distinct estimate (reference approx_count via
    third_party/hyperloglog), 64 registers, small-range correction."""
    v = np.asarray(vals)
    if v.dtype.kind == "f":
        v = v.view(np.uint64 if v.dtype.itemsize == 8 else np.uint32)
    h = v.astype(np.uint64)
    # splitmix64 finalizer
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    h = h ^ (h >> np.uint64(31))
    reg = (h >> np.uint64(58)).astype(np.int64)  # top 6 bits
    w = (h << np.uint64(6)) | np.uint64(1)
    # rho = leading zeros of the remaining bits + 1
    lz = np.uint64(63) - np.floor(np.log2(w.astype(np.float64))).astype(np.uint64)
    rho = (lz + np.uint64(1)).astype(np.int64)
    if valid is not None:
        keep = np.asarray(valid)
        gid_k, reg_k, rho_k = gid[keep], reg[keep], rho[keep]
    else:
        gid_k, reg_k, rho_k = gid, reg, rho
    regs = np.zeros(n_groups * m, dtype=np.int64)
    np.maximum.at(regs, gid_k * m + reg_k, rho_k)
    regs = regs.reshape(n_groups, m)
    alpha = 0.709  # alpha_64
    est = alpha * m * m / np.sum(np.power(2.0, -regs.astype(np.float64)),
                                 axis=1)
    zeros = (regs == 0).sum(axis=1)
    small = est <= 2.5 * m
    with np.errstate(divide="ignore"):
        lin = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0))
    est = np.where(small & (zeros > 0), lin, est)
    return np.round(est).astype(np.int64)


def _group_quantile(gid, vals, valid, n_groups, q: float, interp: str
                    ) -> np.ndarray:
    """Exact per-group quantile by sorted selection (the reference's
    tdigest approximation replaced with an exact vectorized selection;
    quantile.cpp capability)."""
    v = np.asarray(vals).astype(np.float64)
    g = np.asarray(gid)
    if valid is not None:
        keep = np.asarray(valid)
        v, g = v[keep], g[keep]
    order = np.lexsort((v, g))
    gs, vs = g[order], v[order]
    grange = np.arange(n_groups)
    starts = np.searchsorted(gs, grange, side="left")
    ends = np.searchsorted(gs, grange, side="right")
    cnt = ends - starts
    safe_cnt = np.maximum(cnt, 1)
    if interp == "disc":
        idx = starts + np.maximum(np.ceil(q * safe_cnt).astype(np.int64) - 1, 0)
        idx = np.minimum(idx, np.maximum(ends - 1, 0))
        out = vs[np.minimum(idx, len(vs) - 1)] if len(vs) else np.zeros(n_groups)
    else:
        pos = starts + q * (safe_cnt - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(np.ceil(pos).astype(np.int64),
                        np.maximum(ends - 1, 0))
        lo = np.minimum(lo, np.maximum(ends - 1, 0))
        if len(vs):
            frac = pos - lo
            out = vs[np.minimum(lo, len(vs) - 1)] * (1 - frac) + \
                vs[np.minimum(hi, len(vs) - 1)] * frac
        else:
            out = np.zeros(n_groups)
    return np.where(cnt > 0, out, np.nan)


def _order_preserving_u64(arr: np.ndarray) -> Optional[np.ndarray]:
    """Map a sort key to u64 preserving order (reference key normalization
    to byte-comparable rows, src/common/sort/sort_state.cpp)."""
    if arr.dtype.kind == "i":
        return arr.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)
    if arr.dtype.kind == "u":
        return arr.astype(np.uint64)
    if arr.dtype == np.float64:
        bits = arr.view(np.uint64)
        neg = (bits >> np.uint64(63)).astype(bool)
        return np.where(neg, ~bits, bits ^ np.uint64(1 << 63))
    return None


def _unique_rows(key_arrays: List[np.ndarray]):
    """Group-by factorization: returns (unique col arrays, group ids).

    Uses the native open-addressing hash table (GroupedAggregateHashTable
    parity, O(n)) over 64-bit row hashes, then VERIFIES key equality
    against each group's representative row — a colliding row falls back
    to an exact sort-based factorization (the reference compares group
    rows, aggregate_hashtable.cpp FindOrCreateGroups)."""
    from adacom_tpu_torch import native as _native

    if len(key_arrays) == 1 and key_arrays[0].dtype.kind in "iu" and \
            key_arrays[0].dtype != np.uint64:
        # single integer key: the value IS the group key — no hashing,
        # no collision verification (Q18's 1.5M-group l_orderkey agg
        # spent half its time in the hash mix)
        h = np.ascontiguousarray(key_arrays[0], dtype=np.int64)
        gid, first_idx = _native.groupby_i64(h)
        return [key_arrays[0][first_idx]], gid
    h = _row_keys(key_arrays)
    if h.dtype != np.int64:
        h = h.view(np.int64) if h.dtype.itemsize == 8 else h.astype(np.int64)
    gid, first_idx = _native.groupby_i64(h)
    rep = first_idx[gid]
    for c in key_arrays:
        cc = np.ascontiguousarray(c)
        same = cc == cc[rep]
        if cc.dtype.kind == "f":  # NaN keys: NaN groups with NaN
            same |= np.isnan(cc) & np.isnan(cc[rep])
        if not same.all():
            return _unique_rows_exact(key_arrays)
    uniq_cols = [c[first_idx] for c in key_arrays]
    return uniq_cols, gid


def _unique_rows_exact(key_arrays: List[np.ndarray]):
    """Exact factorization by lexsort over the actual key columns."""
    n = len(key_arrays[0])
    order = np.lexsort(tuple(reversed(key_arrays)))
    new = np.zeros(n, dtype=bool)
    new[0] = True
    for c in key_arrays:
        cs = np.ascontiguousarray(c)[order]
        diff = cs[1:] != cs[:-1]
        if cs.dtype.kind == "f":
            diff &= ~(np.isnan(cs[1:]) & np.isnan(cs[:-1]))
        new[1:] |= diff
    grp_sorted = np.cumsum(new) - 1
    gid = np.empty(n, dtype=np.int64)
    gid[order] = grp_sorted
    first_idx = np.empty(int(grp_sorted[-1]) + 1, dtype=np.int64)
    # first occurrence in original order for deterministic output
    first_idx[gid[::-1]] = np.arange(n - 1, -1, -1)
    uniq_cols = [c[first_idx] for c in key_arrays]
    return uniq_cols, gid


def _row_identity(cols, valids, with_valid=None) -> List[np.ndarray]:
    """Columns under which two rows are the same row for DISTINCT and the
    set operations: a NULL equals a NULL and no value. A column with a
    validity mask (or with_valid[c] set) adds its mask, and its value slots
    under NULLs read 0."""
    out = []
    for c, (col, v) in enumerate(zip(cols, valids)):
        if v is None and not (with_valid and with_valid[c]):
            out.append(col)
            continue
        if v is None:
            v = np.ones(len(col), bool)
        out.append(np.where(v, col, np.zeros((), col.dtype)))
        out.append(v.astype(np.uint8))
    return out


def _unique_row_indices(cols: List[np.ndarray]) -> np.ndarray:
    """Indices of the first occurrence of each distinct row (verified)."""
    if not cols:
        return np.zeros(1, dtype=np.int64)
    _, gid = _unique_rows([np.ascontiguousarray(c) for c in cols])
    n_groups = int(gid.max()) + 1 if len(gid) else 0
    first = np.full(n_groups, len(gid), dtype=np.int64)
    np.minimum.at(first, gid, np.arange(len(gid)))
    return first


def _const_value(e: b.BExpr, lits):
    if isinstance(e, b.BLiteral):
        return lits[e.param] if e.param is not None else e.value
    raise ExecError("expected constant")
