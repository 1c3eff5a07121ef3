"""Query executor, first slice of the port: the compressed scan -> aggregate
path.

Port of adacom_tpu/exec/executor.py (reference physical planner + pipeline
executor, src/execution/physical_plan_generator.cpp). This slice carries:

- scans over a pinned table snapshot with vectorized zonemap pruning
  (CheckZonemapSegments, row_group.cpp:287), answered on the host tier
  (numpy plus the native C++ filters over the segments' host copies):
  point lookups and every materialization;
- filter, project, order, top-N and limit over materialized batches;
- aggregates: an ungrouped sum/count/min/max over one packed 4-byte
  integer column runs the fused table-scan kernel (ops/fused_scan.py) over
  the device-resident packed segments; every other aggregate takes the
  host hash aggregate over a host scan until the JAX package's grouped
  Pallas tiers and generic device tier are ported (ROADMAP queue A).

Plan nodes outside the slice raise ExecError("not yet ported: ...").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.ops import fused_scan
from adacom_tpu_torch.sql import bound as b
from adacom_tpu_torch.exec.expr import ExprCompiler, CompiledExpr, compute_dtype_of


# ======================================================================
# materialized batches
# ======================================================================


@dataclasses.dataclass
class Mat:
    names: List[str]
    types: List[tt.LogicalType]
    dicts: List[Any]
    cols: List[np.ndarray]
    valids: List[Optional[np.ndarray]]

    @property
    def nrows(self) -> int:
        return len(self.cols[0]) if self.cols else self._nrows

    _nrows: int = 0

    def take(self, idx: np.ndarray) -> "Mat":
        return Mat(
            self.names, self.types, self.dicts,
            [c[idx] for c in self.cols],
            [None if v is None else v[idx] for v in self.valids],
        )


# ======================================================================
# executor
# ======================================================================


class ExecError(Exception):
    pass


class Executor:
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
        if isinstance(node, b.LogicalFilter):
            return self._exec_filter(node, lits)
        if isinstance(node, b.LogicalProject):
            return self._exec_project(node, lits)
        if isinstance(node, b.LogicalAggregate):
            return self._exec_aggregate(node, lits)
        if isinstance(node, b.LogicalOrder):
            return self._exec_order(node, lits)
        if isinstance(node, b.LogicalTopN):
            return self._exec_topn(node, lits)
        if isinstance(node, b.LogicalLimit):
            return self._exec_limit(node, lits)
        raise ExecError(f"not yet ported: {type(node).__name__} "
                        "(ROADMAP queue A)")

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
        """Every materializing scan reads the segments' host copies in this
        slice: selective lookups and materializations alike (the output is
        host-resident either way)."""
        snap = self._pin_snapshot(get.table)
        candidates = self._zonemap_candidates(get, lits, snap)
        return self._materialize_scan_host(get, lits, candidates, snap)

    def _materialize_scan_host(self, get: b.LogicalGet, lits, candidates,
                               snap) -> Mat:
        """NumPy evaluation over segment host copies (one segment per
        morsel, in parallel on the task scheduler)."""
        table = get.table
        filt = self._compiled_filter(get)
        params = filt.prep_args(lits) if filt is not None else ()
        ncols = len(get.column_ids)
        per_col: List[List[np.ndarray]] = [[] for _ in range(ncols)]
        per_valid: List[List[Optional[np.ndarray]]] = [[] for _ in range(ncols)]
        any_valid = [False] * ncols
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
                    raise ExecError("not yet ported: a filter conjunct "
                                    "that leaves numpy")
            if rows is None:
                if filt is not None:
                    fv, fm = filt.fn(cols, params)
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
            return cols, rows

        from adacom_tpu_torch.parallel.scheduler import TaskScheduler

        results = TaskScheduler.get().map_segments(
            scan_morsel, candidates, threads=self.config.threads)
        for cols, rows in results:
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

    # ==================================================================
    # aggregation
    # ==================================================================

    def _exec_aggregate(self, node: b.LogicalAggregate, lits) -> Mat:
        child = node.child
        # fused scan-aggregate fast path
        if isinstance(child, b.LogicalGet):
            return self._aggregate_over_scan(node, child, lits)
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

    def _aggregate_over_scan(self, node, get: b.LogicalGet, lits) -> Mat:
        """Ungrouped sum/count/min/max over one packed 4-byte integer column
        runs the fused table scan; every other aggregate (grouped,
        DISTINCT, holistic, other columns) takes the host aggregate over a
        host scan until the grouped and generic device tiers are ported."""
        specs, finishers = self._agg_specs(node)
        if not node.groups:
            mat = self._try_pallas_scan_agg(node, get, lits, specs, finishers)
            if mat is not None:
                return mat
        mat = self._materialize_scan(get, lits)
        return self._aggregate_host(node, mat, lits)

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
            cache = getattr(table, "_pool_cache", None)
            if cache is None:
                cache = table._pool_cache = {}
            need_minmax = any(k in ("min", "max")
                              for k, _a, _acc, _d in specs)
            for w, entries in classes.items():
                L_pad = max(e[3] for e in entries)
                cls_valid = any(e[6] is not None for e in entries)
                key = ("scan", w, L_pad, cls_valid,
                       tuple((e[4], e[5]) for e in entries))
                stacked = cache.get(key)
                if stacked is None:
                    stacked = _stack_planes(entries, L_pad, cls_valid)
                    if len(cache) > 8:
                        cache.clear()
                    cache[key] = stacked
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



def _max_sentinel(dt):
    dt = np.dtype(dt)
    return np.finfo(dt).max if dt.kind == "f" else np.iinfo(dt).max


def _min_sentinel(dt):
    dt = np.dtype(dt)
    return np.finfo(dt).min if dt.kind == "f" else np.iinfo(dt).min


def _stack_planes(entries, L_pad: int, with_valid: bool):
    """Stack same-width packed planes (zero-padded to L_pad lanes) into one
    (n_seg, width, L_pad) tensor and, when any segment has NULLs, their
    validity planes into (n_seg, 1, L_pad) (all-ones where a segment has
    none). entries: (words, count, min, lanes, serial, version, valid)."""
    def padw(words):
        if words.shape[1] == L_pad:
            return words
        return torch.nn.functional.pad(words, (0, L_pad - words.shape[1]))

    wstk = torch.stack([padw(e[0]) for e in entries])
    vstk = None
    if with_valid:
        ones = torch.full((1, L_pad), -1, dtype=torch.int32,
                          device=wstk.device)  # every bit set
        vstk = torch.stack([ones if e[6] is None else padw(e[6])
                            for e in entries])
    return wstk, vstk


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


def _row_keys(cols: List[np.ndarray]) -> np.ndarray:
    """Combine row values into a single comparable key (hash; verified
    callers tolerate the astronomically unlikely collision)."""
    if not cols:
        return np.zeros(0, np.uint64)
    h = np.zeros(len(cols[0]), dtype=np.uint64)
    for c in cols:
        x = np.ascontiguousarray(c)
        if x.dtype.kind == "f":
            x = x.view(np.uint64 if x.dtype.itemsize == 8 else np.uint32)
        x = x.astype(np.uint64)
        h ^= (x + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6)) + (h >> np.uint64(2)))
        h *= np.uint64(0xBF58476D1CE4E5B9)
    return h


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
