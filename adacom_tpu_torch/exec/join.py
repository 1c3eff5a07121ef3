"""Joins and the streamed join -> aggregate pipeline (host operators).

Port of the JAX package's joins (adacom_tpu/exec/executor.py: the
streamed pipeline :701-897, _exec_join :2091, the streamed probe
:2249-2384, the index join :2386-2479, _residual_mask :2481,
_StreamAggFold :3098 and the helpers :3244, :3421-3505, :3562), the
second module split out of the executor. The JAX package has no device
join on one device (a device join lost to the native hash table at every
size, DEVICE_JOIN_CURVE.md), so this is host code: numpy and the native
C++ hash tables (native.JoinTable, native.hash_join_i64) over host
batches, fed by the executor's scan tiers. With a mesh, the streamed
probe and the streamed pipeline decline, and an equi-join of at least
distributed_join_rows rows whose build keys are unique shuffles over the
mesh (parallel/ops.make_distributed_join_rowids), falling back to the host
join on duplicate build keys or bin overflow.

Two departures from the JAX package, where it is not SQL:
- a row whose join key holds a NULL matches nothing: inner and semi joins
  drop it, left, right, full and anti joins keep it unmatched (the JAX
  package maps NULL keys of both sides to one sentinel, so they match);
- the index join keeps only hit rows inside the pinned snapshot's row
  count of each segment, whose key is not NULL.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from adacom_tpu_torch import native
from adacom_tpu_torch.sql import bound as b
from adacom_tpu_torch.exec.expr import compute_dtype_of
from adacom_tpu_torch.exec.mat import Mat, _FallbackToDevice


class Join:
    """The executor's join operators (mixed into exec.executor's Executor,
    whose scan, expression and aggregate helpers they use)."""

    # ------------------------------------------------------------------
    # keys
    # ------------------------------------------------------------------
    def _join_keys(self, exprs, mat: Mat, lits):
        """Key arrays of `exprs` over `mat` and the rows whose keys are
        all non-NULL (None: every row)."""
        keys, ok = [], None
        for e in exprs:
            (v, m), = self._eval_on_mat([e], mat, lits)
            k = np.asarray(v)
            if k.ndim == 0:
                k = np.full(mat.nrows, k)
            keys.append(k)
            if m is not None:
                mm = np.asarray(m)
                if mm.ndim == 0:
                    mm = np.full(mat.nrows, bool(mm))
                ok = mm if ok is None else ok & mm
        return keys, ok

    # ------------------------------------------------------------------
    # the materializing join
    # ------------------------------------------------------------------
    def _exec_join(self, node: b.LogicalJoin, lits) -> Mat:
        if node.null_aware:
            return self._exec_null_aware_anti(node, lits)
        return self._exec_join_sides(node, lits)

    def _exec_null_aware_anti(self, node: b.LogicalJoin, lits) -> Mat:
        """NOT IN: x NOT IN (SELECT y ...), the pair conditions[0]. The
        right rows of a left row o, S(o), are those that meet the other
        conditions and the residual (a correlated subquery), else all of
        them. o survives when S(o) is empty, or when x is not NULL and S(o)
        holds no NULL y and no y equal to x (the JAX package plans a
        correlated NOT IN as NOT EXISTS)."""
        right = self._exec(node.right, lits)
        if right.nrows == 0:
            out = self._exec(node.left, lits)
            out.names = list(node.names)
            return out
        pair, corr = node.conditions[:1], node.conditions[1:]
        _rk, rok = self._join_keys([pair[0][1]], right, lits)
        if not corr and node.residual is None:
            # one S for every left row: the uncorrelated NOT IN
            if rok is not None and not rok.all():
                return Mat.empty_like(node)
            out = self._exec_join_sides(node, lits, right)
            _lk, lok = self._join_keys([pair[0][0]], out, lits)
            return out if lok is None else out.take(np.nonzero(lok)[0])
        left = self._exec(node.left, lits)
        _lk, lok = self._join_keys([pair[0][0]], left, lits)
        has = self._matched(node, left, right, corr, lits)
        keep = ~has
        alive = has if lok is None else has & lok
        if rok is not None and not rok.all():
            nulls = right.take(np.nonzero(~rok)[0])
            alive &= ~self._matched(node, left, nulls, corr, lits)
        keep |= alive & ~self._matched(node, left, right, node.conditions,
                                       lits)
        out = left.take(np.nonzero(keep)[0])
        out.names = list(node.names)
        return out

    def _matched(self, node, left, right, conditions, lits) -> np.ndarray:
        """Left rows with a right row that meets `conditions` (NULL keys
        meet nothing) and node's residual."""
        if conditions:
            lkeys, lok = self._join_keys([le for le, _r in conditions],
                                         left, lits)
            rkeys, rok = self._join_keys([re_ for _l, re_ in conditions],
                                         right, lits)
            li, ri = _hash_join_pairs(lkeys, rkeys, self.config, lok, rok,
                                      db=self.db)
        else:
            li = np.repeat(np.arange(left.nrows), right.nrows)
            ri = np.tile(np.arange(right.nrows), left.nrows)
        if node.residual is not None and len(li):
            ok = self._residual_mask(node, left, right, li, ri, lits)
            li = li[ok]
        hit = np.zeros(left.nrows, dtype=bool)
        hit[li] = True
        return hit

    def _exec_join_sides(self, node: b.LogicalJoin, lits,
                         right: Optional[Mat] = None) -> Mat:
        left = None
        if node.conditions and right is None:
            # index join: probe the indexed base table with the other
            # side's keys instead of scanning it (whichever side the
            # build-side swap left it on)
            if self._ij_eligible(node, "right"):
                left = self._exec(node.left, lits)
                right = self._index_join_reduce(node, left, "right", lits)
            elif node.join_type == "inner" and \
                    self._ij_eligible(node, "left"):
                right = self._exec(node.right, lits)
                left = self._index_join_reduce(node, right, "left", lits)
        if left is None and self._streaming_join_eligible(node):
            # morsel-streaming probe pipeline (reference PipelineExecutor:
            # source -> operators -> sink in chunks): build once from the
            # right side, stream the left base table segment-by-segment
            if right is None:
                right = self._exec(node.right, lits)
            mat = self._exec_join_streaming(node, right, lits)
            if mat is not None:
                return mat
        if left is None:
            left = self._exec(node.left, lits)
        if right is None:
            right = self._exec(node.right, lits)
        jt = node.join_type

        if not node.conditions:
            # cross product (also inner joins whose only predicates are
            # non-equi residuals)
            li = np.repeat(np.arange(left.nrows), right.nrows)
            ri = np.tile(np.arange(right.nrows), left.nrows)
        else:
            lkeys, lok = self._join_keys([le for le, _r in node.conditions],
                                         left, lits)
            rkeys, rok = self._join_keys([re_ for _l, re_ in node.conditions],
                                         right, lits)
            li, ri = _hash_join_pairs(lkeys, rkeys, self.config, lok, rok,
                                      db=self.db)

        if node.residual is not None:
            # apply the residual to the matched pairs BEFORE computing the
            # preserved (unmatched) rows: a LEFT JOIN .. ON k AND p keeps
            # left rows whose matches all fail p, with NULL right columns;
            # a semi join's left row matches iff SOME key-equal right row
            # also passes it (reference: comparison-+-residual handling in
            # src/execution/operator/join/physical_hash_join.cpp)
            ok = self._residual_mask(node, left, right, li, ri, lits)
            li, ri = li[ok], ri[ok]

        if jt in ("semi", "anti"):
            matched = np.zeros(left.nrows, dtype=bool)
            matched[li] = True
            out = left.take(np.nonzero(matched if jt == "semi"
                                       else ~matched)[0])
            out.names = list(node.names)
            return out

        if jt in ("left", "full"):
            matched = np.zeros(left.nrows, dtype=bool)
            matched[li] = True
            un = np.nonzero(~matched)[0]
        if jt in ("right", "full"):
            rmatched = np.zeros(right.nrows, dtype=bool)
            rmatched[ri] = True
            run = np.nonzero(~rmatched)[0]

        if isinstance(li, np.memmap):
            # spilled join: materialize output columns chunk-wise into
            # disk-backed arrays (outer-join padding below falls back to
            # RAM concatenation; the spill targets are inner joins)
            from adacom_tpu_torch.exec import spill

            gather = spill.gather
        else:
            gather = _gather_rows
        lcols = [gather(c, li) for c in left.cols]
        lvalids = [None if v is None else gather(v, li) for v in left.valids]
        rcols = [gather(c, ri) for c in right.cols]
        rvalids = [None if v is None else gather(v, ri) for v in right.valids]

        if jt in ("left", "full") and len(un):
            lcols = [np.concatenate([c, full_c[un]])
                     for c, full_c in zip(lcols, left.cols)]
            lvalids = [
                None if v is None and fv is None else
                np.concatenate([
                    v if v is not None else np.ones(len(li), bool),
                    fv[un] if fv is not None else np.ones(len(un), bool),
                ])
                for v, fv in zip(lvalids, left.valids)
            ]
            rcols = [np.concatenate([c, np.zeros(len(un), c.dtype)])
                     for c in rcols]
            rvalids = [
                np.concatenate([
                    v if v is not None else np.ones(len(ri), bool),
                    np.zeros(len(un), bool),
                ])
                for v in rvalids
            ]
        if jt in ("right", "full") and len(run):
            n_have = len(lcols[0]) if lcols else len(ri)
            lcols = [np.concatenate([c, np.zeros(len(run), c.dtype)])
                     for c in lcols]
            lvalids = [
                np.concatenate([
                    v if v is not None else np.ones(n_have, bool),
                    np.zeros(len(run), bool),
                ])
                for v in lvalids
            ]
            rcols = [np.concatenate([c, full_c[run]])
                     for c, full_c in zip(rcols, right.cols)]
            rvalids = [
                None if v is None and fv is None else
                np.concatenate([
                    v if v is not None else np.ones(n_have, bool),
                    fv[run] if fv is not None else np.ones(len(run), bool),
                ])
                for v, fv in zip(rvalids, right.valids)
            ]

        return Mat(
            list(node.names), list(node.types),
            getattr(node, "dicts", [None] * len(node.names)),
            lcols + rcols, lvalids + rvalids,
        )

    def _residual_mask(self, node, left: Mat, right: Mat, li, ri, lits):
        """Evaluate the join residual over candidate pairs (li, ri); returns
        a boolean keep-mask (NULL -> False)."""
        pair = Mat(
            list(left.names) + list(right.names),
            list(left.types) + list(right.types),
            list(left.dicts) + list(right.dicts),
            [c[li] for c in left.cols] + [c[ri] for c in right.cols],
            [None if v is None else v[li] for v in left.valids]
            + [None if v is None else v[ri] for v in right.valids],
            len(li),
        )
        (v, m), = self._eval_on_mat([node.residual], pair, lits)
        mask = np.asarray(v)
        if mask.ndim == 0:
            mask = np.full(len(li), bool(mask))
        if m is not None:
            mask = mask & np.asarray(m)
        return mask.astype(bool)

    # ------------------------------------------------------------------
    # the streamed probe
    # ------------------------------------------------------------------
    def _streaming_join_eligible(self, node: b.LogicalJoin) -> bool:
        """Static gates of the streamed probe pipeline."""
        return bool(
            getattr(self.config, "streaming_join_enabled", True)
            and self.db.mesh is None
            and native.available()
            and node.conditions and node.residual is None
            and node.join_type in ("inner", "semi", "anti")
            and isinstance(node.left, b.LogicalGet))

    def _build_join_ht(self, node: b.LogicalJoin, right: Mat, lits):
        """Build-side keys + persistent native hash table for a streamed
        probe; returns (rkeys, exact, ht, rsel) or None (budget / native).
        rsel maps the table's rows to right's rows when some build key is
        NULL (those rows are left out), else it is None."""
        rkeys, rok = self._join_keys([re_ for _le, re_ in node.conditions],
                                     right, lits)
        rsel = None
        if rok is not None:
            rsel = np.flatnonzero(rok)
            rkeys = [k[rsel] for k in rkeys]
        budget = getattr(self.config, "memory_limit", None)
        if budget and len(rkeys[0]) * 24 > budget // 2:
            return None  # beyond budget: grace-hash spill path
        exact = (len(rkeys) == 1 and rkeys[0].dtype.kind in "iu"
                 and rkeys[0].dtype != np.uint64)
        rk64 = (np.ascontiguousarray(rkeys[0], dtype=np.int64) if exact
                else _row_keys(rkeys).view(np.int64))
        try:
            ht = native.JoinTable(rk64)
        except RuntimeError:
            return None
        return rkeys, exact, ht, rsel

    def _probe(self, built, lexprs, chunk: Mat, lits):
        """Probe a built hash table with a morsel's keys: (li, ri) pairs,
        li into the chunk's rows, ri into the build side's rows. Rows with
        a NULL key probe nothing."""
        rkeys, exact, ht, rsel = built
        lkeys, lok = self._join_keys(lexprs, chunk, lits)
        lsel = None
        if lok is not None:
            lsel = np.flatnonzero(lok)
            lkeys = [k[lsel] for k in lkeys]
        lk64 = (np.ascontiguousarray(lkeys[0], dtype=np.int64) if exact
                else _row_keys(lkeys).view(np.int64))
        li, ri = ht.probe(lk64)
        if not exact and len(li):
            li, ri = _verify_join_pairs(lkeys, rkeys, li, ri)
        if lsel is not None:
            li = lsel[li]
        if rsel is not None:
            ri = rsel[ri]
        return li, ri

    def _exec_join_streaming(self, node: b.LogicalJoin, right: Mat,
                             lits) -> Optional[Mat]:
        """Pipelined hash-join probe (reference pipeline_executor.cpp:38
        push loop + JoinHashTable::Probe): the build side materialized
        once into a persistent native hash table, the probe side streamed
        morsel-by-morsel (one segment per task on the worker pool) — the
        probe table's full column set is never materialized at once.
        Inner/semi/anti without residuals; returns None to fall back."""
        from adacom_tpu_torch.parallel.scheduler import TaskScheduler

        if self.db.mesh is not None:
            return None  # mesh mode: large joins shuffle over all_to_all

        get = node.left
        jt = node.join_type
        snap = self._pin_snapshot(get.table)
        built = self._build_join_ht(node, right, lits)
        if built is None:
            return None
        ht = built[2]
        filt = self._compiled_filter(get)
        params = filt.prep_args(lits) if filt is not None else ()
        candidates = self._zonemap_candidates(get, lits, snap)
        lexprs = [le for le, _re in node.conditions]
        dicts = getattr(get, "dicts", [None] * len(get.names))

        def probe_morsel(i):
            chunk = self._scan_chunk_host(get, snap, i, filt, params,
                                          list(dicts))
            li, ri = self._probe(built, lexprs, chunk, lits)
            if jt == "inner":
                return chunk.take(li), ri
            matched = np.zeros(chunk.nrows, dtype=bool)
            matched[li] = True
            keep = np.nonzero(matched if jt == "semi" else ~matched)[0]
            return chunk.take(keep), None

        try:
            results = TaskScheduler.get().map_segments(
                probe_morsel, candidates, threads=self.config.threads)
        except _FallbackToDevice:
            return None
        finally:
            ht.close()
        self.db.dist_stats["streamed_join"] = \
            self.db.dist_stats.get("streamed_join", 0) + 1
        lmats = [m for m, _ri in results]
        lcols = [
            np.concatenate([m.cols[ci] for m in lmats]) if lmats else
            np.empty(0, compute_dtype_of(get.types[ci]))
            for ci in range(len(get.names))
        ]
        lvalids: List[Optional[np.ndarray]] = []
        for ci in range(len(get.names)):
            if any(m.valids[ci] is not None for m in lmats):
                lvalids.append(np.concatenate([
                    m.valids[ci] if m.valids[ci] is not None
                    else np.ones(m.nrows, bool) for m in lmats]))
            else:
                lvalids.append(None)
        dicts_j = list(getattr(node, "dicts", [None] * len(node.names)))
        if jt in ("semi", "anti"):
            return Mat(list(node.names), list(node.types), dicts_j, lcols,
                       lvalids)
        ri_all = (np.concatenate([ri for _m, ri in results])
                  if results else np.zeros(0, np.int64))
        rcols = [_gather_rows(c, ri_all) for c in right.cols]
        rvalids = [None if v is None else _gather_rows(v, ri_all)
                   for v in right.valids]
        return Mat(list(node.names), list(node.types), dicts_j,
                   lcols + rcols, lvalids + rvalids)

    # ------------------------------------------------------------------
    # the index join
    # ------------------------------------------------------------------
    def _ij_eligible(self, node: b.LogicalJoin, side: str) -> bool:
        """Static index-join eligibility for `side` (reduced without row
        counts — those are checked in _index_join_reduce)."""
        if not getattr(self.config, "index_join_max_probe", 0):
            return False
        if side == "left" and node.join_type != "inner":
            return False  # reducing the preserved side needs bookkeeping
        if side == "right" and node.join_type not in ("inner", "semi"):
            return False
        get = node.right if side == "right" else node.left
        if not isinstance(get, b.LogicalGet) or get.filters:
            return False
        cols = []
        for le, re_ in node.conditions:
            key = re_ if side == "right" else le
            if not isinstance(key, b.BColumn):
                return False
            cols.append(get.column_ids[key.index])
        return get.table.index_on_columns(cols) is not None

    def _index_join_reduce(self, node: b.LogicalJoin, probe_mat: Mat,
                           side: str, lits) -> Optional[Mat]:
        """Index join (reference physical_index_join.cpp / plan_index_join):
        look the probe side's join keys up in the other side's index and
        materialize ONLY matching rows — the indexed table is never
        scanned. Returns the reduced Mat for `side`, or None (caller
        falls back to the full scan). The reduced side then rides the
        normal pair-expansion join, so duplicates and residuals keep
        their semantics. NULL probe keys probe nothing; hit rows whose
        key is NULL (their slots hold fill values) or that lie past the
        snapshot's row count of their segment are dropped."""
        get = node.right if side == "right" else node.left
        limit = getattr(self.config, "index_join_max_probe", 8192)
        if probe_mat.nrows > limit or probe_mat.nrows == 0:
            return None
        if get.table.row_count() < 4 * probe_mat.nrows:
            return None
        cols = []
        for le, re_ in node.conditions:
            key = re_ if side == "right" else le
            cols.append(get.column_ids[key.index])
        idx = get.table.index_on_columns(cols)
        if idx is None:
            return None
        probes, pok = self._join_keys(
            [le if side == "right" else re_ for le, re_ in node.conditions],
            probe_mat, lits)
        if pok is not None:
            probes = [p[pok] for p in probes]
        snap = self._pin_snapshot(get.table)
        hits = (idx.lookup_eq_batch(probes if idx.composite else probes[0])
                if len(probes[0]) else [])
        seg_rows = []
        arrays: List[List[np.ndarray]] = [[] for _ in get.column_ids]
        valids: List[List[Optional[np.ndarray]]] = [[] for _ in get.column_ids]
        any_valid = [False] * len(get.column_ids)
        n_vis = snap.segment_count()
        for seg_idx, rows in hits:
            if seg_idx >= n_vis:
                continue  # index saw segments sealed after the snapshot
            rows = rows[rows < snap.segment_rows(seg_idx)]
            for cname in cols:
                kv = snap.segment(cname, seg_idx).host_validity()
                if kv is not None:
                    rows = rows[kv[rows]]
            dm = snap.delete_mask(seg_idx)
            if dm is not None:
                inb = rows < len(dm)
                keep = np.ones(len(rows), dtype=bool)
                keep[inb] = ~dm[rows[inb]]
                rows = rows[keep]
            for ci, cname in enumerate(get.column_ids):
                seg = snap.segment(cname, seg_idx)
                hv = seg.host_plain()
                arrays[ci].append(hv[rows])
                v = seg.host_validity()
                if v is not None:
                    any_valid[ci] = True
                valids[ci].append(None if v is None else v[rows])
            seg_rows.append(len(rows))
        cols_np = [
            np.concatenate(a) if a else
            np.empty(0, compute_dtype_of(get.types[ci]))
            for ci, a in enumerate(arrays)
        ]
        valids_np: List[Optional[np.ndarray]] = []
        for ci in range(len(get.column_ids)):
            if not any_valid[ci]:
                valids_np.append(None)
            else:
                valids_np.append(np.concatenate([
                    v if v is not None else np.ones(n, bool)
                    for v, n in zip(valids[ci], seg_rows)
                ]))
        dicts = getattr(get, "dicts", [None] * len(get.names))
        self.db.dist_stats["index_join"] = \
            self.db.dist_stats.get("index_join", 0) + 1
        return Mat(list(get.names), list(get.types), list(dicts),
                   cols_np, valids_np)

    # ------------------------------------------------------------------
    # the streamed join -> aggregate pipeline
    # ------------------------------------------------------------------
    def _try_streaming_join_agg(self, node: b.LogicalAggregate,
                                child, lits) -> Optional[Mat]:
        """Aggregate sink fused into a streamed LEFT-DEEP pipeline
        (reference pipeline_executor.cpp push loop: source -> operators
        -> sink in 2048-row chunks): the plan spine
        Aggregate <- [Project|Join]* <- Get streams the base table
        segment-by-segment; every join's build side materializes ONCE
        into a persistent native hash table, every Project re-applies
        per morsel, and morsels fold into partial group state with
        amortized merges — the joined intermediate (TPC-H Q18's
        lineitem x orders x customer) never materializes at once."""
        if not getattr(self.config, "streaming_agg_sink_enabled", True):
            return None
        if self.db.mesh is not None:
            return None
        if not native.available() or \
                not getattr(self.config, "streaming_join_enabled", True):
            return None
        specs, finishers = self._agg_specs(node)
        if any(d for *_x, d in specs):
            return None
        if any(k == "hll" or k.startswith("q:") for k, *_x in specs):
            return None
        # walk the left-deep spine down to a Get
        stages = []  # outermost first; applied reversed per morsel
        cur = child
        while len(stages) < 8:
            if isinstance(cur, b.LogicalProject):
                stages.append(("project", cur))
                cur = cur.child
            elif isinstance(cur, b.LogicalJoin):
                if (not cur.conditions or cur.null_aware or
                        cur.join_type not in
                        ("inner", "semi", "anti", "left")):
                    return None
                if self._ij_eligible(cur, "right") or \
                        self._ij_eligible(cur, "left"):
                    return None  # index-join reductions beat streaming
                stages.append(("join", cur))
                cur = cur.left
            else:
                break
        if not isinstance(cur, b.LogicalGet) or \
                not any(k == "join" for k, _n in stages):
            return None
        get = cur

        # build every join stage's hash table (build sides materialize
        # once — the reference's per-pipeline sink dependency)
        built = {}  # id(join node) -> (right, (rkeys, exact, ht, rsel))
        try:
            for kind, jn in stages:
                if kind != "join":
                    continue
                right = self._exec(jn.right, lits)
                got = self._build_join_ht(jn, right, lits)
                if got is None:
                    return None
                built[id(jn)] = (right, got)

            fold = _StreamAggFold(self, node, lits, specs, finishers)
            if not self._stream_pipeline(get, stages, built, fold, lits):
                return None
            self.db.dist_stats["streamed_join_agg"] = \
                self.db.dist_stats.get("streamed_join_agg", 0) + 1
            return fold.finish()
        finally:
            for _r, (_k, _e, ht, _s) in built.values():
                ht.close()

    def _stream_pipeline(self, get, stages, built, fold, lits) -> bool:
        """Drive the pipeline: scan morsels in parallel waves, apply the
        stage chain per morsel (workers), fold serially. Returns False to
        signal the caller to fall back (non-numpy filter/expr)."""
        from adacom_tpu_torch.parallel.scheduler import TaskScheduler

        snap = self._pin_snapshot(get.table)
        filt = self._compiled_filter(get)
        params = filt.prep_args(lits) if filt is not None else ()
        candidates = self._zonemap_candidates(get, lits, snap)
        dicts_g = list(getattr(get, "dicts", [None] * len(get.names)))

        def run_morsel(i):
            mat = self._scan_chunk_host(get, snap, i, filt, params, dicts_g)
            for kind, n_ in reversed(stages):
                if mat.nrows == 0:
                    return mat
                if kind == "project":
                    mat = self._project_mat(n_, mat, lits)
                else:
                    mat = self._apply_probe_stage(n_, built[id(n_)], mat,
                                                  lits)
            return mat

        sched = TaskScheduler.get()
        wave = max(4, (self.config.threads or sched.n_threads) * 4)
        try:
            for w0 in range(0, len(candidates), wave):
                for mat in sched.map_segments(run_morsel,
                                              candidates[w0:w0 + wave],
                                              threads=self.config.threads):
                    fold.add(mat)
        except _FallbackToDevice:
            return False
        return True

    def _scan_chunk_host(self, get, snap, i, filt, params, dicts) -> Mat:
        """One filtered scan morsel as a host Mat (the pipeline source)."""
        segs = [snap.segment(c, i) for c in get.column_ids]
        cols = [(s.host_plain(), s.host_validity()) for s in segs]
        n = segs[0].count if segs else snap.segment_rows(i)
        mask = None
        if filt is not None:
            try:
                fv, fm = filt.fn(cols, params)
            except Exception:
                raise _FallbackToDevice()
            if not isinstance(fv, (np.ndarray, np.generic, bool)):
                raise _FallbackToDevice()
            mask = np.asarray(fv)
            if mask.ndim == 0:
                mask = np.full(n, bool(mask))
            if fm is not None:
                mask = mask & fm
        dm = snap.delete_mask(i)
        if dm is not None:
            dmx = np.zeros(n, dtype=bool)
            dmx[: min(len(dm), n)] = dm[:n]
            mask = ~dmx if mask is None else (mask & ~dmx)
        rows = np.nonzero(mask)[0] if mask is not None else None
        return Mat(
            list(get.names), list(get.types), dicts,
            [c[rows] if rows is not None else c for c, _v in cols],
            [None if v is None else (v[rows] if rows is not None else v)
             for _c, v in cols],
            n if rows is None else len(rows),
        )

    def _apply_probe_stage(self, jn, st, chunk: Mat, lits) -> Mat:
        """Probe one join stage's persistent hash table with a morsel."""
        right, built = st
        jt = jn.join_type
        li, ri = self._probe(built, [le for le, _re in jn.conditions], chunk,
                             lits)
        if jn.residual is not None and len(li):
            # non-equi conjuncts evaluated per candidate pair (reference
            # physical_hash_join.cpp comparison+residual handling)
            ok = self._residual_mask(jn, chunk, right, li, ri, lits)
            li, ri = li[ok], ri[ok]
        dicts_j = list(getattr(jn, "dicts", [None] * len(jn.names)))
        if jt == "inner":
            left = chunk.take(li)
            rcols = [_gather_rows(c, ri) for c in right.cols]
            rvalids = [None if v is None else _gather_rows(v, ri)
                       for v in right.valids]
            return Mat(list(jn.names), list(jn.types), dicts_j,
                       left.cols + rcols, left.valids + rvalids)
        matched = np.zeros(chunk.nrows, dtype=bool)
        matched[li] = True
        if jt == "left":
            # preserved side: unmatched rows append with NULL right
            # columns (same padding as the materializing join)
            un = np.nonzero(~matched)[0]
            lcols = [np.concatenate([_gather_rows(c, li), c[un]])
                     for c in chunk.cols]
            lvalids = [None if v is None
                       else np.concatenate([v[li], v[un]])
                       for v in chunk.valids]
            rcols = [np.concatenate([_gather_rows(c, ri),
                                     np.zeros(len(un), c.dtype)])
                     for c in right.cols]
            rvalids = [np.concatenate([
                v[ri] if v is not None else np.ones(len(ri), bool),
                np.zeros(len(un), bool)]) for v in right.valids]
            return Mat(list(jn.names), list(jn.types), dicts_j,
                       lcols + rcols, lvalids + rvalids)
        keep = np.nonzero(matched if jt == "semi" else ~matched)[0]
        out = chunk.take(keep)
        return Mat(list(jn.names), list(jn.types), dicts_j,
                   out.cols, out.valids)


class _StreamAggFold:
    """Partial-aggregation sink for the streamed join pipeline: morsels
    fold into (group-keys, primitive-partials) state; pending partials
    re-merge whenever they outgrow the merged state (amortized O(n) —
    the reference's local->global radix-partitioned combine,
    partitionable_hashtable.cpp, in vectorized-numpy form)."""

    def __init__(self, ex, node, lits, specs, finishers):
        self.ex = ex
        self.node = node
        self.lits = lits
        self.specs = specs
        self.finishers = finishers
        self.keys_parts: list = []
        self.prims_parts: list = []
        self.rows_pending = 0
        self.merged = None

    def add(self, mat: Mat) -> None:
        if mat.nrows == 0:
            return
        uniq, prim = self.ex._agg_partials(self.node, mat, self.lits,
                                           self.specs)
        self.keys_parts.append(uniq)
        self.prims_parts.append(prim)
        self.rows_pending += len(prim[0]) if prim else 0
        base = len(self.merged[1][0]) if self.merged else 0
        if self.rows_pending > max(1 << 18, base):
            self._merge()

    def _merge(self) -> None:
        if not self.keys_parts:
            return
        kp, pp = self.keys_parts, self.prims_parts
        if self.merged is not None:
            kp = [self.merged[0]] + kp
            pp = [self.merged[1]] + pp
        self.merged = self.ex._combine_partials(self.node, self.specs,
                                                kp, pp)
        self.keys_parts, self.prims_parts = [], []
        self.rows_pending = 0

    def finish(self) -> Mat:
        self._merge()
        if self.merged is None:
            # no matching rows anywhere: aggregate an empty batch for the
            # correct empty-group / NULL-sum semantics
            child = self.node.child
            empty = Mat(
                list(child.names), list(child.types),
                list(getattr(child, "dicts", [None] * len(child.names))),
                [np.empty(0, compute_dtype_of(t)) for t in child.types],
                [None] * len(child.types))
            return self.ex._aggregate_host(self.node, empty, self.lits)
        uniq, prim = self.merged
        return self.ex._finish_agg(self.node, self.specs, self.finishers,
                                   uniq, prim)


# ======================================================================
# helpers
# ======================================================================


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


def _gather_rows(c: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Join-output column gather: threaded native kernel for large index
    sets, numpy fancy indexing otherwise."""
    c = np.asarray(c)
    if len(idx) >= 1 << 20 and c.ndim == 1 and c.dtype.itemsize in (1, 4, 8):
        out = native.gather_rows(c, idx)
        if out is not None:
            return out
    return c[idx]


def _hash_join_pairs(lkeys: List[np.ndarray], rkeys: List[np.ndarray],
                     config=None, lok=None, rok=None, db=None):
    """All matching (left_idx, right_idx) pairs for equi-keys (native
    chained hash table over exact or hash-combined keys, pairs verified).
    lok / rok mark the rows whose keys are all non-NULL (None: every row);
    the other rows match nothing. With a mesh on `db`, a join of at least
    distributed_join_rows rows shuffles over it when its build keys are
    unique (_distributed_join_pairs)."""
    if lok is not None or rok is not None:
        lsel = None if lok is None else np.flatnonzero(lok)
        rsel = None if rok is None else np.flatnonzero(rok)
        li, ri = _hash_join_pairs(
            lkeys if lsel is None else [k[lsel] for k in lkeys],
            rkeys if rsel is None else [k[rsel] for k in rkeys], config,
            db=db)
        return (li if lsel is None else lsel[li],
                ri if rsel is None else rsel[ri])
    # single integer key: the value IS the join key — no hashing and, with
    # no collisions possible, no pair verification (uint64 excluded: its
    # top half aliases negative int64 under the common conversion)
    exact = (
        len(lkeys) == 1
        and lkeys[0].dtype.kind in "iu" and rkeys[0].dtype.kind in "iu"
        and lkeys[0].dtype != np.uint64 and rkeys[0].dtype != np.uint64
    )
    if exact:
        lk = np.ascontiguousarray(lkeys[0], dtype=np.int64).view(np.uint64)
        rk = np.ascontiguousarray(rkeys[0], dtype=np.int64).view(np.uint64)
        verify = lambda li, ri: (np.asarray(li, dtype=np.int64),  # noqa: E731
                                 np.asarray(ri, dtype=np.int64))
    else:
        lk = _row_keys(lkeys)
        rk = _row_keys(rkeys)
        verify = lambda li, ri: _verify_join_pairs(  # noqa: E731
            lkeys, rkeys, li, ri)
    mesh = getattr(db, "mesh", None)
    dthresh = getattr(config, "distributed_join_rows", 0) if config else 0
    if mesh is not None and dthresh and len(rk) and \
            len(lk) + len(rk) >= dthresh:
        pair = _distributed_join_pairs(db, mesh, lk, rk)
        if pair is not None:
            return verify(*pair)
    budget = getattr(config, "memory_limit", None) if config else None
    if budget and (len(lk) + len(rk)) * 24 > budget // 2:
        # out-of-core: grace-hash-partitioned join with disk-backed pair
        # streams (reference ProbeSpill, join_hashtable.cpp:16)
        from adacom_tpu_torch.exec import spill

        P = max(2, ((len(lk) + len(rk)) * 24) // max(budget // 8, 1))
        li, ri = spill.partitioned_join_pairs(lk, rk, P)
        return spill.verify_pairs_chunked(lkeys, rkeys, li, ri)
    # native chained-bucket hash table with threaded probes (reference
    # JoinHashTable::Build/Probe); falls back to the vectorized numpy
    # sort-probe join without the native library
    pair = native.hash_join_i64(rk.view(np.int64), lk.view(np.int64))
    if pair is not None:
        return verify(*pair)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    counts = hi - lo
    li = np.repeat(np.arange(len(lk)), counts)
    total = int(counts.sum())
    if total == 0:
        return li, np.zeros(0, dtype=np.int64)
    # offsets within each run
    starts = np.repeat(lo, counts)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - np.repeat(base, counts)
    ri = order[starts + within]
    return verify(li, ri)


# make_distributed_join_rowids functions by (mesh, capacity)
_DIST_JOIN_CACHE: Dict[tuple, Any] = {}


def _distributed_join_pairs(db, mesh, lk: np.ndarray, rk: np.ndarray):
    """Shuffle-join the (hashed or exact) uint64 keys over the mesh: the
    (li, ri) candidate pairs, or None when ineligible (duplicate build
    keys) or unsafe (bin overflow under skew), and the caller falls back
    to the host join. Both sides pad to powers of two, as in the JAX
    package (where that bounds recompilation)."""
    from adacom_tpu_torch.parallel import mesh as pmesh
    from adacom_tpu_torch.parallel import ops as pops

    rk64 = rk.view(np.int64)
    lk64 = lk.view(np.int64)
    if len(np.unique(rk64)) != len(rk64):
        return None  # duplicate build keys need run expansion: host path
    n_dev = mesh.size

    def padded_len(n):
        p = 1 << max(1, (n - 1)).bit_length()
        return pmesh.pad_to_multiple(max(p, n_dev), n_dev)

    nb, npr = padded_len(len(rk64)), padded_len(len(lk64))
    capacity = max(64, 4 * (max(nb, npr) // n_dev))
    fkey = (mesh, capacity)
    fn = _DIST_JOIN_CACHE.get(fkey)
    if fn is None:
        if len(_DIST_JOIN_CACHE) >= 16:
            _DIST_JOIN_CACHE.clear()
        fn = _DIST_JOIN_CACHE[fkey] = pops.make_distributed_join_rowids(
            mesh, capacity)

    def prep(keys, n_pad):
        k = np.zeros(n_pad, np.int64)
        k[: len(keys)] = keys
        v = np.zeros(n_pad, bool)
        v[: len(keys)] = True
        r = np.zeros(n_pad, np.int64)
        r[: len(keys)] = np.arange(len(keys))
        return [pmesh.shard_leading(mesh, torch.from_numpy(a).to(db.device))
                for a in (k, v, r)]

    bk, bv, br = prep(rk64, nb)
    pk, pv, pr = prep(lk64, npr)
    matched, br_out, pr_out, ovf = fn(bk, bv, br, pk, pv, pr)
    del bk, bv, br, pk, pv, pr
    if int(ovf) > 0:
        return None  # skewed bins overflowed: the host join is always safe
    m = pmesh.gather_leading(matched)
    li = pmesh.gather_leading(pr_out)[m].cpu().numpy()
    ri = pmesh.gather_leading(br_out)[m].cpu().numpy()
    db.dist_stats["join"] += 1
    return li, ri


def _verify_join_pairs(lkeys, rkeys, li, ri):
    """Keep only candidate pairs whose actual keys are equal (hash
    collision safety; the reference compares stored rows the same way)."""
    total = len(li)
    if total == 0:
        return li, np.asarray(ri, dtype=np.int64)
    ok = np.ones(total, dtype=bool)
    for lcol, rcol in zip(lkeys, rkeys):
        lv = lcol[li]
        rv = rcol[ri]
        if lv.dtype.kind == "f" or rv.dtype.kind == "f":
            ok &= lv.astype(np.float64) == rv.astype(np.float64)
        else:
            ok &= lv.astype(np.int64) == rv.astype(np.int64)
    return li[ok], ri[ok]
