"""Logical optimizer.

Parity with the reference Optimizer (src/optimizer/optimizer.cpp:72) for the
rules that matter to this engine's workloads:
- filter pushdown into scans and through projections/joins
  (src/optimizer/pushdown/*)
- projection ("unused column") pruning down to LogicalGet.column_ids
  (src/optimizer/remove_unused_columns.cpp)
- Order+Limit -> TopN (src/optimizer/topn_optimizer.cpp)
- constant folding (src/optimizer/rule/constant_folding.cpp)
- cardinality estimation + greedy build-side selection for inner joins
  (the cost-relevant slice of src/optimizer/join_order/
  join_order_optimizer.cpp + statistics_propagator.cpp: our sort-probe
  join sorts the RIGHT side, so the smaller estimated input goes right;
  a swap is wrapped in a projection restoring output order)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.sql import bound as b
from adacom_tpu_torch.sql.binder import _bexpr_eq, _split_conjuncts


def optimize(plan: b.LogicalOp, structural: Optional[set] = None) -> b.LogicalOp:
    if structural is None:
        structural = set()
    plan = push_filters(plan)
    plan = reorder_joins(plan)
    plan = order_joins(plan)
    plan = fuse_topn(plan, structural)
    plan = prune_columns(plan)
    # optimize remaining (scalar/exists) subquery plans
    for node in b.walk(plan):
        for e in b.iter_node_exprs(node):
            for sq in _subqueries_in(e):
                sq.plan = fuse_topn(sq.plan, structural)
                sq.plan = prune_columns(sq.plan)
    return plan


# ---------------- filter pushdown ----------------


def push_filters(op: b.LogicalOp) -> b.LogicalOp:
    if isinstance(op, b.LogicalFilter):
        child = push_filters(op.child)
        conjuncts = _split_conjuncts(op.condition)
        # separate subquery conjuncts; they become joins AFTER the plain
        # conjuncts have sunk (so join-condition lifting in cross-join
        # chains happens below, not above, the semi join)
        # (reference: src/planner/binder/query_node/plan_subquery.cpp,
        #  src/planner/subquery/flatten_dependent_join.cpp)
        in_subs = []        # uncorrelated IN (sub)
        corr_semis = []     # correlated EXISTS / IN -> semi/anti join
        scalar_corrs = []   # (conjunct, correlated scalar-agg subquery)
        rest = []
        for c in conjuncts:
            # unwrap NOT around EXISTS/IN into the subquery's negated flag
            if isinstance(c, b.BUnary) and c.op == "not" and \
                    isinstance(c.operand, b.BSubquery) and \
                    c.operand.kind in ("exists", "in"):
                c = c.operand
                c.negated = not c.negated
            sqs = _subqueries_in(c)
            corr = [s for s in sqs if s.correlated]
            if corr:
                if isinstance(c, b.BSubquery) and c.kind in ("exists", "in"):
                    corr_semis.append(c)
                elif len(corr) == 1 and corr[0].kind == "scalar":
                    scalar_corrs.append((c, corr[0]))
                else:
                    raise DecorrelateError(
                        "unsupported correlated subquery shape in WHERE")
            elif isinstance(c, b.BSubquery) and c.kind == "in":
                in_subs.append(c)
            else:
                for sq in sqs:
                    sq.plan = push_filters(sq.plan)
                rest.append(c)
        child, remaining = _push_conjuncts(child, rest)
        n_orig = len(child.names)
        for c in in_subs:
            sub = push_filters(c.plan)
            jt = "anti" if c.negated else "semi"
            node = b.LogicalJoin(
                names=list(child.names), types=list(child.types),
                left=child, right=sub, join_type=jt,
                conditions=[(c.operand, b.BColumn(sub.types[0], 0))],
            )
            node.dicts = getattr(child, "dicts", [None] * len(child.names))
            child = node
        for c in corr_semis:
            child = _plan_correlated_semi(child, c)
        for conj, sq in scalar_corrs:
            child, scalar_idx = _plan_correlated_scalar(child, sq)
            col = b.BColumn(sq.ty, scalar_idx)
            remaining.append(_transform_expr(
                conj, lambda e: col if e is sq else None))
        if not remaining:
            return child if not scalar_corrs else _project_prefix(child, n_orig)
        cond = remaining[0]
        for c in remaining[1:]:
            cond = b.BBinary(tt.BOOLEAN, "and", cond, c)
        node = b.LogicalFilter(names=list(child.names), types=list(child.types),
                               child=child, condition=cond)
        node.dicts = getattr(child, "dicts", [None] * len(child.names))
        return node if not scalar_corrs else _project_prefix(node, n_orig)
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, b.LogicalOp):
            setattr(op, f.name, push_filters(v))
    return op


def _split_disjuncts(e: b.BExpr) -> List[b.BExpr]:
    if isinstance(e, b.BBinary) and e.op == "or":
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


def _push_conjuncts(child: b.LogicalOp, conjuncts: List[b.BExpr]):
    """Try to sink each conjunct into `child`; returns (child', leftovers)."""
    remaining: List[b.BExpr] = []
    for c in conjuncts:
        if not _push_one(child, c):
            remaining.append(c)
    return child, remaining


def _push_one(node: b.LogicalOp, conj: b.BExpr) -> bool:
    if isinstance(node, b.LogicalGet):
        node.filters.append(conj)
        return True
    if isinstance(node, b.LogicalFilter):
        if _push_one(node.child, conj):
            return True
        node.condition = b.BBinary(tt.BOOLEAN, "and", node.condition, conj)
        return True
    if isinstance(node, b.LogicalProject):
        # rewrite through the projection when every referenced output column
        # is a direct column passthrough
        mapping = {}
        ok = True
        for col in _cols(conj):
            src = node.exprs[col.index]
            if isinstance(src, b.BColumn):
                mapping[col.index] = src.index
            else:
                ok = False
                break
        if not ok:
            return False
        rewritten = _remap(conj, mapping)
        return _push_one(node.child, rewritten)
    if isinstance(node, b.LogicalJoin):
        n_left = len(node.left.names)
        idxs = [c.index for c in _cols(conj)]
        if idxs and all(i < n_left for i in idxs):
            if node.join_type in ("inner", "cross", "semi", "anti"):
                # left-side-only predicates sink into the left input; for
                # LEFT joins they'd filter preserved rows, so don't push
                return _push_one(node.left, conj)
            return False
        if idxs and all(i >= n_left for i in idxs):
            if node.join_type in ("inner", "cross"):
                shifted = _remap(conj, {i: i - n_left for i in idxs})
                return _push_one(node.right, shifted)
            return False
        # OR of conjunctions spanning both sides (TPC-H Q19): each side's
        # implied predicate (the OR of that side's conjuncts, when every
        # disjunct constrains the side) pushes down as a REDUNDANT extra
        # filter; the original OR stays above for exactness (reference:
        # FilterCombiner's OR-filter derivation,
        # src/optimizer/filter_combiner.cpp)
        if node.join_type in ("inner", "cross") and \
                isinstance(conj, b.BBinary) and conj.op == "or":
            disjuncts = _split_disjuncts(conj)
            if len(disjuncts) >= 2:
                for want in ("left", "right"):
                    per = []
                    for d in disjuncts:
                        cs = [c for c in _split_conjuncts(d)
                              if _side_of(c, n_left) == want]
                        if not cs:
                            per = None
                            break
                        per.append(_conjoin([_copy_expr(c) for c in cs]))
                    if per:
                        derived = per[0]
                        for p in per[1:]:
                            derived = b.BBinary(tt.BOOLEAN, "or", derived, p)
                        if want == "right":
                            derived = _remap(derived, {
                                c.index: c.index - n_left
                                for c in _cols(derived)})
                            _push_one(node.right, derived)
                        else:
                            _push_one(node.left, derived)
            # fall through: the OR itself is handled below / kept above
        # conjunct spans both sides: lift equi-predicates into join
        # conditions (comma joins parse as CROSS; this is the reference's
        # filter-pushdown + join-condition extraction,
        # src/optimizer/pushdown/pushdown_cross_product.cpp)
        if node.join_type in ("inner", "cross"):
            if isinstance(conj, b.BBinary) and conj.op == "=":
                sl = _side_of(conj.left, n_left)
                sr = _side_of(conj.right, n_left)
                if sl == "left" and sr == "right":
                    node.conditions.append(
                        (conj.left, _remap(conj.right, {i: i - n_left for i in
                                                        [c.index for c in _cols(conj.right)]}))
                    )
                    node.join_type = "inner"
                    return True
                if sl == "right" and sr == "left":
                    node.conditions.append(
                        (conj.right, _remap(conj.left, {i: i - n_left for i in
                                                        [c.index for c in _cols(conj.left)]}))
                    )
                    node.join_type = "inner"
                    return True
            node.residual = conj if node.residual is None else b.BBinary(
                tt.BOOLEAN, "and", node.residual, conj
            )
            node.join_type = "inner"
            return True
        return False
    return False


def _subqueries_in(e: b.BExpr):
    return [x for x in b.expr_walk(e) if isinstance(x, b.BSubquery)]


# ---------------- cardinality estimation + join ordering ----------------


_EQ_SELECTIVITY = 0.005   # point predicate (reference defaults are similar:
_RANGE_SELECTIVITY = 0.3  # join_order/cardinality_estimator.cpp heuristics)


def est_rows(op: b.LogicalOp) -> float:
    """Propagated row-count estimate (statistics_propagator.cpp slice):
    table row counts shrunk by per-conjunct selectivity guesses."""
    cached = getattr(op, "_est_rows", None)
    if cached is not None:
        return cached
    if isinstance(op, b.LogicalGet):
        try:
            n = float(op.table.row_count())
        except Exception:
            n = 1e6
        for f in op.filters:
            n *= (_EQ_SELECTIVITY
                  if isinstance(f, b.BBinary) and f.op == "=" else
                  _RANGE_SELECTIVITY)
        est = max(n, 1.0)
    elif isinstance(op, b.LogicalFilter):
        est = max(est_rows(op.child) * _RANGE_SELECTIVITY, 1.0)
    elif isinstance(op, b.LogicalJoin):
        le, re_ = est_rows(op.left), est_rows(op.right)
        if op.join_type in ("semi", "anti"):
            est = le * 0.5
        elif op.conditions:
            # equi-join: assume PK-FK (output ~ the larger FK side)
            est = max(le, re_)
        else:
            est = le * re_
    elif isinstance(op, b.LogicalAggregate):
        c = est_rows(op.child)
        est = 1.0 if not op.groups else max(min(c, c ** 0.7), 1.0)
    elif isinstance(op, b.LogicalTopN):
        est = float(op.limit)
    elif isinstance(op, b.LogicalLimit):
        est = min(est_rows(op.child), 1e4)
    else:
        child = next(
            (getattr(op, f.name) for f in dataclasses.fields(op)
             if isinstance(getattr(op, f.name), b.LogicalOp)), None)
        est = est_rows(child) if child is not None else 1.0
    op._est_rows = est
    return est


def _shift_cols(e: b.BExpr, delta: int) -> b.BExpr:
    if delta == 0:
        return e
    return _transform_expr(
        e, lambda x: b.BColumn(x.ty, x.index + delta, x.name, x.dictionary)
        if isinstance(x, b.BColumn) else None)


def _map_cols(e: b.BExpr, m: Dict[int, int]) -> b.BExpr:
    return _transform_expr(
        e, lambda x: b.BColumn(x.ty, m[x.index], x.name, x.dictionary)
        if isinstance(x, b.BColumn) else None)


def reorder_joins(op: b.LogicalOp) -> b.LogicalOp:
    """Greedy join-order optimization for chains of >= 3 inner joins
    (reference join_order/join_order_optimizer.cpp — DP there, greedy
    smallest-intermediate-first here).

    Flattens a maximal inner-join subtree into relations + an equi-join
    edge set, starts from the smallest estimated relation, repeatedly
    joins the connected relation minimizing the estimated intermediate
    size, then rebuilds a left-deep tree wrapped in a projection restoring
    the original column order.

    The maximal chain must be flattened TOP-DOWN: recursing into join
    children first would reorder (and Project-wrap) inner subtrees,
    leaving the top join a 2-3 leaf stub that can never see the whole
    relation set (the round-3 Q9 cross-product plan)."""
    if not isinstance(op, b.LogicalJoin) or \
            op.join_type not in ("inner", "cross"):
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            if isinstance(v, b.LogicalOp):
                setattr(op, f.name, reorder_joins(v))
        return op

    leaves: List[tuple] = []  # (op, old_start)
    conds: List[tuple] = []   # (le, re) with OLD-global column indices
    resids: List[b.BExpr] = []

    def collect(node, start):
        # cross joins are inner joins without a lifted condition (comma
        # FROM lists whose predicate stayed in a filter above); flattening
        # them is what lets the orderer break up accidental cross products
        if isinstance(node, b.LogicalJoin) and \
                node.join_type in ("inner", "cross"):
            lw = len(node.left.names)
            collect(node.left, start)
            collect(node.right, start + lw)
            for le, re_ in (node.conditions or []):
                conds.append((_shift_cols(le, start),
                              _shift_cols(re_, start + lw)))
            if node.residual is not None:
                resids.append(_shift_cols(node.residual, start))
            return
        leaves.append((node, start))

    collect(op, 0)
    # chains nested below non-join operators inside each leaf subtree
    # still get their own reordering
    leaves = [(reorder_joins(leaf), s) for leaf, s in leaves]
    k = len(leaves)
    if k < 3:
        # op is a 2-leaf join: adopt the recursed leaves directly
        op.left, op.right = leaves[0][0], leaves[1][0]
        return op

    widths = [len(leaf.names) for leaf, _ in leaves]
    starts = [s for _, s in leaves]
    leaf_of_col: Dict[int, int] = {}
    for lid, (leaf, s) in enumerate(leaves):
        for j in range(widths[lid]):
            leaf_of_col[s + j] = lid

    def rels_of(e) -> set:
        return {leaf_of_col[c.index] for c in _cols(e)}

    cond_rels = [rels_of(le) | rels_of(re_) for le, re_ in conds]
    ests = [est_rows(leaf) for leaf, _ in leaves]
    # unfiltered base row counts stand in for per-key distinct counts in
    # the System-R estimate below (V(key) ~ |base table| for key columns)
    bases = []
    for lid, (leaf, _) in enumerate(leaves):
        if isinstance(leaf, b.LogicalGet):
            try:
                bases.append(max(1.0, float(leaf.table.row_count())))
            except Exception:
                bases.append(max(1.0, ests[lid]))
        else:
            bases.append(max(1.0, ests[lid]))

    def _distinct_est(lid, e):
        """V(key): distinct-count estimate for join key e on leaf lid.
        Integer columns use the table zonemap range (min over segments of
        vmin .. max of vmax), dictionary VARCHARs the dictionary size,
        anything else the base row count (surrogate-PK assumption).
        This is what catches low-cardinality equi-joins like TPC-H Q5's
        c_nationkey = s_nationkey (V=25, NOT a PK-FK edge) — reference
        analogue: distinct-count stats in statistics_propagator.cpp."""
        base = bases[lid]
        leaf = leaves[lid][0]
        if isinstance(e, b.BColumn) and isinstance(leaf, b.LogicalGet):
            d = getattr(e, "dictionary", None)
            if d is not None:
                try:
                    return max(1.0, float(min(base, len(d))))
                except Exception:
                    return base
            try:
                name = leaf.column_ids[e.index - starts[lid]]
                col = leaf.table.columns[name]
                if col.ltype.np_dtype.kind in "iu" and col.segments:
                    lo = min(s.vmin for s in col.segments)
                    hi = max(s.vmax for s in col.segments)
                    return max(1.0, float(min(base, hi - lo + 1)))
            except Exception:
                pass
        return base

    def step_est(cur_est, placed, cand):
        """System-R: |A join B| = |A|*|B| / prod over connecting JOIN
        EDGES of max(V(key) per side). Conditions sharing a relation
        pair form ONE composite-key edge whose divisor is the LARGEST
        single-condition divisor — multiplying per-column V assumes
        column independence and underestimates correlated composites
        (lineitem x partsupp on (partkey, suppkey) is 6M rows, not the
        800k the product predicts); overestimating defers unfiltered
        joins, which is the safe direction for a greedy order."""
        pair_div: Dict[frozenset, float] = {}
        connected = False
        for ci, r in enumerate(cond_rels):
            if cand in r and len(r) > 1 and r <= placed | {cand}:
                connected = True
                info = cond_info[ci]
                key = cond_rels_f[ci]
                if info is None:
                    d = min(bases[x] for x in r)
                else:
                    # per side, V-hat = min(base rows, zonemap range) is an
                    # OVERestimate for sparse keys (l_orderkey spans 1..6M
                    # with 1.5M distinct), so take the smaller side's V-hat
                    # (the PK side's estimate is the accurate one)
                    a, va, bb, vb = info
                    d = min(min(bases[a], va), min(bases[bb], vb))
                pair_div[key] = max(pair_div.get(key, 1.0), d)
        if not connected:
            return cur_est * ests[cand]
        divisor = 1.0
        for d in pair_div.values():
            divisor *= d
        return max(1.0, cur_est * ests[cand] / divisor)

    def greedy_from(first):
        order_ = [first]
        placed_ = {first}
        cur = ests[first]
        total = 0.0
        while len(order_) < k:
            best, best_cost = None, None
            for cand in range(k):
                if cand in placed_:
                    continue
                cost = step_est(cur, placed_, cand)
                if best_cost is None or (cost, ests[cand]) < best_cost:
                    best, best_cost = cand, (cost, ests[cand])
            order_.append(best)
            placed_.add(best)
            cur = best_cost[0]
            total += cur
        return order_, total

    def order_cost(order_):
        """Sum of estimated intermediate sizes along a left-deep order."""
        cur = ests[order_[0]]
        placed_ = {order_[0]}
        total = 0.0
        for cand in order_[1:]:
            cur = step_est(cur, placed_, cand)
            placed_.add(cand)
            total += cur
        return total

    cond_rels_f = [frozenset(r) for r in cond_rels]
    cond_info = []
    for (le, re_), r in zip(conds, cond_rels):
        la, ra = rels_of(le), rels_of(re_)
        if len(la) == 1 and len(ra) == 1:
            a, bb = next(iter(la)), next(iter(ra))
            cond_info.append((a, _distinct_est(a, le),
                              bb, _distinct_est(bb, re_)))
        else:
            cond_info.append(None)
    # Exact DP enumeration over connected subsets for small k (the
    # reference runs DPccp up to a relation budget then falls back to
    # greedy, join_order_optimizer.cpp:1-1024); left-deep DP here — the
    # executor builds left-deep trees anyway. For larger k, greedy from
    # every start.
    def dp_order():
        full = (1 << k) - 1
        # best[mask] = (total_cost, cur_est, order_tuple)
        best: Dict[int, tuple] = {
            1 << i: (0.0, ests[i], (i,)) for i in range(k)
        }
        for mask in range(1, full + 1):
            cur = best.get(mask)
            if cur is None or mask == full:
                continue
            total, cur_est_, order_ = cur
            placed_ = set(order_)
            for cand in range(k):
                bit = 1 << cand
                if mask & bit:
                    continue
                e = step_est(cur_est_, placed_, cand)
                nt = total + e
                nm = mask | bit
                old = best.get(nm)
                if old is None or nt < old[0]:
                    best[nm] = (nt, e, order_ + (cand,))
        got = best.get(full)
        return (list(got[2]), got[0]) if got else (None, None)

    if k <= 10:
        order, best_total = dp_order()
    else:
        order, best_total = None, None
    if order is None:
        for first in range(k):
            o, total = greedy_from(first)
            if best_total is None or total < best_total:
                order, best_total = o, total
    if order == list(range(k)) or \
            best_total >= order_cost(list(range(k))):
        order = list(range(k))  # keep the query's own order, but still
        # rebuild so the recursed leaves are adopted

    # old-global -> new-global column mapping
    new_start: Dict[int, int] = {}
    off = 0
    for lid in order:
        new_start[lid] = off
        off += widths[lid]
    m: Dict[int, int] = {}
    for lid in range(k):
        for j in range(widths[lid]):
            m[starts[lid] + j] = new_start[lid] + j

    def leaf_dicts(lid):
        leaf = leaves[lid][0]
        d = getattr(leaf, "dicts", None)
        return list(d) if d is not None else [None] * widths[lid]

    used = [False] * len(conds)
    resid_used = [False] * len(resids)
    cur = leaves[order[0]][0]
    cur_dicts = leaf_dicts(order[0])
    built = {order[0]}
    for lid in order[1:]:
        leaf = leaves[lid][0]
        here_conds, here_resid = [], []
        for ci, (le, re_) in enumerate(conds):
            if used[ci] or not (cond_rels[ci] <= built | {lid}):
                continue
            used[ci] = True
            le_r, re_r = rels_of(le), rels_of(re_)
            if le_r <= built and re_r <= {lid}:
                here_conds.append((_map_cols(le, m),
                                   _shift_cols(re_, -starts[lid])))
            elif re_r <= built and le_r <= {lid}:
                here_conds.append((_map_cols(re_, m),
                                   _shift_cols(le, -starts[lid])))
            else:
                # sides span both inputs (cycle edge): combined-schema
                # residual equality
                cm = dict(m)
                here_resid.append(b.BBinary(
                    tt.BOOLEAN, "=", _map_cols(le, cm), _map_cols(re_, cm)))
        for ri, r in enumerate(resids):
            if not resid_used[ri] and rels_of(r) <= built | {lid}:
                resid_used[ri] = True
                here_resid.append(_map_cols(r, m))
        nj = b.LogicalJoin(
            names=list(cur.names) + list(leaf.names),
            types=list(cur.types) + list(leaf.types),
            left=cur, right=leaf, join_type="inner",
            conditions=here_conds,
            residual=_conjoin(here_resid) if here_resid else None,
        )
        nj.dicts = cur_dicts + leaf_dicts(lid)
        cur = nj
        cur_dicts = nj.dicts
        built.add(lid)

    # restore the original column order for the parent
    op_dicts = getattr(op, "dicts", None) or [None] * len(op.names)
    exprs = [b.BColumn(op.types[i], m[i], op.names[i], op_dicts[i])
             for i in range(len(op.names))]
    proj = b.LogicalProject(names=list(op.names), types=list(op.types),
                            child=cur, exprs=exprs)
    proj.dicts = list(op_dicts)
    return proj


def order_joins(op: b.LogicalOp) -> b.LogicalOp:
    """Greedy build-side selection: the executor's sort-probe join sorts
    the right input, so for inner equi-joins put the SMALLER estimated
    input on the right (swap wrapped in an order-restoring projection)."""
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, b.LogicalOp):
            setattr(op, f.name, order_joins(v))
    if not isinstance(op, b.LogicalJoin) or op.join_type != "inner" or \
            not op.conditions:
        return op
    le, re_ = est_rows(op.left), est_rows(op.right)
    if le >= re_ * 0.5:
        return op  # right is already (close enough to) the smaller side
    n_left, n_right = len(op.left.names), len(op.right.names)
    dicts = getattr(op, "dicts", [None] * len(op.names))
    swapped = b.LogicalJoin(
        names=list(op.names[n_left:]) + list(op.names[:n_left]),
        types=list(op.types[n_left:]) + list(op.types[:n_left]),
        left=op.right, right=op.left, join_type="inner",
        conditions=[(re2, le2) for le2, re2 in op.conditions],
        residual=None,
    )
    swapped.dicts = dicts[n_left:] + dicts[:n_left]
    if op.residual is not None:
        # residual indices: old left i -> n_right + i; old right j -> j-n_left
        m = {i: n_right + i for i in range(n_left)}
        m.update({n_left + j: j for j in range(n_right)})
        swapped.residual = _remap(op.residual, m)
    # restore the original output order
    exprs = []
    for i in range(len(op.names)):
        src = n_right + i if i < n_left else i - n_left
        exprs.append(b.BColumn(op.types[i], src, op.names[i], dicts[i]))
    proj = b.LogicalProject(
        names=list(op.names), types=list(op.types), child=swapped, exprs=exprs)
    proj.dicts = dicts
    return proj


# ---------------- correlated-subquery decorrelation ----------------
# (reference: src/planner/subquery/flatten_dependent_join.cpp — the TPU
# build decorrelates the shapes TPC-H exercises: correlated EXISTS / IN ->
# semi/anti join with equi conditions + residual; `expr CMP (correlated
# aggregate)` -> grouped aggregate + inner join + post-filter)


class DecorrelateError(Exception):
    pass


def _has_outer(e: b.BExpr) -> bool:
    return any(isinstance(x, b.BOuterCol) for x in b.expr_walk(e))


def _conjoin(cs: List[b.BExpr]) -> b.BExpr:
    cond = cs[0]
    for c in cs[1:]:
        cond = b.BBinary(tt.BOOLEAN, "and", cond, c)
    return cond


def _transform_expr(e: b.BExpr, fn) -> b.BExpr:
    """Rebuild `e` bottom-up; fn(node) may return a replacement node."""
    r = fn(e)
    if r is not None:
        return r
    kwargs = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, b.BExpr):
            v = _transform_expr(v, fn)
        elif isinstance(v, list):
            v = [
                _transform_expr(x, fn) if isinstance(x, b.BExpr)
                else tuple(_transform_expr(y, fn) if isinstance(y, b.BExpr) else y
                           for y in x)
                if isinstance(x, tuple) else x
                for x in v
            ]
        kwargs[f.name] = v
    out = type(e)(**kwargs)
    if getattr(e, "is_interval", False):
        out.is_interval = True
    return out


def _outer_to_col(e: b.BExpr) -> b.BExpr:
    """BOuterCol -> BColumn over the outer (join-left) schema."""
    return _transform_expr(
        e, lambda x: b.BColumn(x.ty, x.index, x.name, x.dictionary)
        if isinstance(x, b.BOuterCol) else None)


def _split_corr_filter(node: b.LogicalOp):
    """Strip correlated conjuncts from the LogicalFilter directly above the
    subquery's FROM tree. Returns (plan', corr_conjuncts over FROM schema)."""
    if not isinstance(node, b.LogicalFilter):
        if any(_has_outer(e) for n in b.walk(node) for e in b.iter_node_exprs(n)):
            raise DecorrelateError(
                "correlated reference outside the subquery's top-level WHERE")
        return node, []
    conjs = _split_conjuncts(node.condition)
    corr = [c for c in conjs if _has_outer(c)]
    keep = [c for c in conjs if not _has_outer(c)]
    if any(_has_outer(e) for n in b.walk(node.child) for e in b.iter_node_exprs(n)):
        raise DecorrelateError(
            "correlated reference below the subquery's top-level WHERE")
    if keep:
        node.condition = _conjoin(keep)
        return node, corr
    return node.child, corr


def _classify_corr(corr: List[b.BExpr]):
    """Split correlated conjuncts into equi pairs (pure-outer expr = pure-
    inner expr) and residuals (mix of both sides)."""
    pairs, residuals = [], []
    for c in corr:
        if isinstance(c, b.BBinary) and c.op == "=":
            for o, i in ((c.left, c.right), (c.right, c.left)):
                o_out = any(isinstance(x, b.BOuterCol) for x in b.expr_walk(o))
                o_in = any(isinstance(x, b.BColumn) for x in b.expr_walk(o))
                i_out = any(isinstance(x, b.BOuterCol) for x in b.expr_walk(i))
                i_in = any(isinstance(x, b.BColumn) for x in b.expr_walk(i))
                if o_out and not o_in and i_in and not i_out:
                    pairs.append((_outer_to_col(o), i))
                    break
            else:
                residuals.append(c)
        else:
            residuals.append(c)
    return pairs, residuals


def _ensure_proj_output(proj: b.LogicalProject, e: b.BExpr, name: str) -> int:
    """Index of a projection output computing `e`; appends one if missing."""
    for i, pe in enumerate(proj.exprs):
        if _bexpr_eq(pe, e):
            return i
    proj.exprs.append(e)
    proj.names.append(name or f"__corr_{len(proj.exprs)}")
    proj.types.append(e.ty)
    proj.dicts = getattr(proj, "dicts", [None] * (len(proj.exprs) - 1))
    proj.dicts.append(e.dictionary if isinstance(e, b.BColumn) else None)
    return len(proj.exprs) - 1


def _plan_correlated_semi(child: b.LogicalOp, c: b.BSubquery) -> b.LogicalOp:
    """Correlated EXISTS / IN (subquery) -> semi (or anti) join."""
    sub = c.plan
    if not isinstance(sub, b.LogicalProject):
        raise DecorrelateError("correlated subquery must be a plain SELECT")
    inner, corr = _split_corr_filter(sub.child)
    sub.child = inner
    if not corr:
        raise DecorrelateError("correlated subquery with no correlated WHERE")
    pairs, residuals = _classify_corr(corr)
    conditions = []
    if c.kind == "in":
        conditions.append((c.operand, b.BColumn(sub.types[0], 0)))
    for o, i in pairs:
        idx = _ensure_proj_output(sub, i, getattr(i, "name", ""))
        conditions.append((o, b.BColumn(i.ty, idx)))
    residual = None
    if residuals:
        n_left = len(child.names)

        def fix(x):
            if isinstance(x, b.BOuterCol):
                return b.BColumn(x.ty, x.index, x.name, x.dictionary)
            if isinstance(x, b.BColumn):
                idx = _ensure_proj_output(sub, x, x.name)
                return b.BColumn(x.ty, n_left + idx, x.name, x.dictionary)
            return None

        residual = _conjoin([_transform_expr(r, fix) for r in residuals])
    sub_p = push_filters(sub)
    node = b.LogicalJoin(
        names=list(child.names), types=list(child.types),
        left=child, right=sub_p,
        join_type="anti" if c.negated else "semi",
        conditions=conditions, residual=residual,
    )
    node.dicts = getattr(child, "dicts", [None] * len(child.names))
    return node


def _copy_plan(op: b.LogicalOp) -> b.LogicalOp:
    """Deep copy of a plan subtree (storage Table references are shared).
    Needed when one subtree appears twice in a plan: the optimizer mutates
    nodes in place (pruning, mapping), so sharing would double-apply."""
    kwargs = {}
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, b.LogicalOp):
            v = _copy_plan(v)
        elif isinstance(v, b.BExpr):
            v = _copy_expr(v)
        elif isinstance(v, list):
            v = [
                _copy_plan(x) if isinstance(x, b.LogicalOp)
                else _copy_expr(x) if isinstance(x, b.BExpr)
                else tuple(_copy_expr(y) if isinstance(y, b.BExpr) else y
                           for y in x)
                if isinstance(x, tuple) else x
                for x in v
            ]
        kwargs[f.name] = v
    out = type(op)(**kwargs)
    d = getattr(op, "dicts", None)
    if d is not None:
        out.dicts = list(d)
    return out


def _plan_correlated_scalar(child: b.LogicalOp, sq: b.BSubquery):
    """`expr CMP (SELECT agg(..) FROM .. WHERE inner = outer ..)` ->
    grouped aggregate joined on the correlation keys. Returns
    (join_plan, index of the scalar column in the join output)."""
    sub = sq.plan
    if not (isinstance(sub, b.LogicalProject)
            and isinstance(sub.child, b.LogicalAggregate)
            and not sub.child.groups):
        raise DecorrelateError(
            "correlated scalar subquery must be a single ungrouped aggregate")
    agg = sub.child
    inner, corr = _split_corr_filter(agg.child)
    agg.child = inner
    pairs, residuals = _classify_corr(corr)
    if residuals or not pairs:
        raise DecorrelateError(
            "correlated scalar subquery requires pure equality correlation")
    _magic_set_reduce(child, agg, pairs)
    G = len(pairs)
    agg.groups = [i for _, i in pairs]
    agg.names = [getattr(i, "name", f"g{k}") for k, (_, i) in enumerate(pairs)] + list(agg.names)
    agg.types = [i.ty for _, i in pairs] + list(agg.types)
    agg.dicts = [i.dictionary if isinstance(i, b.BColumn) else None
                 for _, i in pairs] + list(getattr(agg, "dicts", [None] * len(agg.aggregates)))
    # shift aggregate references in the projection past the new group columns
    sub.exprs = [
        _transform_expr(e, lambda x: b.BAggRef(x.ty, x.index + G)
                        if isinstance(x, b.BAggRef) else None)
        for e in sub.exprs
    ]
    # expose the group keys as projection outputs for the join conditions
    for k in range(G):
        sub.exprs.append(b.BColumn(agg.types[k], k, agg.names[k], agg.dicts[k]))
        sub.names.append(agg.names[k])
        sub.types.append(agg.types[k])
        sub.dicts = getattr(sub, "dicts", [None]) + [agg.dicts[k]]
    sub_p = push_filters(sub)
    n_left = len(child.names)
    conditions = [(o, b.BColumn(sub_p.types[1 + k], 1 + k))
                  for k, (o, _) in enumerate(pairs)]
    node = b.LogicalJoin(
        names=list(child.names) + list(sub_p.names),
        types=list(child.types) + list(sub_p.types),
        left=child, right=sub_p, join_type="inner",
        conditions=conditions,
    )
    node.dicts = (getattr(child, "dicts", [None] * len(child.names))
                  + getattr(sub_p, "dicts", [None] * len(sub_p.names)))
    return node, n_left


def _leaf_source(node: b.LogicalOp, idx: int):
    """(LogicalGet, local column index) feeding output column idx through
    pass-through projections/filters/joins, or None. NULL-extended outer
    rows are fine for magic-set use: a NULL key matches nothing in the
    decorrelated join either."""
    if isinstance(node, b.LogicalGet):
        return node, idx
    if isinstance(node, b.LogicalFilter):
        return _leaf_source(node.child, idx)
    if isinstance(node, b.LogicalProject):
        e = node.exprs[idx]
        if isinstance(e, b.BColumn):
            return _leaf_source(node.child, e.index)
        return None
    if isinstance(node, b.LogicalJoin):
        n_left = len(node.left.names)
        if idx < n_left:
            return _leaf_source(node.left, idx)
        if node.join_type in ("semi", "anti"):
            return None
        return _leaf_source(node.right, idx - n_left)
    return None


def _magic_set_reduce(child: b.LogicalOp, agg: b.LogicalAggregate,
                      pairs) -> None:
    """Magic-set reduction for decorrelated scalar aggregates: semi-join
    the aggregate's input with a copy of the (filtered) base relation the
    correlation keys come from, so the aggregate computes only groups the
    decorrelated join can keep (TPC-H Q17: avg over the 168 filtered
    parts' lineitems, not all 200k part groups). Any SUPERSET of the
    outer key domain is safe — the filtered source leaf is one.
    Reference analogue: duplicate-eliminated outer domain joined into the
    dependent subquery, src/planner/subquery/flatten_dependent_join.cpp."""
    inner = agg.child
    try:
        srcs = []
        for o, _ in pairs:
            if not isinstance(o, b.BColumn):
                return
            srcs.append(_leaf_source(child, o.index))
        if any(s is None for s in srcs):
            return
        leaf = srcs[0][0]
        if any(s[0] is not leaf for s in srcs):
            return  # keys must come from one relation to form key tuples
        if not leaf.filters:
            return  # unfiltered leaf = full key domain, no reduction
        if est_rows(leaf) * 4 >= est_rows(inner):
            return
        outer = _copy_plan(leaf)
    except Exception:
        return
    proj = b.LogicalProject(
        names=[getattr(o, "name", f"k{k}") for k, (o, _) in enumerate(pairs)],
        types=[o.ty for o, _ in pairs],
        child=outer,
        exprs=[b.BColumn(o.ty, srcs[k][1], getattr(o, "name", None),
                         getattr(o, "dictionary", None))
               for k, (o, _) in enumerate(pairs)],
    )
    proj.dicts = [getattr(o, "dictionary", None) for o, _ in pairs]
    semi = b.LogicalJoin(
        names=list(inner.names), types=list(inner.types),
        left=inner, right=proj, join_type="semi",
        conditions=[(_copy_expr(i), b.BColumn(o.ty, k))
                    for k, (o, i) in enumerate(pairs)],
    )
    semi.dicts = getattr(inner, "dicts", [None] * len(inner.names))
    agg.child = semi


def _project_prefix(plan: b.LogicalOp, n: int) -> b.LogicalOp:
    """Keep only the first n output columns (drops decorrelation columns)."""
    dicts = getattr(plan, "dicts", [None] * len(plan.names))
    exprs = [b.BColumn(plan.types[i], i, plan.names[i], dicts[i]) for i in range(n)]
    node = b.LogicalProject(
        names=list(plan.names[:n]), types=list(plan.types[:n]),
        child=plan, exprs=exprs,
    )
    node.dicts = dicts[:n]
    return node


def _side_of(e: b.BExpr, n_left: int):
    idxs = [c.index for c in _cols(e)]
    if not idxs:
        return None
    if all(i < n_left for i in idxs):
        return "left"
    if all(i >= n_left for i in idxs):
        return "right"
    return "both"


def _cols(e: b.BExpr) -> List[b.BColumn]:
    return [x for x in b.expr_walk(e) if isinstance(x, b.BColumn)]


def _apply_mapping(exprs, mapping) -> None:
    """Remap column indices across expressions, visiting each shared
    BColumn object exactly once (BETWEEN/CASE desugaring shares nodes)."""
    seen = set()
    for e in exprs:
        if e is None:
            continue
        for c in _cols(e):
            if id(c) in seen:
                continue
            seen.add(id(c))
            c.index = mapping[c.index]


def _remap(e: b.BExpr, mapping: Dict[int, int]) -> b.BExpr:
    e = _copy_expr(e)
    for x in b.expr_walk(e):
        if isinstance(x, b.BColumn) and x.index in mapping:
            x.index = mapping[x.index]
    return e


def _copy_expr(e: b.BExpr) -> b.BExpr:
    kwargs = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, b.BExpr):
            v = _copy_expr(v)
        elif isinstance(v, list):
            v = [
                _copy_expr(x) if isinstance(x, b.BExpr)
                else tuple(_copy_expr(y) if isinstance(y, b.BExpr) else y for y in x)
                if isinstance(x, tuple) else x
                for x in v
            ]
        kwargs[f.name] = v
    out = type(e)(**kwargs)
    if getattr(e, "is_interval", False):
        out.is_interval = True
    return out


# ---------------- TopN fusion ----------------


def fuse_topn(op: b.LogicalOp, structural: set) -> b.LogicalOp:
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, b.LogicalOp):
            setattr(op, f.name, fuse_topn(v, structural))
    if isinstance(op, b.LogicalLimit) and isinstance(op.child, b.LogicalOrder):
        lim = op.limit
        off = op.offset
        if isinstance(lim, b.BLiteral) and isinstance(lim.value, int) and (
            off is None or (isinstance(off, b.BLiteral) and isinstance(off.value, int))
        ):
            # baking the limit value into the plan makes its literal slot
            # structural for the plan cache
            if lim.param is not None:
                structural.add(lim.param)
            if off is not None and off.param is not None:
                structural.add(off.param)
            order = op.child
            node = b.LogicalTopN(
                names=list(order.names), types=list(order.types),
                child=order.child, keys=order.keys,
                limit=int(lim.value),
                offset=int(off.value) if off is not None else 0,
            )
            node.dicts = getattr(order, "dicts", [None] * len(order.names))
            return node
    return op


# ---------------- projection pruning ----------------


def prune_columns(op: b.LogicalOp, required: Optional[Set[int]] = None) -> b.LogicalOp:
    """Restrict every LogicalGet to the columns actually used above it."""
    if isinstance(op, b.LogicalGet):
        if required is None:
            required = set(range(len(op.names)))
        used = set(required)
        for fl in op.filters:
            used.update(c.index for c in _cols(fl))
        keep = sorted(used) if used else [0] if op.names else []
        if not op.names:
            return op
        if not keep:
            keep = [0]
        mapping = {old: new for new, old in enumerate(keep)}
        _apply_mapping(op.filters, mapping)
        op.column_ids = [op.column_ids[i] for i in keep]
        new_names = [op.names[i] for i in keep]
        new_types = [op.types[i] for i in keep]
        dicts = getattr(op, "dicts", [None] * len(op.names))
        op.dicts = [dicts[i] for i in keep]
        op.names = new_names
        op.types = new_types
        op._pruned_mapping = mapping
        return op
    if isinstance(op, b.LogicalProject):
        if required is not None and len(required) < len(op.exprs):
            # column-lifetime pruning: drop projection outputs the parent
            # never reads (reorder_joins' order-restoring projections
            # would otherwise keep every base column alive — the round-3
            # "joins carry all 15 lineitem columns" regression)
            keep = sorted(required) or ([0] if op.exprs else [])
            mapping = {old: new for new, old in enumerate(keep)}
            op.exprs = [op.exprs[i] for i in keep]
            op.names = [op.names[i] for i in keep]
            op.types = [op.types[i] for i in keep]
            d = getattr(op, "dicts", None)
            if d is not None:
                op.dicts = [d[i] for i in keep]
            op._pruned_mapping = mapping
        used_child: Set[int] = set()
        for e in op.exprs:
            used_child.update(c.index for c in _cols(e))
        op.child = prune_columns(op.child, used_child)
        mapping = getattr(op.child, "_pruned_mapping", None)
        if mapping:
            _apply_mapping(op.exprs, mapping)
        return op
    if isinstance(op, b.LogicalFilter):
        used: Set[int] = set(required) if required is not None else set(range(len(op.names)))
        used.update(c.index for c in _cols(op.condition))
        op.child = prune_columns(op.child, used)
        mapping = getattr(op.child, "_pruned_mapping", None)
        if mapping:
            _apply_mapping([op.condition], mapping)
            op._pruned_mapping = mapping
            op.names = list(op.child.names)
            op.types = list(op.child.types)
            op.dicts = getattr(op.child, "dicts", [None] * len(op.names))
        return op
    if isinstance(op, b.LogicalAggregate):
        used: Set[int] = set()
        for g in op.groups:
            used.update(c.index for c in _cols(g))
        for a in op.aggregates:
            if a.arg is not None:
                used.update(c.index for c in _cols(a.arg))
        op.child = prune_columns(op.child, used)
        mapping = getattr(op.child, "_pruned_mapping", None)
        if mapping:
            _apply_mapping(list(op.groups) + [a.arg for a in op.aggregates], mapping)
        return op
    if isinstance(op, b.LogicalJoin):
        n_left = len(op.left.names)
        n_right = len(op.right.names)
        if required is None:
            required = set(range(len(op.names)))
        used_l = {i for i in required if i < n_left}
        used_r = {i - n_left for i in required if i >= n_left}
        for le, re_ in op.conditions:
            used_l.update(c.index for c in _cols(le))
            used_r.update(c.index for c in _cols(re_))
        if op.residual is not None:
            for c in _cols(op.residual):
                if c.index < n_left:
                    used_l.add(c.index)
                else:
                    used_r.add(c.index - n_left)
        op.left = prune_columns(op.left, used_l)
        op.right = prune_columns(op.right, used_r)
        ml = getattr(op.left, "_pruned_mapping", None) or {i: i for i in range(n_left)}
        mr = getattr(op.right, "_pruned_mapping", None) or {i: i for i in range(n_right)}
        new_n_left = len(op.left.names)
        _apply_mapping([le for le, _ in op.conditions], ml)
        _apply_mapping([re_ for _, re_ in op.conditions], mr)
        comb = {}
        for old in range(len(op.names)):
            if old < n_left and old in ml:
                comb[old] = ml[old]
            elif old >= n_left and (old - n_left) in mr:
                comb[old] = mr[old - n_left] + new_n_left
        if op.residual is not None:
            # the residual may reference right columns even when they are
            # not join outputs (semi/anti joins): map both sides explicitly
            res_map = dict(ml)
            for j, nj in mr.items():
                res_map[j + n_left] = nj + new_n_left
            _apply_mapping([op.residual], res_map)
        dicts = getattr(op, "dicts", [None] * len(op.names))
        remap_out, new_names, new_types, new_dicts = {}, [], [], []
        for old, new in sorted(comb.items(), key=lambda kv: kv[1]):
            remap_out[old] = len(new_names)
            new_names.append(op.names[old])
            new_types.append(op.types[old])
            new_dicts.append(dicts[old])
        op.names, op.types, op.dicts = new_names, new_types, new_dicts
        op._pruned_mapping = remap_out
        return op
    # default: pass everything through, no pruning across this node
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, b.LogicalOp):
            setattr(op, f.name, prune_columns(v, None))
    return op
