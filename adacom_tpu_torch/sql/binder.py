"""Binder: name resolution, type inference, logical plan construction.

Parity with the reference Binder/Planner (src/planner/binder.cpp,
planner.cpp:28): resolves identifiers against the Catalog, types every
expression, expands stars, extracts aggregates, and emits a LogicalOp tree.
Dates fold at bind time (DATE 'x' +/- INTERVAL 'n' unit), string literals
bind against the target column's dictionary at execution time."""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, List, Optional, Tuple

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.sql import ast
from adacom_tpu_torch.sql import bound as b


class BindError(Exception):
    pass


def days_from_iso(s: str) -> int:
    d = datetime.date.fromisoformat(s.strip())
    return (d - datetime.date(1970, 1, 1)).days


def iso_from_days(days: int) -> str:
    return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))).isoformat()


def add_months(days: int, months: int) -> int:
    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))
    y = d.year + (d.month - 1 + months) // 12
    m = (d.month - 1 + months) % 12 + 1
    # clamp day like Postgres/DuckDB
    last = [31, 29 if y % 4 == 0 and (y % 100 != 0 or y % 400 == 0) else 28,
            31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m - 1]
    return (datetime.date(y, m, min(d.day, last)) - datetime.date(1970, 1, 1)).days


class Interval:
    __slots__ = ("months", "days")

    def __init__(self, months=0, days=0):
        self.months = months
        self.days = days


_INTERVAL_UNITS = {
    "year": ("months", 12), "month": ("months", 1),
    "day": ("days", 1), "week": ("days", 7),
}


class Scope:
    """Flattened name scope over one operator's output schema."""

    def __init__(self):
        self.entries: List[Tuple[Optional[str], str, tt.LogicalType, Any]] = []
        # entries: (table_alias, column_name, type, dictionary)

    @classmethod
    def from_op(cls, op: b.LogicalOp, alias: Optional[str]) -> "Scope":
        s = cls()
        dicts = getattr(op, "dicts", [None] * len(op.names))
        for name, ty, d in zip(op.names, op.types, dicts):
            s.entries.append((alias, name, ty, d))
        return s

    def merge(self, other: "Scope") -> "Scope":
        s = Scope()
        s.entries = self.entries + other.entries
        return s

    def resolve(self, name: str, table: Optional[str]) -> Tuple[int, tt.LogicalType, Any]:
        name_l = name.lower()
        hits = []
        for i, (al, cn, ty, d) in enumerate(self.entries):
            if cn.lower() == name_l and (table is None or (al or "").lower() == table.lower()):
                hits.append((i, ty, d))
        if not hits:
            raise BindError(f"column {table + '.' if table else ''}{name} not found")
        if len(hits) > 1:
            raise BindError(f"ambiguous column reference {name}")
        return hits[0]

    def columns_of(self, table: Optional[str]):
        for i, (al, cn, ty, d) in enumerate(self.entries):
            if table is None or (al or "").lower() == table.lower():
                yield i, cn, ty, d


AGG_FUNCS = {"count", "sum", "avg", "min", "max", "first", "any_value",
             "stddev", "stddev_samp", "var_samp", "variance",
             "approx_count_distinct", "median", "quantile", "quantile_cont",
             "quantile_disc", "bool_and", "bool_or"}

# pure window functions (reference: window function family bound in
# src/planner/binder/expression/bind_window_expression.cpp); AGG_FUNCS are
# also usable with OVER as windowed aggregates
WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "percent_rank",
                "cume_dist", "ntile", "lag", "lead", "first_value",
                "last_value", "nth_value"}


class Binder:
    def __init__(self, catalog, config, cte_plans: Optional[Dict[str, ast.SelectStmt]] = None,
                 outer_scope: Optional[Scope] = None):
        self.catalog = catalog
        self.config = config
        # CTEs are kept as ASTs and re-bound per reference so two uses of the
        # same CTE never share (and never co-mutate) one plan subtree
        self.cte_plans = dict(cte_plans or {})
        # literal slots whose values were baked into the plan (must join the
        # plan-cache key; see sql/parser.parse docstring)
        self.structural: set = set()
        # enclosing query's FROM scope (set for subquery binders); names that
        # fail inner resolution bind as correlated BOuterCol references
        self.outer_scope = outer_scope
        self.uses_outer = False

    # ================= statements =================
    def bind_select(self, stmt: ast.SelectStmt) -> b.LogicalOp:
        if stmt.ctes:
            for name, sub in stmt.ctes:
                self.cte_plans[name.lower()] = sub
        plan = self._bind_select_core(stmt)
        if stmt.set_ops:
            for op, all_, rhs in stmt.set_ops:
                rplan = self._bind_select_core(rhs)
                if len(rplan.types) != len(plan.types):
                    raise BindError("set operation arity mismatch")
                node = b.LogicalSetOp(
                    names=list(plan.names), types=list(plan.types),
                    op=op, all=all_, left=plan, right=rplan,
                )
                node.dicts = getattr(plan, "dicts", [None] * len(plan.names))
                plan = node
        # ORDER BY / LIMIT of the overall statement
        plan = self._bind_order_limit(plan, stmt, over_setop=bool(stmt.set_ops))
        return plan

    def _bind_order_limit(self, plan, stmt, over_setop=False):
        if stmt.order_by and (over_setop or not getattr(stmt, "_order_bound", False)):
            scope = Scope.from_op(plan, None)
            keys = []
            for item in stmt.order_by:
                e = self._bind_order_key(item.expr, plan, scope)
                keys.append((e, item.desc, item.nulls_first))
            node = b.LogicalOrder(names=list(plan.names), types=list(plan.types),
                                  child=plan, keys=keys)
            node.dicts = getattr(plan, "dicts", [None] * len(plan.names))
            plan = node
        if (stmt.limit is not None or stmt.offset is not None) and (
            over_setop or not getattr(stmt, "_limit_bound", False)
        ):
            node = b.LogicalLimit(
                names=list(plan.names), types=list(plan.types), child=plan,
                limit=self._bind_scalar_const(stmt.limit),
                offset=self._bind_scalar_const(stmt.offset),
            )
            node.dicts = getattr(plan, "dicts", [None] * len(plan.names))
            plan = node
        return plan

    def _bind_scalar_const(self, e):
        if e is None:
            return None
        scope = Scope()
        return self.bind_expr(e, scope)

    def _bind_order_key(self, e: ast.Expr, plan: b.LogicalOp, scope: Scope) -> b.BExpr:
        # positional (ORDER BY 1) and output-name references
        if isinstance(e, ast.Literal) and isinstance(e.value, int) and e.type_hint is None:
            if e.param is not None:
                self.structural.add(e.param)
            idx = e.value - 1
            if not (0 <= idx < len(plan.names)):
                raise BindError(f"ORDER BY position {e.value} out of range")
            d = getattr(plan, "dicts", [None] * len(plan.names))[idx]
            return b.BColumn(plan.types[idx], idx, plan.names[idx], d)
        if isinstance(e, ast.ColumnRef) and e.table is None:
            for idx, nm in enumerate(plan.names):
                if nm.lower() == e.name.lower():
                    d = getattr(plan, "dicts", [None] * len(plan.names))[idx]
                    return b.BColumn(plan.types[idx], idx, nm, d)
        return self.bind_expr(e, scope)

    def _bind_select_core(self, stmt: ast.SelectStmt) -> b.LogicalOp:
        # FROM
        if stmt.from_ref is None:
            child = b.LogicalValues(names=[], types=[], rows=[[]])
            child.dicts = []
            scope = Scope()
        else:
            child, scope = self.bind_table_ref(stmt.from_ref)

        # WHERE
        if stmt.where is not None:
            cond = self.bind_expr(stmt.where, scope)
            node = b.LogicalFilter(names=list(child.names), types=list(child.types),
                                   child=child, condition=cond)
            node.dicts = getattr(child, "dicts", [None] * len(child.names))
            child = node

        # expand stars in select list
        sel_items: List[Tuple[ast.Expr, Optional[str]]] = []
        for e, alias in stmt.select_list:
            if isinstance(e, ast.Star):
                for i, cn, ty, d in scope.columns_of(e.table):
                    sel_items.append((ast.ColumnRef(cn, e.table), cn))
            else:
                sel_items.append((e, alias))

        # aggregate detection
        has_agg = stmt.group_by is not None or any(
            self._contains_agg(e) for e, _ in sel_items
        ) or (stmt.having is not None)
        has_window = any(self._contains_window(e) for e, _ in sel_items)

        if has_agg:
            plan = self._bind_aggregate(stmt, sel_items, child, scope)
        else:
            names = [alias or self._expr_name(e) for e, alias in sel_items]
            if has_window:
                wcalls: List[ast.FuncCall] = []
                sel_items = [(self._rewrite_windows(e, wcalls), a)
                             for e, a in sel_items]
                windows = [
                    self._bind_window_func(w, lambda x: self.bind_expr(x, scope))
                    for w in wcalls
                ]
                wnames = list(child.names) + [f"__win{i}" for i in range(len(windows))]
                wtypes = list(child.types) + [w.ty for w in windows]
                wnode = b.LogicalWindow(names=wnames, types=wtypes,
                                        child=child, windows=windows)
                wdicts = [self._window_dict(w) for w in windows]
                wnode.dicts = getattr(child, "dicts", [None] * len(child.names)) + wdicts
                child = wnode
                ext = Scope()
                ext.entries = list(scope.entries) + [
                    (None, f"__win{i}", w.ty, d)
                    for i, (w, d) in enumerate(zip(windows, wdicts))
                ]
                scope = ext
            exprs = []
            for e, alias in sel_items:
                exprs.append(self.bind_expr(e, scope))
            plan = b.LogicalProject(
                names=names, types=[e.ty for e in exprs], child=child, exprs=exprs
            )
            plan.dicts = [self._expr_dict(e) for e in exprs]

        if stmt.distinct:
            node = b.LogicalDistinct(names=list(plan.names), types=list(plan.types), child=plan)
            node.dicts = getattr(plan, "dicts", [None] * len(plan.names))
            plan = node

        # ORDER BY / LIMIT (when not a set-op; those are handled one level up)
        if not stmt.set_ops:
            plan = self._bind_order_limit_inner(plan, stmt, scope)
        return plan

    def _bind_order_limit_inner(self, plan, stmt, input_scope):
        if stmt.order_by:
            scope = Scope.from_op(plan, None)
            keys = []
            n_visible = len(plan.names)
            hidden = 0
            for item in stmt.order_by:
                try:
                    e = self._bind_order_key(item.expr, plan, scope)
                except BindError:
                    # bind over the pre-projection input and carry the key as
                    # a hidden projection column (dropped after the sort);
                    # aggregate selects expose their post-agg binder so
                    # ORDER BY COUNT(*) / grouped expressions resolve
                    if not isinstance(plan, b.LogicalProject):
                        raise
                    pab = getattr(plan, "_post_agg_binder", None)
                    if pab is not None:
                        be = pab(item.expr)
                    else:
                        be = self.bind_expr(item.expr, input_scope)
                    plan.exprs.append(be)
                    plan.names.append(f"__order_{hidden}")
                    plan.types.append(be.ty)
                    plan.dicts = getattr(plan, "dicts", [None] * n_visible) + [self._expr_dict(be)]
                    e = b.BColumn(be.ty, len(plan.names) - 1, plan.names[-1],
                                  self._expr_dict(be))
                    hidden += 1
                keys.append((e, item.desc, item.nulls_first))
            node = b.LogicalOrder(names=list(plan.names), types=list(plan.types),
                                  child=plan, keys=keys)
            node.dicts = getattr(plan, "dicts", [None] * len(plan.names))
            plan = node
            if hidden:
                exprs = [
                    b.BColumn(plan.types[i], i, plan.names[i],
                              getattr(plan, "dicts")[i])
                    for i in range(n_visible)
                ]
                drop = b.LogicalProject(
                    names=list(plan.names[:n_visible]),
                    types=list(plan.types[:n_visible]),
                    child=plan, exprs=exprs,
                )
                drop.dicts = getattr(plan, "dicts")[:n_visible]
                plan = drop
        if stmt.limit is not None or stmt.offset is not None:
            node = b.LogicalLimit(
                names=list(plan.names), types=list(plan.types), child=plan,
                limit=self._bind_scalar_const(stmt.limit),
                offset=self._bind_scalar_const(stmt.offset),
            )
            node.dicts = getattr(plan, "dicts", [None] * len(plan.names))
            plan = node
        stmt._order_bound = True
        stmt._limit_bound = True
        return plan

    # ---------------- aggregate binding ----------------
    def _contains_agg(self, e: ast.Expr) -> bool:
        if isinstance(e, ast.FuncCall) and e.name in AGG_FUNCS and e.over is None:
            return True
        if isinstance(e, ast.FuncCall) and e.over is not None:
            # aggregates may appear inside the window's own expressions
            # (rank() OVER (ORDER BY sum(x)))
            for p in e.over.partition_by:
                if self._contains_agg(p):
                    return True
            for it in e.over.order_by:
                if self._contains_agg(it.expr):
                    return True
        for f in e.__dataclass_fields__:
            v = getattr(e, f)
            if isinstance(v, ast.Expr) and self._contains_agg(v):
                return True
            if isinstance(v, list):
                for x in v:
                    if isinstance(x, ast.Expr) and self._contains_agg(x):
                        return True
                    if isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, ast.Expr) and self._contains_agg(y):
                                return True
        return False

    def _bind_aggregate(self, stmt, sel_items, child, scope) -> b.LogicalOp:
        # windows over aggregate output (rank() OVER (ORDER BY sum(x))):
        # rewrite window calls to __winN sentinels first; their inner
        # expressions bind post-aggregate below, and a LogicalWindow node is
        # inserted between the aggregate (+HAVING) and the final projection
        wcalls: List[ast.FuncCall] = []
        if any(self._contains_window(e) for e, _ in sel_items):
            names_pre = [alias or self._expr_name(e) for e, alias in sel_items]
            sel_items = [
                (self._rewrite_windows(e, wcalls), alias or names_pre[i])
                for i, (e, alias) in enumerate(sel_items)
            ]
        group_bexprs: List[b.BExpr] = []
        group_names: List[str] = []
        if stmt.group_by:
            for ge in stmt.group_by:
                # positional group ref / select alias
                resolved = None
                if isinstance(ge, ast.Literal) and isinstance(ge.value, int) and ge.type_hint is None:
                    if ge.param is not None:
                        self.structural.add(ge.param)
                    idx = ge.value - 1
                    if not (0 <= idx < len(sel_items)):
                        raise BindError("GROUP BY position out of range")
                    resolved = sel_items[idx][0]
                elif isinstance(ge, ast.ColumnRef) and ge.table is None:
                    for e, alias in sel_items:
                        if alias and alias.lower() == ge.name.lower() and not isinstance(e, ast.ColumnRef):
                            resolved = e
                            break
                resolved = resolved if resolved is not None else ge
                try:
                    be = self.bind_expr(resolved, scope)
                except BindError:
                    # alias of a plain column ref (GROUP BY Dst where the
                    # select list has URL AS Dst): real columns win above,
                    # but a pure alias must still resolve
                    if isinstance(ge, ast.ColumnRef) and ge.table is None:
                        hit = next(
                            (e for e, alias in sel_items
                             if alias and alias.lower() == ge.name.lower()),
                            None)
                        if hit is None:
                            raise
                        resolved = hit
                        be = self.bind_expr(resolved, scope)
                    else:
                        raise
                group_bexprs.append(be)
                group_names.append(self._expr_name(resolved))

        aggs: List[b.BoundAggregate] = []

        bound_windows: List[Optional[b.BoundWindow]] = [None] * len(wcalls)

        def bind_post_agg(e: ast.Expr) -> b.BExpr:
            # window sentinel: negative marker index, patched to the
            # LogicalWindow output position once the agg schema is final
            if isinstance(e, ast.ColumnRef) and e.table is None and \
                    e.name.startswith("__win") and e.name[5:].isdigit():
                wi = int(e.name[5:])
                if wi < len(wcalls):
                    if bound_windows[wi] is None:
                        bound_windows[wi] = self._bind_window_func(
                            wcalls[wi], bind_post_agg)
                    return b.BColumn(bound_windows[wi].ty, -(wi + 1),
                                     e.name, self._window_dict(bound_windows[wi]))
            # group expr match (structural, on the AST via bound comparison)
            be_try = None
            try:
                be_try = self.bind_expr(e, scope)
            except BindError:
                be_try = None
            if be_try is not None:
                for gi, g in enumerate(group_bexprs):
                    slots: list = []
                    if _bexpr_eq(be_try, g, slots):
                        # literals matched by value across different slots:
                        # their values shaped the plan -> structural
                        for pa, pb in slots:
                            if pa is not None:
                                self.structural.add(pa)
                            if pb is not None:
                                self.structural.add(pb)
                        return b.BColumn(g.ty, gi, group_names[gi], self._expr_dict(g))
            if isinstance(e, ast.FuncCall) and e.name in AGG_FUNCS:
                agg = self._bind_agg_func(e, scope)
                # dedup identical aggregates
                for ai, a in enumerate(aggs):
                    if a.func == agg.func and a.distinct == agg.distinct and \
                       ((a.arg is None and agg.arg is None) or
                            (a.arg is not None and agg.arg is not None and _bexpr_eq(a.arg, agg.arg))):
                        return b.BAggRef(a.ty, len(group_bexprs) + ai,
                                         a.dictionary)
                aggs.append(agg)
                return b.BAggRef(agg.ty, len(group_bexprs) + len(aggs) - 1,
                                 agg.dictionary)
            # recurse: rebuild node with post-agg children
            if isinstance(e, ast.BinaryOp):
                l = bind_post_agg(e.left)
                r = bind_post_agg(e.right)
                return self._type_binary(e.op, l, r)
            if isinstance(e, ast.UnaryOp):
                o = bind_post_agg(e.operand)
                return b.BUnary(o.ty if e.op == "-" else tt.BOOLEAN, e.op, o)
            if isinstance(e, ast.Cast):
                o = bind_post_agg(e.operand)
                return b.BCast(tt.type_from_name(e.type_name, e.type_args), o)
            if isinstance(e, ast.Case):
                whens = []
                for c, v in self._case_pairs(e):
                    whens.append((bind_post_agg(c), bind_post_agg(v)))
                el = bind_post_agg(e.else_) if e.else_ is not None else None
                ty = whens[0][1].ty if whens else (el.ty if el else tt.INTEGER)
                return b.BCase(ty, whens, el)
            if isinstance(e, ast.Literal):
                return self._bind_literal(e)
            if isinstance(e, (ast.ScalarSubquery, ast.Exists, ast.InSubquery)):
                # e.g. HAVING sum(x) > (SELECT ...): the subquery binds as a
                # plain expression (its own binder handles internal aggs)
                return self.bind_expr(e, scope)
            if be_try is not None:
                # plain column not in GROUP BY
                raise BindError(
                    f"column {self._expr_name(e)} must appear in GROUP BY or an aggregate"
                )
            raise BindError(f"cannot bind expression in aggregate context: {e}")

        out_exprs: List[b.BExpr] = []
        out_names: List[str] = []
        for e, alias in sel_items:
            out_exprs.append(bind_post_agg(e))
            out_names.append(alias or self._expr_name(e))

        having_b = None
        if stmt.having is not None:
            having_b = bind_post_agg(stmt.having)

        agg_names = group_names + [a.func for a in aggs]
        agg_types = [g.ty for g in group_bexprs] + [a.ty for a in aggs]
        agg_node = b.LogicalAggregate(
            names=agg_names, types=agg_types, child=child,
            groups=group_bexprs, aggregates=aggs,
        )
        agg_node.dicts = [self._expr_dict(g) for g in group_bexprs] + \
            [a.dictionary for a in aggs]
        plan: b.LogicalOp = agg_node

        if having_b is not None:
            node = b.LogicalFilter(names=list(plan.names), types=list(plan.types),
                                   child=plan, condition=having_b)
            node.dicts = getattr(plan, "dicts")
            plan = node

        if wcalls:
            windows = [w for w in bound_windows if w is not None]
            if len(windows) != len(bound_windows):
                raise BindError("window function bound outside select list")
            agg_width = len(plan.names)
            wnames = list(plan.names) + [f"__win{i}" for i in range(len(windows))]
            wtypes = list(plan.types) + [w.ty for w in windows]
            wnode = b.LogicalWindow(names=wnames, types=wtypes,
                                    child=plan, windows=windows)
            wnode.dicts = getattr(plan, "dicts") + [
                self._window_dict(w) for w in windows
            ]
            plan = wnode
            # patch sentinel indices (negative markers) to window positions
            for e in out_exprs:
                for x in b.expr_walk(e):
                    if isinstance(x, b.BColumn) and x.index < 0:
                        x.index = agg_width + (-x.index - 1)

        proj = b.LogicalProject(
            names=out_names, types=[e.ty for e in out_exprs], child=plan, exprs=out_exprs
        )
        proj.dicts = [self._expr_dict(e) for e in out_exprs]

        if not wcalls:
            # let ORDER BY bind aggregate / grouped expressions that are
            # not select outputs (ClickBench "ORDER BY COUNT(*) DESC"):
            # new aggregates append to agg_node in place
            def late_bind(e_ast):
                n_before = len(aggs)
                be = bind_post_agg(e_ast)
                for a in aggs[n_before:]:
                    agg_node.names.append(a.func)
                    agg_node.types.append(a.ty)
                    agg_node.dicts.append(a.dictionary)
                return be

            proj._post_agg_binder = late_bind
        return proj

    def _case_pairs(self, e: ast.Case):
        if e.operand is None:
            return list(e.whens)
        return [(ast.BinaryOp("=", e.operand, c), v) for c, v in e.whens]

    def _bind_agg_func(self, e: ast.FuncCall, scope: Scope) -> b.BoundAggregate:
        name = e.name
        if name == "count":
            if e.star or not e.args:
                return b.BoundAggregate("count_star", None, tt.BIGINT)
            arg = self.bind_expr(e.args[0], scope)
            return b.BoundAggregate("count", arg, tt.BIGINT, e.distinct)
        if not e.args:
            raise BindError(f"aggregate {name} requires an argument")
        arg = self.bind_expr(e.args[0], scope)
        if name == "sum":
            if arg.ty.is_float:
                ty = tt.DOUBLE
            elif arg.ty.name == "DECIMAL":
                ty = tt.DECIMAL(38, arg.ty.scale)
            else:
                ty = tt.BIGINT
            return b.BoundAggregate("sum", arg, ty, e.distinct)
        if name == "avg":
            return b.BoundAggregate("avg", arg, tt.DOUBLE, e.distinct)
        if name in ("min", "max", "first", "any_value"):
            fn = name if name in ("min", "max") else "first"
            d = self._expr_dict(arg)
            if d is None:
                return b.BoundAggregate(fn, arg, arg.ty)
            if fn == "first":
                return b.BoundAggregate(fn, arg, arg.ty, dictionary=d)
            # MIN/MAX over VARCHAR: dictionary codes are insertion-ordered,
            # so aggregate over the code's lexicographic RANK and attach a
            # sorted dictionary — rank IS the output code (reference:
            # string min/max compare string_t values; here order lives in
            # the rank permutation)
            import numpy as np

            from adacom_tpu_torch.storage.table import StringDictionary

            rank = d.rank_array()
            strs = d.strings_array()
            sorted_dict = StringDictionary()
            for s_ in strs[np.argsort(strs, kind="stable")]:
                sorted_dict.encode_one(str(s_))
            ranked = b.BDictMap(arg.ty, arg, rank.astype(np.uint32),
                                sorted_dict)
            return b.BoundAggregate(fn, ranked, arg.ty,
                                    dictionary=sorted_dict)
        if name in ("stddev", "stddev_samp", "var_samp", "variance"):
            return b.BoundAggregate(name, arg, tt.DOUBLE)
        if name == "approx_count_distinct":
            # HyperLogLog (reference third_party/hyperloglog + approx_count
            # aggregate, src/function/aggregate/distributive/approx_count.cpp)
            return b.BoundAggregate("approx_count_distinct", arg, tt.BIGINT)
        if name in ("median", "quantile", "quantile_cont", "quantile_disc"):
            # holistic quantiles (reference tdigest-backed quantile,
            # src/function/aggregate/holistic/quantile.cpp); here computed
            # exactly by per-group sorted selection
            if name == "median":
                q = 0.5
            else:
                if len(e.args) < 2 or not isinstance(e.args[1], ast.Literal):
                    raise BindError(f"{name}(x, q) needs a literal quantile")
                q = float(e.args[1].value)
                if not 0.0 <= q <= 1.0:
                    raise BindError("quantile must be in [0, 1]")
            interp = "disc" if name == "quantile_disc" else "cont"
            ty = arg.ty if interp == "disc" else tt.DOUBLE
            return b.BoundAggregate(f"quantile_{interp}:{q}", arg, ty)
        if name in ("bool_and", "bool_or"):
            return b.BoundAggregate(name, arg, tt.BOOLEAN)
        raise BindError(f"unknown aggregate {name}")

    # ---------------- window binding ----------------
    def _contains_window(self, e: ast.Expr) -> bool:
        if isinstance(e, ast.FuncCall) and e.over is not None:
            return True
        for f in e.__dataclass_fields__:
            v = getattr(e, f)
            if isinstance(v, ast.Expr) and self._contains_window(v):
                return True
            if isinstance(v, list):
                for x in v:
                    if isinstance(x, ast.Expr) and self._contains_window(x):
                        return True
                    if isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, ast.Expr) and self._contains_window(y):
                                return True
        return False

    def _rewrite_windows(self, e: ast.Expr, wcalls: List[ast.FuncCall]) -> ast.Expr:
        """Replace every window FuncCall with a `__winN` column sentinel,
        collecting the calls (deduplicated) into wcalls."""
        if isinstance(e, ast.FuncCall) and e.over is not None:
            for i, w in enumerate(wcalls):
                if w == e:
                    return ast.ColumnRef(f"__win{i}")
            wcalls.append(e)
            return ast.ColumnRef(f"__win{len(wcalls) - 1}")
        if not isinstance(e, ast.Expr):
            return e
        kw = {}
        changed = False
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            nv = v
            if isinstance(v, ast.Expr):
                nv = self._rewrite_windows(v, wcalls)
            elif isinstance(v, list):
                nl = []
                lchanged = False
                for x in v:
                    if isinstance(x, ast.Expr):
                        nx = self._rewrite_windows(x, wcalls)
                    elif isinstance(x, tuple):
                        nx = tuple(
                            self._rewrite_windows(y, wcalls)
                            if isinstance(y, ast.Expr) else y
                            for y in x
                        )
                    else:
                        nx = x
                    lchanged = lchanged or (nx is not x)
                    nl.append(nx)
                if lchanged:
                    nv = nl
            if nv is not v:
                changed = True
            kw[f.name] = nv
        return dataclasses.replace(e, **kw) if changed else e

    def _bind_window_func(self, e: ast.FuncCall, bind_scalar) -> b.BoundWindow:
        spec: ast.WindowSpec = e.over
        name = e.name
        if name not in WINDOW_FUNCS and name not in AGG_FUNCS:
            raise BindError(f"unknown window function {name}")
        args = [] if e.star else [bind_scalar(a) for a in e.args]
        partitions = [bind_scalar(p) for p in spec.partition_by]
        order_keys = [
            (bind_scalar(it.expr), it.desc, it.nulls_first)
            for it in spec.order_by
        ]
        if name in ("row_number", "rank", "dense_rank", "ntile", "count"):
            ty = tt.BIGINT
        elif name in ("percent_rank", "cume_dist", "avg", "stddev",
                      "stddev_samp", "var_samp", "variance"):
            ty = tt.DOUBLE
        elif name in ("lag", "lead", "first_value", "last_value", "nth_value",
                      "min", "max", "first", "any_value"):
            if not args:
                raise BindError(f"window function {name} requires an argument")
            ty = args[0].ty
        elif name == "sum":
            if not args:
                raise BindError("sum requires an argument")
            if args[0].ty.is_float:
                ty = tt.DOUBLE
            elif args[0].ty.name == "DECIMAL":
                ty = tt.DECIMAL(38, args[0].ty.scale)
            else:
                ty = tt.BIGINT
        else:
            raise BindError(f"unsupported window function {name}")
        if name in ("ntile", "lag", "lead", "nth_value"):
            # offset/bucket arguments shape the computation: constants only
            for a in args[1:] if name != "ntile" else args[:1]:
                if not isinstance(a, b.BLiteral):
                    raise BindError(f"{name} offset must be a constant")
                if a.param is not None:
                    self.structural.add(a.param)
        frame = spec.frame
        if frame is not None and frame[0] == "range":
            for bound in frame[1:]:
                if bound[0] in ("preceding", "following"):
                    raise BindError(
                        "RANGE frames with value offsets are not supported")
        return b.BoundWindow(name, args, ty, partitions, order_keys, frame)

    def _window_dict(self, w: b.BoundWindow):
        if w.func in ("lag", "lead", "first_value", "last_value", "nth_value",
                      "min", "max", "first", "any_value") and w.args:
            return self._expr_dict(w.args[0])
        return None

    # ================= table refs =================
    def bind_table_ref(self, ref: ast.TableRef) -> Tuple[b.LogicalOp, Scope]:
        if isinstance(ref, ast.ValuesRef):
            # (VALUES (..), (..)) AS v — columns named col0..colN
            # (reference: Connection::Values / value_relation.cpp)
            rows_b = [[self.bind_expr(e, Scope()) for e in row]
                      for row in ref.rows]
            if not rows_b or any(len(r) != len(rows_b[0]) for r in rows_b):
                raise BindError("VALUES rows must be non-empty and aligned")
            types = []
            for ci in range(len(rows_b[0])):
                ty = None
                for r in rows_b:
                    e = r[ci]
                    if not (isinstance(e, b.BLiteral) and e.value is None):
                        ty = e.ty if ty is None else tt.common_type(ty, e.ty)
                types.append(ty or tt.INTEGER)
            names = [f"col{ci}" for ci in range(len(rows_b[0]))]
            # VARCHAR columns dictionary-encode at bind time (string
            # literal values are baked -> structural), so downstream
            # operators see ordinary dict-coded columns
            from adacom_tpu_torch.storage.table import StringDictionary

            dicts = []
            for ci, ty in enumerate(types):
                if not (ty is not None and ty.is_string):
                    dicts.append(None)
                    continue
                d = StringDictionary()
                for r in rows_b:
                    e = r[ci]
                    if not isinstance(e, b.BLiteral):
                        raise BindError("VALUES cells must be literals")
                    if e.value is None:
                        continue
                    if e.param is not None:
                        self.structural.add(e.param)
                    r[ci] = b.BLiteral(tt.VARCHAR,
                                       d.encode_one(str(e.value)))
                dicts.append(d)
            node = b.LogicalValues(names=names, types=types, rows=rows_b)
            node.dicts = dicts
            alias = ref.alias or "values"
            return node, Scope.from_op(node, alias)
        if isinstance(ref, ast.SampleRef):
            child, scope = self.bind_table_ref(ref.ref)
            amt = ref.amount
            if not (isinstance(amt, ast.Literal)
                    and isinstance(amt.value, (int, float))):
                raise BindError("SAMPLE amount must be a numeric literal")
            if amt.param is not None:
                self.structural.add(amt.param)
            node = b.LogicalSample(
                names=list(child.names), types=list(child.types),
                child=child, amount=int(amt.value),
                is_percent=ref.is_percent)
            node.dicts = getattr(child, "dicts", [None] * len(child.names))
            return node, scope
        if isinstance(ref, ast.BaseTable):
            key = ref.name.lower()
            alias = ref.alias or ref.name
            if key in self.cte_plans:
                # re-bind the CTE body per reference: no shared plan subtrees
                sub = Binder(self.catalog, self.config, self.cte_plans)
                plan = sub.bind_select(self.cte_plans[key])
                self.structural |= sub.structural
                return plan, Scope.from_op(plan, alias)
            view_sql = self.catalog.get_view(key)
            if view_sql is not None:
                from adacom_tpu_torch.sql.parser import parse

                stmts, _, _, _ = parse(view_sql)
                # the view body has its own literal numbering; bake its
                # literal values (outer-query lits must not leak in)
                _strip_literal_params(stmts[0])
                plan = self.bind_select(stmts[0])
                return plan, Scope.from_op(plan, alias)
            table = self.catalog.get_table(key)
            names = list(table.column_order)
            types = [table.columns[c].ltype for c in names]
            plan = b.LogicalGet(
                names=names, types=types, table=table, table_name=key,
                column_ids=list(names),
            )
            plan.dicts = [table.columns[c].dictionary for c in names]
            return plan, Scope.from_op(plan, alias)
        if isinstance(ref, ast.SubqueryRef):
            plan = self.bind_select(ref.subquery)
            return plan, Scope.from_op(plan, ref.alias)
        if isinstance(ref, ast.TableFunctionRef):
            return self._bind_table_function(ref)
        if isinstance(ref, ast.JoinRef):
            return self._bind_join(ref)
        raise BindError(f"unsupported table ref {ref}")

    def _bind_table_function(self, ref: ast.TableFunctionRef):
        """Table functions in FROM (reference src/function/table/: `range`
        at range.cpp, `read_csv`/`read_csv_auto` at read_csv.cpp). The
        function output materializes into an anonymous in-memory table so
        every scan path (zonemaps, codecs, fused kernels) applies."""
        import numpy as np

        name = ref.name.lower()
        alias = ref.alias or name
        args = []
        for a in ref.args or []:
            if not isinstance(a, ast.Literal):
                raise BindError("table function arguments must be literals")
            v = a.value
            args.append(v.strip("'\"") if isinstance(v, str) else v)
        if name == "range":
            if not 1 <= len(args) <= 3:
                raise BindError("range(start, stop[, step])")
            vals = np.arange(*[int(x) for x in args], dtype=np.int64)
            return self._anon_table_plan(
                alias, ["range"], [tt.BIGINT], [vals], [None])
        if name in ("read_csv", "read_csv_auto"):
            from adacom_tpu_torch.io import csv_io

            if not args:
                raise BindError("read_csv(path)")
            header = args[1] if len(args) > 1 else None
            if isinstance(header, str):
                header = header.lower() == "true"
            names, types, cols, valids = csv_io.read_csv(str(args[0]),
                                                         header=header)
            if not names:
                raise BindError(f"empty CSV: {args[0]}")
            return self._anon_table_plan(alias, names, types, cols, valids)
        if name in ("read_parquet", "parquet_scan"):
            from adacom_tpu_torch.io import parquet_io

            if not args:
                raise BindError("read_parquet(path)")
            names, types, cols, valids = parquet_io.read_parquet(str(args[0]))
            if not names:
                raise BindError(f"empty parquet file: {args[0]}")
            return self._anon_table_plan(alias, names, types, cols, valids)
        if name in ("read_json", "read_json_auto", "read_ndjson"):
            from adacom_tpu_torch.io import json_io

            if not args:
                raise BindError("read_json(path)")
            names, types, cols, valids = json_io.read_json(str(args[0]))
            if not names:
                raise BindError(f"empty JSON file: {args[0]}")
            return self._anon_table_plan(alias, names, types, cols, valids)
        raise BindError(f"unknown table function {ref.name!r}")

    def _anon_table_plan(self, alias, names, types, cols, valids):
        from adacom_tpu_torch.storage.table import Table

        lower = [n.lower() for n in names]
        table = Table(alias.lower(), list(zip(lower, types)), self.config,
                      self.catalog.bm, self.catalog.segment_catalog)
        validity = {n: v for n, v in zip(lower, valids) if v is not None}
        table.append_batch(dict(zip(lower, cols)), validity or None)
        table.flush()
        plan = b.LogicalGet(
            names=lower, types=list(types), table=table,
            table_name=table.name, column_ids=list(lower),
        )
        plan.dicts = [table.columns[c].dictionary for c in lower]
        return plan, Scope.from_op(plan, alias)

    def _bind_join(self, ref: ast.JoinRef) -> Tuple[b.LogicalOp, Scope]:
        lplan, lscope = self.bind_table_ref(ref.left)
        rplan, rscope = self.bind_table_ref(ref.right)
        combined = lscope.merge(rscope)
        n_left = len(lscope.entries)

        conditions: List[Tuple[b.BExpr, b.BExpr]] = []
        residual: Optional[b.BExpr] = None

        def side_of(e: b.BExpr) -> Optional[str]:
            idxs = [x.index for x in b.expr_walk(e) if isinstance(x, b.BColumn)]
            if not idxs:
                return None
            if all(i < n_left for i in idxs):
                return "left"
            if all(i >= n_left for i in idxs):
                return "right"
            return "both"

        def shift_right(e: b.BExpr) -> b.BExpr:
            for x in b.expr_walk(e):
                if isinstance(x, b.BColumn):
                    x.index -= n_left
            return e

        cond_expr = None
        if ref.using:
            conds = []
            for cname in ref.using:
                conds.append(ast.BinaryOp(
                    "=", ast.ColumnRef(cname, None), ast.ColumnRef(cname, None)
                ))
            # resolve each side explicitly
            for cname in ref.using:
                li, lty, ld = lscope.resolve(cname, None)
                ri, rty, rd = rscope.resolve(cname, None)
                conditions.append((
                    b.BColumn(lty, li, cname, ld),
                    b.BColumn(rty, ri, cname, rd),
                ))
        elif ref.condition is not None:
            cond_expr = self.bind_expr(ref.condition, combined)
            # split conjuncts into equi pairs + residual
            for conj in _split_conjuncts(cond_expr):
                if isinstance(conj, b.BBinary) and conj.op == "=":
                    sl, sr = side_of(conj.left), side_of(conj.right)
                    if sl == "left" and sr == "right":
                        conditions.append((conj.left, shift_right(conj.right)))
                        continue
                    if sl == "right" and sr == "left":
                        conditions.append((conj.right, shift_right(conj.left)))
                        continue
                residual = conj if residual is None else b.BBinary(tt.BOOLEAN, "and", residual, conj)
        elif ref.join_type != "cross":
            raise BindError("JOIN requires ON or USING")

        names = [e[1] for e in combined.entries]
        types = [e[2] for e in combined.entries]
        node = b.LogicalJoin(
            names=names, types=types, left=lplan, right=rplan,
            join_type=ref.join_type, conditions=conditions, residual=residual,
        )
        node.dicts = [e[3] for e in combined.entries]
        return node, combined

    # ================= expressions =================
    def bind_expr(self, e: ast.Expr, scope: Scope) -> b.BExpr:
        if isinstance(e, ast.Literal):
            return self._bind_literal(e)
        if isinstance(e, ast.ColumnRef):
            try:
                i, ty, d = scope.resolve(e.name, e.table)
            except BindError:
                if self.outer_scope is None:
                    raise
                i, ty, d = self.outer_scope.resolve(e.name, e.table)
                self.uses_outer = True
                return b.BOuterCol(ty, i, e.name, d)
            return b.BColumn(ty, i, e.name, d)
        if isinstance(e, ast.BinaryOp):
            l = self.bind_expr(e.left, scope)
            r = self.bind_expr(e.right, scope)
            return self._type_binary(e.op, l, r)
        if isinstance(e, ast.UnaryOp):
            o = self.bind_expr(e.operand, scope)
            if e.op == "-":
                if isinstance(o, b.BLiteral) and o.param is None and isinstance(o.value, (int, float)):
                    return b.BLiteral(o.ty, -o.value)
                return b.BUnary(o.ty, "-", o)
            return b.BUnary(tt.BOOLEAN, "not", o)
        if isinstance(e, ast.IsNull):
            return b.BIsNull(tt.BOOLEAN, self.bind_expr(e.operand, scope), e.negated)
        if isinstance(e, ast.Between):
            o = self.bind_expr(e.operand, scope)
            lo = self.bind_expr(e.low, scope)
            hi = self.bind_expr(e.high, scope)
            ge = self._type_binary(">=", o, lo)
            le = self._type_binary("<=", o, hi)
            both = b.BBinary(tt.BOOLEAN, "and", ge, le)
            return b.BUnary(tt.BOOLEAN, "not", both) if e.negated else both
        if isinstance(e, ast.InList):
            o = self.bind_expr(e.operand, scope)
            items = [self.bind_expr(x, scope) for x in e.items]
            return b.BInList(tt.BOOLEAN, o, items, e.negated)
        if isinstance(e, ast.Like):
            o = self.bind_expr(e.operand, scope)
            pat = self.bind_expr(e.pattern, scope)
            if not isinstance(pat, b.BLiteral):
                raise BindError("LIKE pattern must be a literal")
            dict_ = self._expr_dict(o)
            if dict_ is None:
                raise BindError("LIKE requires a VARCHAR column")
            return b.BDictPredicate(tt.BOOLEAN, o, "like", pat, e.negated,
                                    e.case_insensitive, dict_)
        if isinstance(e, ast.Case):
            whens = [(self.bind_expr(c, scope), self.bind_expr(v, scope))
                     for c, v in self._case_pairs(e)]
            el = self.bind_expr(e.else_, scope) if e.else_ is not None else None
            ty = None
            for _, v in whens:
                if not (isinstance(v, b.BLiteral) and v.value is None):
                    ty = v.ty if ty is None else tt.common_type(ty, v.ty)
            if el is not None and not (isinstance(el, b.BLiteral) and el.value is None):
                ty = el.ty if ty is None else tt.common_type(ty, el.ty)
            if ty is not None and ty.is_string:
                # string-valued CASE: dictionary-encode literal branches so
                # the runtime works on uint32 codes (reference: strings are
                # first-class; here dictionaries are the string substrate)
                from adacom_tpu_torch.storage.table import StringDictionary

                vals = [v for _, v in whens] + ([el] if el is not None else [])
                col_dicts = []
                for v in vals:
                    if isinstance(v, b.BLiteral) and (
                            v.value is None or isinstance(v.value, str)):
                        continue
                    vd = self._expr_dict(v)
                    if vd is None:
                        raise BindError(
                            "string CASE branches must be literals, NULL, "
                            "or VARCHAR columns")
                    col_dicts.append(vd)
                uniq_dicts = list({id(x): x for x in col_dicts}.values())
                if len(uniq_dicts) > 1:
                    raise BindError(
                        "string CASE branches must share one dictionary")
                if uniq_dicts:
                    # column branch(es): extend a COPY of the source
                    # dictionary with the literal strings — the source's
                    # codes stay valid, literals get appended codes
                    # (ClickBench q40: CASE WHEN .. THEN Referer ELSE '')
                    src = uniq_dicts[0]
                    d = StringDictionary()
                    for s_ in src.strings_array():
                        d.encode_one(str(s_))
                else:
                    d = StringDictionary()

                def enc(v):
                    if v is None:
                        return v
                    if not isinstance(v, b.BLiteral):
                        return v  # dict-coded column branch: codes valid in d
                    if v.value is None:
                        return v
                    if v.param is not None:
                        # the string's value is baked into the dictionary:
                        # the plan must key on it
                        self.structural.add(v.param)
                    return b.BLiteral(tt.VARCHAR, d.encode_one(str(v.value)))

                whens = [(c, enc(v)) for c, v in whens]
                el = enc(el)
                return b.BCase(ty, whens, el, dictionary=d)
            return b.BCase(ty or tt.INTEGER, whens, el)
        if isinstance(e, ast.Cast):
            o = self.bind_expr(e.operand, scope)
            ty = tt.type_from_name(e.type_name, e.type_args)
            if isinstance(o, b.BLiteral) and o.param is None and ty is tt.DATE and isinstance(o.value, str):
                return b.BLiteral(tt.DATE, days_from_iso(o.value))
            return b.BCast(ty, o)
        if isinstance(e, ast.FuncCall):
            if e.name in AGG_FUNCS:
                raise BindError(f"aggregate {e.name} not allowed here")
            args = [self.bind_expr(a, scope) for a in e.args]
            return self._bind_scalar_func(e.name, args)
        if isinstance(e, ast.ScalarSubquery):
            plan, corr = self._bind_subplan(e.subquery, scope)
            if len(plan.types) != 1:
                raise BindError("scalar subquery must return one column")
            return b.BSubquery(plan.types[0], plan=plan, kind="scalar",
                               correlated=corr)
        if isinstance(e, ast.Exists):
            plan, corr = self._bind_subplan(e.subquery, scope)
            return b.BSubquery(tt.BOOLEAN, plan=plan, kind="exists",
                               negated=e.negated, correlated=corr)
        if isinstance(e, ast.InSubquery):
            operand = self.bind_expr(e.operand, scope)
            plan, corr = self._bind_subplan(e.subquery, scope)
            if len(plan.types) != 1:
                raise BindError("IN subquery must return one column")
            return b.BSubquery(tt.BOOLEAN, plan=plan, kind="in",
                               operand=operand, negated=e.negated,
                               correlated=corr)
        raise BindError(f"cannot bind {e}")

    def _bind_subplan(self, stmt: ast.SelectStmt, outer: Scope):
        """Bind a subquery; `outer` is the enclosing FROM scope. Column names
        that fail inner resolution bind against it as BOuterCol references;
        returns (plan, correlated?)."""
        sub = Binder(self.catalog, self.config, self.cte_plans, outer_scope=outer)
        plan = sub.bind_select(stmt)
        self.structural |= sub.structural
        return plan, sub.uses_outer

    def _bind_literal(self, e: ast.Literal) -> b.BLiteral:
        v = e.value
        if e.type_hint == "DATE":
            if e.param is not None:
                return b.BLiteral(tt.DATE, days_from_iso(str(v)), e.param)
            return b.BLiteral(tt.DATE, days_from_iso(str(v)))
        if e.type_hint == "TIMESTAMP":
            if e.param is not None:
                self.structural.add(e.param)
            dt = datetime.datetime.fromisoformat(str(v))
            micros = int(dt.timestamp() * 1e6)
            return b.BLiteral(tt.TIMESTAMP, micros)
        if e.type_hint and e.type_hint.startswith("INTERVAL:"):
            if e.param is not None:
                self.structural.add(e.param)
            unit = e.type_hint.split(":")[1]
            if unit not in _INTERVAL_UNITS:
                raise BindError(f"unsupported interval unit {unit}")
            field, mult = _INTERVAL_UNITS[unit]
            iv = Interval()
            setattr(iv, field, int(str(v).strip()) * mult)
            lit = b.BLiteral(tt.BIGINT, iv)
            lit.is_interval = True
            return lit
        if e.type_hint == "PARAM":
            # '?' placeholder: value arrives at execution via the literal
            # slot; numeric context assumed (string/dict predicates need
            # bind-time values and are not preparable)
            return b.BLiteral(tt.BIGINT, None, e.param)
        if v is None:
            return b.BLiteral(tt.INTEGER, None)
        if isinstance(v, bool):
            return b.BLiteral(tt.BOOLEAN, v)
        if isinstance(v, int):
            return b.BLiteral(tt.BIGINT, v, e.param)
        if isinstance(v, float):
            return b.BLiteral(tt.DOUBLE, v, e.param)
        return b.BLiteral(tt.VARCHAR, v, e.param)

    _EXTRACT_ALIASES = {
        "year": "year", "month": "month", "day": "day",
        "quarter": "quarter", "week": "week", "dow": "dow",
        "dayofweek": "dow", "doy": "doy", "dayofyear": "doy",
        "epoch": "epoch", "hour": "hour", "minute": "minute",
        "second": "second",
    }

    def _bind_scalar_func(self, name: str, args: List[b.BExpr]) -> b.BExpr:
        name = name.lower()
        if name in ("abs",):
            return b.BFunc(args[0].ty, name, args)
        if name in ("floor", "ceil", "ceiling", "round", "trunc"):
            return b.BFunc(tt.DOUBLE if args[0].ty.is_float else args[0].ty, name, args)
        if name in ("sqrt", "cbrt", "exp", "ln", "log2", "log10", "sin",
                    "cos", "tan", "asin", "acos", "atan", "degrees",
                    "radians"):
            return b.BFunc(tt.DOUBLE, name, args)
        if name == "log":  # DuckDB: log(x) is log10
            return b.BFunc(tt.DOUBLE, "log10", args)
        if name in ("power", "pow"):
            return b.BFunc(tt.DOUBLE, "power", args)
        if name == "atan2":
            return b.BFunc(tt.DOUBLE, "atan2", args)
        if name == "pi":
            return b.BLiteral(tt.DOUBLE, 3.141592653589793)
        if name == "sign":
            return b.BFunc(tt.BIGINT, "sign", args)
        if name == "mod":
            ty = tt.DOUBLE if (args[0].ty.is_float or args[1].ty.is_float) \
                else tt.common_type(args[0].ty, args[1].ty)
            return b.BFunc(ty, "mod", args)
        if name in ("greatest", "least"):
            ty = args[0].ty
            for a in args[1:]:
                ty = tt.common_type(ty, a.ty)
            return b.BFunc(ty, name, args)
        if name == "nullif":
            # NULLIF(a, b) == CASE WHEN a = b THEN NULL ELSE a END
            cond = self._type_binary("=", args[0], args[1])
            return b.BCase(args[0].ty,
                           [(cond, b.BLiteral(args[0].ty, None))], args[0],
                           dictionary=getattr(args[0], "dictionary", None))
        if name in ("ifnull",):
            return self._bind_scalar_func("coalesce", args[:2])
        if name in ("iif", "if"):
            ty = tt.common_type(args[1].ty, args[2].ty)
            return b.BCase(ty, [(args[0], args[1])], args[2],
                           dictionary=getattr(args[1], "dictionary", None))
        if name in self._EXTRACT_ALIASES:
            return b.BFunc(tt.BIGINT,
                           "extract_" + self._EXTRACT_ALIASES[name], args)
        if name.startswith("extract_"):
            part = name[len("extract_"):]
            if part in self._EXTRACT_ALIASES:
                return b.BFunc(tt.BIGINT,
                               "extract_" + self._EXTRACT_ALIASES[part],
                               args)
        if name == "date_trunc":
            # TIMESTAMP input keeps micros resolution (minute/hour truncs)
            out_ty = tt.TIMESTAMP if args[1].ty is tt.TIMESTAMP else tt.DATE
            return b.BFunc(out_ty, "date_trunc", args)
        if name == "last_day":
            return b.BFunc(tt.DATE, "last_day", args)
        if name in ("date_diff", "datediff"):
            part = args[0]
            if isinstance(part, b.BLiteral):
                p = str(part.value).lower().rstrip("s")
                if p in ("day", "month", "year"):
                    return b.BFunc(tt.BIGINT, f"date_diff_{p}", args[1:])
            raise BindError("date_diff part must be 'day'/'month'/'year'")
        if name in ("monthname", "dayname"):
            return self._bind_name_of_date(name, args[0])
        if name == "coalesce":
            ty = args[0].ty
            for a in args[1:]:
                if not (isinstance(a, b.BLiteral) and a.value is None):
                    ty = tt.common_type(ty, a.ty)
            return b.BFunc(ty, "coalesce", args)
        if name in ("length", "len", "strlen", "strpos", "instr",
                    "position", "ascii"):
            return self._bind_int_string_func(
                "length" if name == "strlen" else name, args)
        if name in ("contains", "starts_with", "prefix", "ends_with",
                    "suffix", "regexp_matches"):
            return self._bind_string_predicate_func(name, args)
        if name in ("lower", "upper", "substring", "substr", "trim", "ltrim",
                    "rtrim", "concat", "replace", "left", "right", "lpad",
                    "rpad", "reverse", "repeat", "split_part", "initcap"):
            return self._bind_string_func(
                name if name != "substr" else "substring", args)
        if name == "regexp_replace":
            # regexp_replace(col, pattern, replacement) with literal
            # pattern/replacement: evaluates over the dictionary like the
            # other string functions (ClickBench q29's hostname extraction)
            import re as _re

            def _lit_str(a):
                if isinstance(a, b.BLiteral):
                    if a.param is not None:
                        self.structural.add(a.param)
                    return str(a.value)
                raise BindError("regexp_replace: pattern/replacement must be literals")

            pat = _re.compile(_lit_str(args[1]))
            rep = _lit_str(args[2]).replace("\\1", "\\g<1>")
            if self._expr_dict(args[0]) is None:
                return b.BLiteral(tt.VARCHAR,
                                  pat.sub(rep, _lit_str(args[0])))
            return self._derive_dict(args[0],
                                     lambda s_: pat.sub(rep, s_))
        if name == "date_part":
            # date_part('year', d)
            part = args[0]
            if isinstance(part, b.BLiteral):
                p = str(part.value).lower()
                p = self._EXTRACT_ALIASES.get(p, p)
                return b.BFunc(tt.BIGINT, "extract_" + p, [args[1]])
        raise BindError(f"unknown function {name}")

    def _bind_name_of_date(self, name: str, arg: b.BExpr) -> b.BExpr:
        """monthname/dayname: device computes the code, static dictionary
        holds the 12/7 names (BCodeDict)."""
        from adacom_tpu_torch.storage.table import StringDictionary

        if name == "monthname":
            names = ["January", "February", "March", "April", "May", "June",
                     "July", "August", "September", "October", "November",
                     "December"]
            code = b.BBinary(tt.BIGINT, "-",
                             b.BFunc(tt.BIGINT, "extract_month", [arg]),
                             b.BLiteral(tt.BIGINT, 1))
        else:
            names = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                     "Friday", "Saturday"]
            code = b.BFunc(tt.BIGINT, "extract_dow", [arg])
        d = StringDictionary()
        for s in names:
            d.encode_one(s)
        return b.BCodeDict(tt.VARCHAR, code, d)

    def _bind_int_string_func(self, name: str, args: List[b.BExpr]) -> b.BExpr:
        """Integer-valued string functions via per-code LUT (BDictIntMap)."""
        import numpy as np

        base = args[0]
        if name in ("strpos", "instr", "position"):
            sub = args[1]
            if not isinstance(sub, b.BLiteral):
                raise BindError(f"{name}: needle must be a literal")
            needle = str(sub.value)
            f = lambda s: s.find(needle) + 1  # noqa: E731  (1-based, 0 = absent)
        elif name == "ascii":
            f = lambda s: ord(s[0]) if s else 0  # noqa: E731
        else:  # length/len
            f = len
        d = self._expr_dict(base)
        if d is None:
            if isinstance(base, b.BLiteral):
                return b.BLiteral(tt.BIGINT, int(f(str(base.value))))
            raise BindError(f"{name}: argument must be VARCHAR")
        strs = d.strings_array()
        lut = np.fromiter((f(str(s)) for s in strs), dtype=np.int64,
                          count=len(strs)) if len(strs) else \
            np.zeros(1, np.int64)
        return b.BDictIntMap(tt.BIGINT, base, lut)

    def _bind_string_predicate_func(self, name: str,
                                    args: List[b.BExpr]) -> b.BExpr:
        """contains/starts_with/ends_with/regexp_matches -> the LIKE/regex
        dictionary-LUT machinery (BDictPredicate)."""
        base, pat = args[0], args[1]
        d = self._expr_dict(base)
        if d is None:
            raise BindError(f"{name}: first argument must be VARCHAR")
        if not isinstance(pat, b.BLiteral):
            raise BindError(f"{name}: pattern must be a literal")
        if pat.param is not None:
            # bake the pattern into the plan (structural literal slot)
            self.structural.add(pat.param)
        if name == "regexp_matches":
            return b.BDictPredicate(tt.BOOLEAN, base, "regex", pat,
                                    dictionary=d)
        # LIKE has no escape syntax here, so build an anchored regex
        # instead (kind='regex' uses re.search)
        import re as _re

        esc = _re.escape(str(pat.value))
        if name in ("starts_with", "prefix"):
            rx = "^" + esc
        elif name in ("ends_with", "suffix"):
            rx = esc + "$"
        else:  # contains
            rx = esc
        lit = b.BLiteral(tt.VARCHAR, rx)
        return b.BDictPredicate(tt.BOOLEAN, base, "regex", lit,
                                dictionary=d)

    def _bind_string_func(self, name: str, args: List[b.BExpr]) -> b.BExpr:
        """String scalar functions evaluate over the DICTIONARY at bind time
        (codes never leave the device; the runtime gathers a code->code LUT).
        Constant-folds when every argument is a literal."""
        import numpy as np

        def str_of(a):
            if isinstance(a, b.BLiteral):
                if a.param is not None:
                    # value baked into the derived dictionary -> structural
                    self.structural.add(a.param)
                return str(a.value)
            raise BindError(f"{name}: argument must be a literal or a VARCHAR column")

        def compile_fn(params: List[b.BExpr]):
            """Resolve literal arguments ONCE and return a str->str mapper
            (the mapper runs over every dictionary entry — per-call
            literal parsing made substring() 10x slower at bind time)."""
            if name == "lower":
                return lambda s: s.lower()
            if name == "upper":
                return lambda s: s.upper()
            if name == "trim":
                return lambda s: s.strip()
            if name == "ltrim":
                return lambda s: s.lstrip()
            if name == "rtrim":
                return lambda s: s.rstrip()
            if name == "substring":
                start = int(_lit_num(params[0], self, name))
                ln = int(_lit_num(params[1], self, name)) if len(params) > 1 else None
                i0 = max(0, start - 1)
                if ln is None:
                    return lambda s: s[i0:]
                j = i0 + ln
                return lambda s: s[i0:j]
            if name == "replace":
                a, c = str_of(params[0]), str_of(params[1])
                return lambda s: s.replace(a, c)
            if name == "left":
                n = int(_lit_num(params[0], self, name))
                if n >= 0:
                    return lambda s: s[:n]
                return lambda s: s[:max(0, len(s) + n)]
            if name == "right":
                n = int(_lit_num(params[0], self, name))
                if n > 0:
                    return lambda s: s[max(0, len(s) - n):]
                if n == 0:
                    return lambda s: ""
                return lambda s: s[-n:]
            if name in ("lpad", "rpad"):
                n = int(_lit_num(params[0], self, name))
                fill = str_of(params[1]) if len(params) > 1 else " "
                left_pad = name == "lpad"

                def pad_fn(s):
                    if len(s) >= n:
                        return s[:n]
                    pad = (fill * n)[: n - len(s)] if fill else ""
                    return pad + s if left_pad else s + pad

                return pad_fn
            if name == "reverse":
                return lambda s: s[::-1]
            if name == "repeat":
                k = max(0, int(_lit_num(params[0], self, name)))
                return lambda s: s * k
            if name == "split_part":
                sep = str_of(params[0])
                idx = int(_lit_num(params[1], self, name))

                def split_fn(s):
                    parts_ = s.split(sep) if sep else [s]
                    return parts_[idx - 1] if 1 <= idx <= len(parts_) else ""

                return split_fn
            if name == "initcap":
                return lambda s: s.title()
            raise BindError(f"unsupported string function {name}")

        if name == "concat":
            parts = []
            col = None
            col_pos = -1
            for i, a in enumerate(args):
                d = self._expr_dict(a)
                if d is not None:
                    if col is not None:
                        raise BindError("concat supports one VARCHAR column")
                    col, col_pos = a, i
                    parts.append(None)
                else:
                    parts.append(str_of(a))
            if col is None:
                return b.BLiteral(tt.VARCHAR, "".join(parts))
            pre = "".join(p for p in parts[:col_pos] if p is not None)
            post = "".join(p for p in parts[col_pos + 1:] if p is not None)
            return self._derive_dict(col, lambda s: pre + s + post)

        base = args[0]
        d = self._expr_dict(base)
        if d is None:
            # pure literal fold
            return b.BLiteral(tt.VARCHAR, compile_fn(args[1:])(str_of(base)))
        return self._derive_dict(base, compile_fn(args[1:]))

    def _derive_dict(self, operand: b.BExpr, fn) -> b.BExpr:
        """Map a dict-encoded column through a per-string function: build the
        derived dictionary + old->new code LUT at bind time."""
        import numpy as np

        from adacom_tpu_torch.storage.table import StringDictionary

        src = self._expr_dict(operand)
        out = StringDictionary()
        strs = src.strings_array()
        if len(strs) == 0:
            lut = np.zeros(1, dtype=np.uint32)
            out.encode_one("")
        else:
            mapped = np.asarray([fn(str(s)) for s in strs], dtype=object)
            # unique+inverse replaces 333k encode_one dict inserts with one
            # sort (Q22 binds substring over the full c_phone dictionary)
            uniq, inv = np.unique(mapped, return_inverse=True)
            for u in uniq:
                out.encode_one(str(u))
            lut = inv.astype(np.uint32)
        return b.BDictMap(tt.VARCHAR, operand, lut, out)

    def _type_binary(self, op: str, l: b.BExpr, r: b.BExpr) -> b.BExpr:
        if op in ("and", "or"):
            return b.BBinary(tt.BOOLEAN, op, l, r)
        if op in ("=", "<>", "<", "<=", ">", ">="):
            # coerce string literals compared against DATE columns
            # ('1994-01-01' style, sqlite-compatible query text)
            def _coerce_date(side, other):
                if other.ty is tt.DATE and isinstance(side, b.BLiteral) and \
                        side.ty.is_string:
                    if side.param is not None:
                        return b.BLiteral(tt.DATE, side.value, side.param)
                    return b.BLiteral(tt.DATE, days_from_iso(str(side.value)))
                return side

            l = _coerce_date(l, r)
            r = _coerce_date(r, l)
            return b.BBinary(tt.BOOLEAN, op, l, r)
        if op == "||":
            return b.BBinary(tt.VARCHAR, op, l, r)
        # interval folding: DATE +/- INTERVAL
        lint = getattr(l, "is_interval", False)
        rint = getattr(r, "is_interval", False)
        if rint and l.ty is tt.DATE and op in ("+", "-"):
            iv = r.value
            sign = 1 if op == "+" else -1
            if isinstance(l, b.BLiteral) and l.param is None:
                days = l.value
                if iv.months:
                    days = add_months(days, sign * iv.months)
                days += sign * iv.days
                return b.BLiteral(tt.DATE, days)
            return b.BFunc(tt.DATE, "date_add",
                           [l, b.BLiteral(tt.BIGINT, sign * iv.months),
                            b.BLiteral(tt.BIGINT, sign * iv.days)])
        if lint or rint:
            raise BindError("unsupported interval arithmetic")
        # literal date folding for comparisons happens naturally (both DATE)
        if op == "/":
            if l.ty.name == "DECIMAL" or r.ty.name == "DECIMAL" or l.ty.is_float or r.ty.is_float:
                ty = tt.DOUBLE
            else:
                ty = tt.common_type(l.ty, r.ty)
            return b.BBinary(ty, op, l, r)
        ty = tt.common_type(l.ty, r.ty)
        if op in ("+", "-", "*") and l.ty.name == "DECIMAL" and r.ty.name == "DECIMAL" and op == "*":
            ty = tt.DECIMAL(38, l.ty.scale + r.ty.scale)
        return b.BBinary(ty, op, l, r)

    # ---------------- helpers ----------------
    def _expr_name(self, e) -> str:
        if isinstance(e, ast.ColumnRef):
            return e.name
        if isinstance(e, ast.FuncCall):
            return e.name
        if isinstance(e, (b.BColumn,)):
            return e.name
        if isinstance(e, b.BExpr):
            return "expr"
        if isinstance(e, ast.Literal):
            return str(e.value)
        if isinstance(e, ast.BinaryOp):
            return self._expr_name(e.left)
        if isinstance(e, ast.Cast):
            return self._expr_name(e.operand)
        return "expr"

    def _expr_dict(self, e: b.BExpr):
        if isinstance(e, (b.BColumn, b.BDictMap, b.BOuterCol, b.BCodeDict,
                          b.BAggRef)):
            return e.dictionary
        if isinstance(e, b.BCase):
            if e.dictionary is not None:
                return e.dictionary
            for _, v in e.whens:
                d = self._expr_dict(v)
                if d is not None:
                    return d
        if isinstance(e, b.BFunc) and e.name == "coalesce":
            for a in e.args:
                d = self._expr_dict(a)
                if d is not None:
                    return d
        return None


def _lit_num(e: b.BExpr, binder: "Binder", fname: str):
    """Numeric literal argument of a bind-time-evaluated function; its value
    shapes the plan, so its literal slot becomes structural."""
    if isinstance(e, b.BLiteral) and isinstance(e.value, (int, float)):
        if e.param is not None:
            binder.structural.add(e.param)
        return e.value
    raise BindError(f"{fname}: expected a numeric literal argument")


def _strip_literal_params(node) -> None:
    """Clear literal param slots in a parsed AST (values stay baked)."""
    if isinstance(node, ast.Literal):
        node.param = None
        return
    if isinstance(node, (list, tuple)):
        for x in node:
            _strip_literal_params(x)
        return
    if hasattr(node, "__dataclass_fields__"):
        for f in node.__dataclass_fields__:
            _strip_literal_params(getattr(node, f))


def _split_conjuncts(e: b.BExpr) -> List[b.BExpr]:
    if isinstance(e, b.BBinary) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _bexpr_eq(a: b.BExpr, x: b.BExpr, slots: list | None = None) -> bool:
    """Structural bound-expression equality. Literals compare by VALUE; when
    `slots` is given, matched literal param pairs are appended so the caller
    can mark them structural for the plan cache."""
    if type(a) is not type(x):
        return False
    if isinstance(a, b.BColumn):
        return a.index == x.index
    if isinstance(a, b.BLiteral):
        if a.value != x.value:
            return False
        if a.param != x.param and slots is not None:
            slots.append((a.param, x.param))
        return a.param == x.param or slots is not None
    if isinstance(a, b.BBinary):
        return a.op == x.op and _bexpr_eq(a.left, x.left, slots) and _bexpr_eq(a.right, x.right, slots)
    if isinstance(a, b.BUnary):
        return a.op == x.op and _bexpr_eq(a.operand, x.operand, slots)
    if isinstance(a, b.BCast):
        return a.ty == x.ty and _bexpr_eq(a.operand, x.operand, slots)
    if isinstance(a, b.BFunc):
        return a.name == x.name and len(a.args) == len(x.args) and all(
            _bexpr_eq(p, q, slots) for p, q in zip(a.args, x.args)
        )
    if isinstance(a, b.BDictMap):
        import numpy as np

        return _bexpr_eq(a.operand, x.operand, slots) and \
            np.array_equal(a.lut, x.lut) and \
            list(a.dictionary.strings_array()) == list(x.dictionary.strings_array())
    if isinstance(a, b.BDictIntMap):
        import numpy as np

        return _bexpr_eq(a.operand, x.operand, slots) and \
            np.array_equal(a.lut, x.lut)
    if isinstance(a, b.BCodeDict):
        return _bexpr_eq(a.operand, x.operand, slots) and \
            list(a.dictionary.strings_array()) == \
            list(x.dictionary.strings_array())
    if isinstance(a, b.BInList):
        return a.negated == x.negated and len(a.items) == len(x.items) and \
            _bexpr_eq(a.operand, x.operand, slots) and all(
                _bexpr_eq(p, q, slots) for p, q in zip(a.items, x.items))
    if isinstance(a, b.BCase):
        if (a.else_ is None) != (x.else_ is None) or \
                len(a.whens) != len(x.whens):
            return False
        for (c1, v1), (c2, v2) in zip(a.whens, x.whens):
            if not (_bexpr_eq(c1, c2, slots) and _bexpr_eq(v1, v2, slots)):
                return False
        if a.else_ is not None and not _bexpr_eq(a.else_, x.else_, slots):
            return False
        d1, d2 = a.dictionary, x.dictionary
        if (d1 is None) != (d2 is None):
            return False
        if d1 is not None and d1 is not d2 and \
                list(d1.strings_array()) != list(d2.strings_array()):
            return False
        return True
    return False
