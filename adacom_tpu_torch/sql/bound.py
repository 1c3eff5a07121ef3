"""Bound (typed, resolved) expression IR + logical plan nodes.

Parity with the reference's BoundExpression / LogicalOperator hierarchies
(src/planner/expression/*, src/planner/operator/*). Expressions reference
input columns by position; every node carries a LogicalType."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from adacom_tpu_torch import types as tt

D = dataclasses.dataclass


@D
class BExpr:
    ty: tt.LogicalType


@D
class BColumn(BExpr):
    index: int  # position in the child operator's output schema
    name: str = ""
    dictionary: Any = None  # StringDictionary for VARCHAR columns


@D
class BLiteral(BExpr):
    value: Any
    param: Optional[int] = None  # literal slot (plan-cache substitution)


@D
class BBinary(BExpr):
    op: str
    left: BExpr
    right: BExpr


@D
class BUnary(BExpr):
    op: str  # '-', 'not'
    operand: BExpr


@D
class BIsNull(BExpr):
    operand: BExpr
    negated: bool = False


@D
class BCase(BExpr):
    whens: List[Tuple[BExpr, BExpr]]
    else_: Optional[BExpr]
    # VARCHAR CASE: branch string literals dictionary-encode at bind time
    # and the result column carries this output dictionary
    dictionary: Any = None


@D
class BCast(BExpr):
    operand: BExpr


@D
class BFunc(BExpr):
    name: str
    args: List[BExpr]


@D
class BInList(BExpr):
    operand: BExpr
    items: List[BExpr]
    negated: bool = False


@D
class BDictPredicate(BExpr):
    """String predicate evaluated over the dictionary host-side; at runtime
    becomes a boolean LUT gathered by dictionary code (LIKE, dict ranges)."""
    operand: BExpr  # uint32 dict codes
    kind: str  # 'like'
    pattern: Any  # BLiteral
    negated: bool = False
    case_insensitive: bool = False
    dictionary: Any = None  # StringDictionary


@D
class BOuterCol(BExpr):
    """Correlated reference to a column of the ENCLOSING query's FROM scope,
    appearing inside a subquery plan. Decorrelation (sql/optimizer.py)
    rewrites every BOuterCol into a join-side BColumn; none survive into an
    executable plan (reference: correlated-column tracking in
    src/planner/binder/expression/bind_columnref_expression.cpp +
    src/planner/subquery/flatten_dependent_join.cpp)."""
    index: int  # position in the outer FROM schema at the subquery bind site
    name: str = ""
    dictionary: Any = None


@D
class BDictMap(BExpr):
    """String scalar function over a dictionary-encoded column, evaluated at
    bind time over the dictionary (substring/lower/upper/trim/concat...):
    at runtime just a code->code LUT gather; `dictionary` is the derived
    output StringDictionary (reference: dictionary short-circuiting in
    src/execution/expression_executor.cpp + string function family in
    src/function/scalar/string/*)."""
    operand: BExpr  # uint32 dict codes
    lut: Any = None  # np.ndarray: old code -> new code
    dictionary: Any = None  # derived StringDictionary


@D
class BDictIntMap(BExpr):
    """Integer-valued string function over a dictionary-encoded column
    (length, strpos, ascii, ...): evaluated over the dictionary at bind
    time into a per-code int LUT; runtime is one gather (reference:
    string function family src/function/scalar/string/* — here strings
    never leave the dictionary)."""
    operand: BExpr  # uint32 dict codes
    lut: Any = None  # np.int64 array: code -> value


@D
class BCodeDict(BExpr):
    """String-producing function of a NON-string operand (monthname,
    dayname): the operand expression itself yields dictionary codes and
    `dictionary` supplies the (static) strings."""
    operand: BExpr  # integer codes into `dictionary`
    dictionary: Any = None


@D
class BSubquery(BExpr):
    """Subquery expression.

    kind='scalar' -> first row/col value; 'exists' -> row_count > 0;
    'in' -> membership of `operand` in the subplan's first column (rewritten
    to a semi/anti join by the optimizer). Uncorrelated scalar/exists
    subqueries are evaluated per execution by the executor, which stores the
    result in `cached_value` before compiled expressions run. `correlated`
    subplans contain BOuterCol references and are decorrelated into joins by
    the optimizer (reference: flatten_dependent_join.cpp)."""
    plan: Any = None  # LogicalOp
    kind: str = "scalar"
    operand: Optional[BExpr] = None
    negated: bool = False
    cached_value: Any = None
    correlated: bool = False


@D
class BAggRef(BExpr):
    """Reference to aggregate #i of the enclosing LogicalAggregate."""
    index: int
    dictionary: Any = None  # set for min/max/first over VARCHAR


@D
class BoundWindow:
    """One window-function computation over the child's rows (reference:
    BoundWindowExpression, src/planner/expression/bound_window_expression.hpp;
    executed by src/execution/operator/aggregate/physical_window.cpp)."""
    func: str  # row_number/rank/.../sum/min/max/count/avg/lag/lead/...
    args: List[BExpr]
    ty: tt.LogicalType
    partitions: List[BExpr]
    # (key expr, desc, nulls_first)
    order_keys: List[Tuple[BExpr, bool, Optional[bool]]]
    # None = default frame; else (mode, start, end) per ast.WindowSpec
    frame: Any = None


@D
class BoundAggregate:
    func: str  # count/sum/avg/min/max/count_star/...
    arg: Optional[BExpr]
    ty: tt.LogicalType
    distinct: bool = False
    dictionary: Any = None  # output StringDictionary for VARCHAR results


# ---------------- logical operators ----------------
@D
class LogicalOp:
    # output schema
    names: List[str]
    types: List[tt.LogicalType]


@D
class LogicalGet(LogicalOp):
    table: Any  # storage Table
    table_name: str
    column_ids: List[str]  # projected storage columns, in output order
    # conjunctive filters over the projected schema (pushed down)
    filters: List[BExpr] = dataclasses.field(default_factory=list)


@D
class LogicalValues(LogicalOp):
    rows: List[List[BExpr]] = dataclasses.field(default_factory=list)


@D
class LogicalFilter(LogicalOp):
    child: LogicalOp = None
    condition: BExpr = None


@D
class LogicalProject(LogicalOp):
    child: LogicalOp = None
    exprs: List[BExpr] = dataclasses.field(default_factory=list)


@D
class LogicalAggregate(LogicalOp):
    child: LogicalOp = None
    groups: List[BExpr] = dataclasses.field(default_factory=list)
    aggregates: List[BoundAggregate] = dataclasses.field(default_factory=list)
    # output schema = groups ++ aggregates


@D
class LogicalJoin(LogicalOp):
    left: LogicalOp = None
    right: LogicalOp = None
    join_type: str = "inner"
    # equi-join key pairs as (left expr over left schema, right expr over right schema)
    conditions: List[Tuple[BExpr, BExpr]] = dataclasses.field(default_factory=list)
    # residual predicate over the combined schema (left cols then right cols)
    residual: Optional[BExpr] = None


@D
class LogicalWindow(LogicalOp):
    """Output schema = child schema ++ one column per window function
    (reference: LogicalWindow, src/planner/operator/logical_window.hpp)."""
    child: LogicalOp = None
    windows: List[BoundWindow] = dataclasses.field(default_factory=list)


@D
class LogicalOrder(LogicalOp):
    child: LogicalOp = None
    # (expr over child schema, desc, nulls_first)
    keys: List[Tuple[BExpr, bool, Optional[bool]]] = dataclasses.field(default_factory=list)


@D
class LogicalLimit(LogicalOp):
    child: LogicalOp = None
    limit: Optional[BExpr] = None
    offset: Optional[BExpr] = None


@D
class LogicalSample(LogicalOp):
    """Bernoulli/reservoir sample of the child (reference
    physical_reservoir_sample / sample helper operators)."""
    child: LogicalOp = None
    amount: int = 0          # rows (reservoir) or percent numerator
    is_percent: bool = False


@D
class LogicalTopN(LogicalOp):
    child: LogicalOp = None
    keys: List[Tuple[BExpr, bool, Optional[bool]]] = dataclasses.field(default_factory=list)
    limit: int = 0
    offset: int = 0


@D
class LogicalDistinct(LogicalOp):
    child: LogicalOp = None


@D
class LogicalSetOp(LogicalOp):
    op: str = "union"  # union/except/intersect
    all: bool = False
    left: LogicalOp = None
    right: LogicalOp = None


def iter_node_exprs(op: LogicalOp):
    """Yield every expression attached to one plan node."""
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, BExpr):
            yield v
        elif isinstance(v, list):
            for x in v:
                if isinstance(x, BExpr):
                    yield x
                elif isinstance(x, BoundAggregate):
                    if x.arg is not None:
                        yield x.arg
                elif isinstance(x, BoundWindow):
                    yield from x.args
                    yield from x.partitions
                    for k, _, _ in x.order_keys:
                        yield k
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, BExpr):
                            yield y


def walk(op: LogicalOp):
    yield op
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, LogicalOp):
            yield from walk(v)


def expr_walk(e: BExpr):
    yield e
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, BExpr):
            yield from expr_walk(v)
        elif isinstance(v, list):
            for x in v:
                if isinstance(x, BExpr):
                    yield from expr_walk(x)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, BExpr):
                            yield from expr_walk(y)
