"""AST node definitions (parser output).

Parity with the reference's SQLStatement / ParsedExpression hierarchies
(src/include/duckdb/parser/), trimmed to the engine's SQL surface."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Any

D = dataclasses.dataclass


# ---------------- expressions ----------------
@D
class Expr:
    pass


@D
class Literal(Expr):
    value: Any  # python int/float/str/bool/None
    param: Optional[int] = None  # literal slot for plan caching
    type_hint: Optional[str] = None  # 'DATE', 'TIMESTAMP', 'INTERVAL:unit'


@D
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None


@D
class Star(Expr):
    table: Optional[str] = None


@D
class WindowSpec:
    """OVER (...) clause: PARTITION BY / ORDER BY / frame.

    frame is None (default frame) or a tuple
    (mode, start, end) where mode is 'rows'|'range' and each bound is
    ('unbounded_preceding',), ('preceding', n), ('current',),
    ('following', n) or ('unbounded_following',)."""
    partition_by: List["Expr"]
    order_by: List["OrderItem"]
    frame: object = None


@D
class FuncCall(Expr):
    name: str
    args: List[Expr]
    distinct: bool = False
    star: bool = False  # count(*)
    over: object = None  # WindowSpec when this is a window function call


@D
class BinaryOp(Expr):
    op: str  # '+','-','*','/','%','=','<>','<','<=','>','>=','and','or','||'
    left: Expr
    right: Expr


@D
class UnaryOp(Expr):
    op: str  # '-', 'not'
    operand: Expr


@D
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@D
class InList(Expr):
    operand: Expr
    items: List[Expr]
    negated: bool = False


@D
class InSubquery(Expr):
    operand: Expr
    subquery: "SelectStmt"
    negated: bool = False


@D
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@D
class Like(Expr):
    operand: Expr
    pattern: Expr
    negated: bool = False
    case_insensitive: bool = False


@D
class Case(Expr):
    operand: Optional[Expr]  # CASE x WHEN ... vs CASE WHEN ...
    whens: List[Tuple[Expr, Expr]]
    else_: Optional[Expr]


@D
class Cast(Expr):
    operand: Expr
    type_name: str
    type_args: Optional[List[int]] = None


@D
class Exists(Expr):
    subquery: "SelectStmt"
    negated: bool = False


@D
class ScalarSubquery(Expr):
    subquery: "SelectStmt"


# ---------------- statements ----------------
@D
class Stmt:
    pass


@D
class TableRef:
    pass


@D
class BaseTable(TableRef):
    name: str
    alias: Optional[str] = None


@D
class TableFunctionRef(TableRef):
    """range(...) / read_csv(...) in FROM (reference table functions,
    src/function/table/)."""
    name: str
    args: List[Expr] = None
    alias: Optional[str] = None


@D
class SampleRef(TableRef):
    """t USING SAMPLE n [ROWS] / p% / TABLESAMPLE (reference sample
    operator, src/execution/operator/helper/physical_reservoir_sample)."""
    ref: TableRef = None
    amount: object = None   # ast.Literal
    is_percent: bool = False


@D
class ValuesRef(TableRef):
    rows: list = None   # list of list[Expr]
    alias: Optional[str] = None


@D
class SubqueryRef(TableRef):
    subquery: "SelectStmt"
    alias: str


@D
class JoinRef(TableRef):
    left: TableRef
    right: TableRef
    join_type: str  # 'inner','left','right','full','cross'
    condition: Optional[Expr] = None
    using: Optional[List[str]] = None


@D
class OrderItem:
    expr: Expr
    desc: bool = False
    nulls_first: Optional[bool] = None


@D
class SelectStmt(Stmt):
    select_list: List[Tuple[Expr, Optional[str]]]  # (expr, alias)
    from_ref: Optional[TableRef]
    where: Optional[Expr] = None
    group_by: Optional[List[Expr]] = None
    having: Optional[Expr] = None
    order_by: Optional[List[OrderItem]] = None
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    distinct: bool = False
    ctes: Optional[List[Tuple[str, "SelectStmt"]]] = None
    # set operation chaining: (op, all, rhs SelectStmt)
    set_ops: Optional[List[Tuple[str, bool, "SelectStmt"]]] = None


@D
class CreateTableStmt(Stmt):
    name: str
    columns: List[Tuple[str, str, Optional[List[int]]]]  # (name, type, args)
    if_not_exists: bool = False
    as_select: Optional[SelectStmt] = None
    # [(kind, column)] with kind in {"primary_key", "unique"}
    constraints: List[Tuple[str, str]] = None


@D
class PrepareStmt(Stmt):
    name: str = ""
    sql: str = ""   # the prepared statement's own SQL text


@D
class ExecuteStmt(Stmt):
    name: str = ""
    args: list = None


@D
class CreateIndexStmt(Stmt):
    name: str
    table: str
    column: str
    unique: bool = False
    if_not_exists: bool = False


@D
class CreateViewStmt(Stmt):
    name: str
    select_sql: str
    or_replace: bool = False


@D
class InsertStmt(Stmt):
    table: str
    columns: Optional[List[str]]
    rows: Optional[List[List[Expr]]] = None  # VALUES
    select: Optional[SelectStmt] = None


@D
class UpdateStmt(Stmt):
    table: str
    assignments: List[Tuple[str, Expr]]
    where: Optional[Expr] = None


@D
class DeleteStmt(Stmt):
    table: str
    where: Optional[Expr] = None


@D
class DropStmt(Stmt):
    kind: str  # 'table' | 'view'
    name: str
    if_exists: bool = False


@D
class TransactionStmt(Stmt):
    action: str  # 'begin' | 'commit' | 'rollback'


@D
class PragmaStmt(Stmt):
    name: str
    value: Optional[Any] = None
    is_call: bool = False
    args: Optional[List[Any]] = None


@D
class SetStmt(Stmt):
    name: str
    value: Any


@D
class ExplainStmt(Stmt):
    target: Stmt
    analyze: bool = False


@D
class CopyStmt(Stmt):
    """COPY t FROM/TO 'file' (reference physical_copy_{to_file,from_file})."""
    table: Optional[str]
    select: Optional[SelectStmt]
    path: str
    direction: str  # 'from' | 'to'
    options: dict = None


@D
class CheckpointStmt(Stmt):
    pass


@D
class DescribeStmt(Stmt):
    table: str
