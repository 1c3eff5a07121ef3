"""Recursive-descent SQL parser (reference: Parser::ParseQuery,
src/parser/parser.cpp:22, over a vendored Postgres grammar; here a lean
hand parser over the engine's SQL surface)."""

from __future__ import annotations

from typing import List, Optional, Tuple

from adacom_tpu_torch.sql import ast
from adacom_tpu_torch.sql.lexer import (EOF, IDENT, KW, NUM, OP, STR, NumText,
                                        Token, tokenize)


class ParserError(Exception):
    pass


def parse(sql: str):
    """Parse one or more ';'-separated statements.

    Returns (statements, template_key, literal_values, structural_slots).
    structural_slots are literal positions whose *values* shaped the AST
    (type args, pragma values, ...) — they must join the plan-cache key."""
    toks, key, lits = tokenize(sql)
    p = _Parser(toks)
    stmts = []
    while not p.at(EOF):
        if p.accept_op(";"):
            continue
        stmts.append(p.statement())
        if not p.at(EOF):
            p.expect_op(";")
    return stmts, key, lits, p.structural


class _Parser:
    def __init__(self, toks: List[Token]):
        self.toks = toks
        self.i = 0
        self.structural: set = set()

    def _mark(self, t: Token):
        if t.param is not None:
            self.structural.add(t.param)
        return t

    # ------------- token helpers -------------
    def peek(self, k=0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != EOF:
            self.i += 1
        return t

    def at(self, kind, value=None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def at_kw(self, *words) -> bool:
        t = self.peek()
        return t.kind == KW and t.value in words

    def accept_kw(self, *words) -> Optional[str]:
        if self.at_kw(*words):
            return self.next().value
        return None

    def expect_kw(self, word) -> Token:
        if not self.at_kw(word):
            raise ParserError(f"expected {word}, got {self.peek().value!r}")
        return self.next()

    def accept_op(self, op) -> bool:
        if self.at(OP, op):
            self.next()
            return True
        return False

    def expect_op(self, op):
        if not self.accept_op(op):
            raise ParserError(f"expected {op!r}, got {self.peek().value!r}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == IDENT:
            self.next()
            return t.value
        # allow non-reserved keywords as identifiers in common spots
        if t.kind == KW and t.value in ("DATE", "TIMESTAMP", "KEY", "FIRST",
                                        "LAST", "SET", "SHOW", "ANY", "SOME",
                                        "CHECK", "TO", "VALUES", "ALL", "ROW",
                                        "ROWS", "RANGE", "OVER", "PARTITION",
                                        "CURRENT", "FILTER", "WINDOW",
                                        "INDEX"):
            self.next()
            return t.value.lower()
        raise ParserError(f"expected identifier, got {t.value!r}")

    # ------------- statements -------------
    def statement(self) -> ast.Stmt:
        if self.at_kw("SELECT", "WITH"):
            return self.select_stmt()
        if self.at_kw("CREATE"):
            return self.create_stmt()
        if self.at_kw("INSERT"):
            return self.insert_stmt()
        if self.at_kw("UPDATE"):
            return self.update_stmt()
        if self.at_kw("DELETE"):
            return self.delete_stmt()
        if self.at_kw("DROP"):
            return self.drop_stmt()
        if self.at_kw("BEGIN"):
            self.next()
            self.accept_kw("TRANSACTION")
            return ast.TransactionStmt("begin")
        if self.at_kw("COMMIT"):
            self.next()
            return ast.TransactionStmt("commit")
        if self.at_kw("ROLLBACK"):
            self.next()
            return ast.TransactionStmt("rollback")
        if self.at_kw("COPY"):
            return self.copy_stmt()
        if self.at_kw("PRAGMA"):
            return self.pragma_stmt()
        if self.at_kw("SET"):
            return self.set_stmt()
        if self.at_kw("EXPLAIN"):
            self.next()
            analyze = bool(self.accept_kw("ANALYZE"))
            return ast.ExplainStmt(self.statement(), analyze=analyze)
        if self.at_kw("CHECKPOINT"):
            self.next()
            return ast.CheckpointStmt()
        if self.at_kw("VACUUM", "ANALYZE"):
            self.next()
            return ast.CheckpointStmt()  # no-op maintenance
        if self.at_kw("PREPARE"):
            self.next()
            name = self.ident()
            self.expect_kw("AS")
            start = self.peek().pos
            self.select_or_dml_skip()
            return ast.PrepareStmt(name, self._slice_sql(start))
        if self.at_kw("EXECUTE"):
            self.next()
            name = self.ident()
            args = []
            if self.accept_op("("):
                while not self.accept_op(")"):
                    args.append(self.expr())
                    self.accept_op(",")
            return ast.ExecuteStmt(name, args)
        if self.at_kw("DESCRIBE", "SHOW"):
            self.next()
            name = self.ident()
            if name.upper() == "TABLES":
                return ast.DescribeStmt("")  # SHOW TABLES: list tables
            return ast.DescribeStmt(name)
        raise ParserError(f"unexpected token {self.peek().value!r}")

    def select_or_dml_skip(self) -> None:
        """Consume the prepared body (any statement) up to ';'/EOF; the
        captured TEXT re-parses inside PreparedStatement."""
        while not self.at(EOF) and not self.at(OP, ";"):
            self.next()

    def create_stmt(self) -> ast.Stmt:
        self.expect_kw("CREATE")
        or_replace = False
        if self.accept_kw("OR"):
            self.expect_kw("REPLACE")
            or_replace = True
        if self.accept_kw("VIEW"):
            name = self.ident()
            self.expect_kw("AS")
            # capture the remaining SQL text of the view body
            start = self.peek().pos
            sel = self.select_stmt()
            return ast.CreateViewStmt(name, self._slice_sql(start), or_replace)
        unique_index = False
        if self.accept_kw("UNIQUE"):
            unique_index = True
            self.expect_kw("INDEX")
            return self._create_index(unique_index)
        if self.accept_kw("INDEX"):
            return self._create_index(unique_index)
        self.expect_kw("TABLE")
        if_not_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not_exists = True
        name = self.ident()
        if self.accept_kw("AS"):
            sel = self.select_stmt()
            return ast.CreateTableStmt(name, [], if_not_exists, as_select=sel)
        self.expect_op("(")
        cols = []
        constraints = []
        while True:
            if self.at_kw("PRIMARY", "UNIQUE"):
                kind = "primary_key" if self.at_kw("PRIMARY") else "unique"
                self.next()
                if kind == "primary_key":
                    self.expect_kw("KEY")
                if self.accept_op("("):
                    ccols = [self.ident()]
                    while self.accept_op(","):
                        ccols.append(self.ident())
                    self.expect_op(")")
                    if len(ccols) == 1:  # composite keys: not indexed yet
                        constraints.append((kind, ccols[0]))
            elif self.at_kw("CONSTRAINT", "FOREIGN", "CHECK"):
                self._skip_constraint()
            else:
                cname = self.ident()
                ctype, targs = self.type_name()
                # per-column constraints: NOT NULL / PRIMARY KEY / DEFAULT ...
                while True:
                    if self.accept_kw("NOT"):
                        self.expect_kw("NULL")
                    elif self.accept_kw("PRIMARY"):
                        self.expect_kw("KEY")
                        constraints.append(("primary_key", cname))
                    elif self.accept_kw("UNIQUE"):
                        constraints.append(("unique", cname))
                    elif self.accept_kw("DEFAULT"):
                        self.expr()
                    elif self.accept_kw("NULL"):
                        pass
                    elif self.accept_kw("REFERENCES"):
                        self.ident()
                        if self.accept_op("("):
                            self.ident()
                            self.expect_op(")")
                    else:
                        break
                cols.append((cname, ctype, targs))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return ast.CreateTableStmt(name, cols, if_not_exists,
                                   constraints=constraints or None)

    def _create_index(self, unique: bool) -> ast.CreateIndexStmt:
        if_not_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not_exists = True
        name = self.ident()
        self.expect_kw("ON")
        table = self.ident()
        self.expect_op("(")
        cols = [self.ident()]
        while self.accept_op(","):
            cols.append(self.ident())
        self.expect_op(")")
        # composite keys travel as a comma-joined list (art.cpp:929)
        return ast.CreateIndexStmt(name, table, ",".join(cols), unique,
                                   if_not_exists)

    def _skip_constraint(self):
        depth = 0
        while True:
            t = self.peek()
            if t.kind == EOF:
                return
            if t.kind == OP and t.value == "(":
                depth += 1
            elif t.kind == OP and t.value == ")":
                if depth == 0:
                    return
                depth -= 1
            elif t.kind == OP and t.value == "," and depth == 0:
                return
            self.next()

    def _slice_sql(self, start: int) -> str:
        # reconstruct original text from token positions (for views)
        end = self.peek().pos
        src = getattr(self, "_src", None)
        # fall back: re-serialize tokens
        parts = []
        for t in self.toks:
            if t.pos >= start and (t.pos < end or self.at(EOF)):
                if t.kind == STR:
                    parts.append("'" + t.value.replace("'", "''") + "'")
                else:
                    parts.append(t.value)
        return " ".join(p for p in parts if p)

    def type_name(self) -> Tuple[str, Optional[List[int]]]:
        t = self.peek()
        if t.kind not in (IDENT, KW):
            raise ParserError(f"expected type name, got {t.value!r}")
        self.next()
        name = t.value.upper()
        args = None
        if self.accept_op("("):
            args = []
            while True:
                nt = self._mark(self.next())
                if nt.kind != NUM:
                    raise ParserError("expected number in type args")
                args.append(int(nt.value))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return name, args

    def insert_stmt(self) -> ast.InsertStmt:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        name = self.ident()
        cols = None
        if self.accept_op("("):
            cols = []
            while True:
                cols.append(self.ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        if self.at_kw("SELECT", "WITH"):
            return ast.InsertStmt(name, cols, select=self.select_stmt())
        self.expect_kw("VALUES")
        rows = []
        while True:
            self.expect_op("(")
            row = []
            while True:
                row.append(self.expr())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            rows.append(row)
            if not self.accept_op(","):
                break
        return ast.InsertStmt(name, cols, rows=rows)

    def update_stmt(self) -> ast.UpdateStmt:
        self.expect_kw("UPDATE")
        name = self.ident()
        self.expect_kw("SET")
        assigns = []
        while True:
            col = self.ident()
            self.expect_op("=")
            assigns.append((col, self.expr()))
            if not self.accept_op(","):
                break
        where = self.expr() if self.accept_kw("WHERE") else None
        return ast.UpdateStmt(name, assigns, where)

    def delete_stmt(self) -> ast.DeleteStmt:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        name = self.ident()
        where = self.expr() if self.accept_kw("WHERE") else None
        return ast.DeleteStmt(name, where)

    def copy_stmt(self) -> ast.CopyStmt:
        self.expect_kw("COPY")
        table = None
        select = None
        if self.accept_op("("):
            select = self.select_stmt()
            self.expect_op(")")
        else:
            table = self.ident()
        if self.accept_kw("FROM"):
            direction = "from"
        else:
            self.expect_kw("TO")
            direction = "to"
        t = self.next()
        path = str(self._mark(t).value).strip("'\"")
        options = {}
        self.accept_kw("WITH")
        if self.accept_op("("):
            while not self.accept_op(")"):
                key = self.ident().lower()
                if self.at(OP, ",") or self.at(OP, ")"):
                    options[key] = True
                else:
                    v = self.next()
                    val = v.value
                    if isinstance(val, str):
                        vs = val.strip("'\"")
                        val = {"true": True, "false": False}.get(vs.lower(), vs)
                    options[key] = val
                self.accept_op(",")
        return ast.CopyStmt(table, select, path, direction, options)

    def drop_stmt(self) -> ast.DropStmt:
        self.expect_kw("DROP")
        if self.accept_kw("VIEW"):
            kind = "view"
        elif self.accept_kw("INDEX"):
            kind = "index"
        else:
            kind = "table"
            self.expect_kw("TABLE")
        if_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        return ast.DropStmt(kind, self.ident(), if_exists)

    def pragma_stmt(self) -> ast.PragmaStmt:
        self.expect_kw("PRAGMA")
        name = self.ident()
        if self.accept_op("="):
            t = self._mark(self.next())
            return ast.PragmaStmt(name, value=t.value if t.kind != NUM else _num(t))
        if self.accept_op("("):
            args = []
            while not self.at(OP, ")"):
                t = self._mark(self.next())
                args.append(t.value if t.kind != NUM else _num(t))
                self.accept_op(",")
            self.expect_op(")")
            return ast.PragmaStmt(name, is_call=True, args=args)
        return ast.PragmaStmt(name, is_call=True, args=[])

    def set_stmt(self) -> ast.SetStmt:
        self.expect_kw("SET")
        name = self.ident()
        if not self.accept_op("="):
            self.expect_kw("TO")
        t = self._mark(self.next())
        return ast.SetStmt(name, t.value if t.kind != NUM else _num(t))

    # ------------- SELECT -------------
    def select_stmt(self) -> ast.SelectStmt:
        ctes = None
        if self.accept_kw("WITH"):
            self.accept_kw("RECURSIVE")
            ctes = []
            while True:
                name = self.ident()
                self.expect_kw("AS")
                self.expect_op("(")
                sub = self.select_stmt()
                self.expect_op(")")
                ctes.append((name, sub))
                if not self.accept_op(","):
                    break
        sel = self.select_core()
        sel.ctes = ctes
        # set operations
        while self.at_kw("UNION", "EXCEPT", "INTERSECT"):
            op = self.next().value.lower()
            all_ = bool(self.accept_kw("ALL"))
            rhs = self.select_core()
            if sel.set_ops is None:
                sel.set_ops = []
            sel.set_ops.append((op, all_, rhs))
        # ORDER BY / LIMIT apply to the whole set-op chain
        tail = self.order_limit()
        if tail[0] is not None:
            sel.order_by = tail[0]
        if tail[1] is not None:
            sel.limit = tail[1]
        if tail[2] is not None:
            sel.offset = tail[2]
        return sel

    def select_core(self) -> ast.SelectStmt:
        self.expect_kw("SELECT")
        distinct = bool(self.accept_kw("DISTINCT"))
        self.accept_kw("ALL")
        select_list = []
        while True:
            e = self.expr()
            alias = None
            if self.accept_kw("AS"):
                alias = self.ident()
            elif self.peek().kind == IDENT:
                alias = self.ident()
            select_list.append((e, alias))
            if not self.accept_op(","):
                break
        from_ref = None
        if self.accept_kw("FROM"):
            from_ref = self.from_clause()
        where = self.expr() if self.accept_kw("WHERE") else None
        group_by = None
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_by = []
            while True:
                group_by.append(self.expr())
                if not self.accept_op(","):
                    break
        having = self.expr() if self.accept_kw("HAVING") else None
        order_by, limit, offset = self.order_limit()
        return ast.SelectStmt(
            select_list=select_list, from_ref=from_ref, where=where,
            group_by=group_by, having=having, order_by=order_by,
            limit=limit, offset=offset, distinct=distinct,
        )

    def order_limit(self):
        order_by = None
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by = []
            while True:
                e = self.expr()
                desc = False
                if self.accept_kw("DESC"):
                    desc = True
                else:
                    self.accept_kw("ASC")
                nulls_first = None
                if self.accept_kw("NULLS"):
                    nulls_first = bool(self.accept_kw("FIRST"))
                    if nulls_first is False:
                        self.expect_kw("LAST")
                order_by.append(ast.OrderItem(e, desc, nulls_first))
                if not self.accept_op(","):
                    break
        limit = self.expr() if self.accept_kw("LIMIT") else None
        offset = self.expr() if self.accept_kw("OFFSET") else None
        return order_by, limit, offset

    def window_spec(self) -> ast.WindowSpec:
        """OVER ( [PARTITION BY ...] [ORDER BY ...] [frame] ) (reference:
        window binding src/planner/binder/expression/bind_window_expression.cpp)."""
        self.expect_op("(")
        partition_by: list = []
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            while True:
                partition_by.append(self.expr())
                if not self.accept_op(","):
                    break
        order_by: list = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.expr()
                desc = False
                if self.accept_kw("DESC"):
                    desc = True
                else:
                    self.accept_kw("ASC")
                nulls_first = None
                if self.accept_kw("NULLS"):
                    nulls_first = bool(self.accept_kw("FIRST"))
                    if nulls_first is False:
                        self.expect_kw("LAST")
                order_by.append(ast.OrderItem(e, desc, nulls_first))
                if not self.accept_op(","):
                    break
        frame = None
        mode = self.accept_kw("ROWS", "RANGE")
        if mode:
            if self.accept_kw("BETWEEN"):
                start = self._frame_bound()
                self.expect_kw("AND")
                end = self._frame_bound()
            else:
                start = self._frame_bound()
                end = ("current",)
            frame = (mode.lower(), start, end)
        self.expect_op(")")
        return ast.WindowSpec(partition_by, order_by, frame)

    def _frame_bound(self):
        if self.accept_kw("UNBOUNDED"):
            if self.accept_kw("PRECEDING"):
                return ("unbounded_preceding",)
            self.expect_kw("FOLLOWING")
            return ("unbounded_following",)
        if self.accept_kw("CURRENT"):
            if not self.accept_kw("ROW"):
                self.accept_kw("ROWS")
            return ("current",)
        t = self._mark(self.next())  # frame extent shapes the plan
        if t.kind != NUM:
            raise ParserError(f"expected frame bound, got {t.value!r}")
        n = _num(t)
        if self.accept_kw("PRECEDING"):
            return ("preceding", n)
        self.expect_kw("FOLLOWING")
        return ("following", n)

    def from_clause(self) -> ast.TableRef:
        ref = self.table_ref()
        while True:
            if self.accept_kw("CROSS"):
                self.expect_kw("JOIN")
                right = self.table_ref()
                ref = ast.JoinRef(ref, right, "cross")
                continue
            jt = None
            if self.at_kw("JOIN"):
                jt = "inner"
            elif self.at_kw("INNER"):
                self.next()
                jt = "inner"
            elif self.at_kw("LEFT"):
                self.next()
                self.accept_kw("OUTER")
                jt = "left"
            elif self.at_kw("RIGHT"):
                self.next()
                self.accept_kw("OUTER")
                jt = "right"
            elif self.at_kw("FULL"):
                self.next()
                self.accept_kw("OUTER")
                jt = "full"
            if jt is None:
                if self.accept_op(","):
                    right = self.table_ref()
                    ref = ast.JoinRef(ref, right, "cross")
                    continue
                break
            self.expect_kw("JOIN")
            right = self.table_ref()
            cond = None
            using = None
            if self.accept_kw("ON"):
                cond = self.expr()
            elif self.accept_kw("USING"):
                self.expect_op("(")
                using = []
                while True:
                    using.append(self.ident())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            ref = ast.JoinRef(ref, right, jt, cond, using)
        return ref

    def table_ref(self) -> ast.TableRef:
        if self.accept_op("("):
            if self.at_kw("VALUES"):
                self.next()
                rows = []
                while True:
                    self.expect_op("(")
                    row = [self.expr()]
                    while self.accept_op(","):
                        row.append(self.expr())
                    self.expect_op(")")
                    rows.append(row)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                alias = None
                if self.accept_kw("AS"):
                    alias = self.ident()
                elif self.peek().kind == IDENT:
                    alias = self.ident()
                return ast.ValuesRef(rows, alias)
            sub = self.select_stmt()
            self.expect_op(")")
            had_as = bool(self.accept_kw("AS"))
            alias = None
            if had_as or self.peek().kind == IDENT:
                alias = self.ident()
            return ast.SubqueryRef(sub, alias)
        name = self.ident()
        if self.at(OP, "("):
            # table function: range(...) / read_csv(...)
            self.expect_op("(")
            args = []
            while not self.accept_op(")"):
                args.append(self.expr())
                self.accept_op(",")
            # argument values shape the bound schema -> structural slots
            for a in args:
                if isinstance(a, ast.Literal) and a.param is not None:
                    self.structural.add(a.param)
            alias = None
            if self.accept_kw("AS"):
                alias = self.ident()
            elif self.peek().kind == IDENT:
                alias = self.ident()
            return ast.TableFunctionRef(name, args, alias)
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident()
        elif self.peek().kind == IDENT and not self._at_sample():
            alias = self.ident()
        return self._maybe_sample(ast.BaseTable(name, alias))

    def _at_sample(self) -> bool:
        t = self.peek()
        if t.kind == IDENT and str(t.value).upper() == "TABLESAMPLE":
            return True
        if t.kind == KW and t.value == "USING":
            n = self.peek(1)
            return n.kind == IDENT and str(n.value).upper() == "SAMPLE"
        return False

    def _maybe_sample(self, ref) -> ast.TableRef:
        """t USING SAMPLE 10 [ROWS] | USING SAMPLE 5% | TABLESAMPLE ..."""
        if not self._at_sample():
            return ref
        if self.peek().kind == KW:
            self.next()  # USING
        self.next()  # SAMPLE / TABLESAMPLE
        paren = self.accept_op("(")
        amount = self.unary()  # expr() would eat '%' as modulo
        is_pct = bool(self.accept_op("%"))
        if not is_pct and self.peek().kind == IDENT and \
                str(self.peek().value).upper() == "PERCENT":
            self.next()
            is_pct = True
        if self.peek().kind == KW and self.peek().value == "ROWS":
            self.next()
        if paren:
            self.expect_op(")")
        if isinstance(amount, ast.Literal) and amount.param is not None:
            # the sample size shapes the plan
            self.structural.add(amount.param)
        return ast.SampleRef(ref, amount, is_pct)

    # ------------- expressions -------------
    def expr(self) -> ast.Expr:
        return self.or_expr()

    def or_expr(self) -> ast.Expr:
        e = self.and_expr()
        while self.accept_kw("OR"):
            e = ast.BinaryOp("or", e, self.and_expr())
        return e

    def and_expr(self) -> ast.Expr:
        e = self.not_expr()
        while self.accept_kw("AND"):
            e = ast.BinaryOp("and", e, self.not_expr())
        return e

    def not_expr(self) -> ast.Expr:
        if self.accept_kw("NOT"):
            return ast.UnaryOp("not", self.not_expr())
        return self.comparison()

    def comparison(self) -> ast.Expr:
        e = self.additive()
        while True:
            t = self.peek()
            if t.kind == OP and t.value in ("=", "==", "<>", "!=", "<", "<=", ">", ">="):
                self.next()
                op = {"==": "=", "!=": "<>"}.get(t.value, t.value)
                e = ast.BinaryOp(op, e, self.additive())
                continue
            if self.at_kw("IS"):
                self.next()
                neg = bool(self.accept_kw("NOT"))
                self.expect_kw("NULL")
                e = ast.IsNull(e, neg)
                continue
            neg = False
            if self.at_kw("NOT") and self.peek(1).kind == KW and \
               self.peek(1).value in ("IN", "BETWEEN", "LIKE", "ILIKE"):
                self.next()
                neg = True
            if self.accept_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH"):
                    sub = self.select_stmt()
                    self.expect_op(")")
                    e = ast.InSubquery(e, sub, neg)
                else:
                    items = []
                    while True:
                        items.append(self.expr())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                    e = ast.InList(e, items, neg)
                continue
            if self.accept_kw("BETWEEN"):
                lo = self.additive()
                self.expect_kw("AND")
                hi = self.additive()
                e = ast.Between(e, lo, hi, neg)
                continue
            if self.at_kw("LIKE", "ILIKE"):
                ci = self.next().value == "ILIKE"
                pat = self.additive()
                if self.accept_kw("ESCAPE"):
                    self.additive()  # standard '\' assumed
                e = ast.Like(e, pat, neg, ci)
                continue
            break
        return e

    def additive(self) -> ast.Expr:
        e = self.multiplicative()
        while True:
            t = self.peek()
            if t.kind == OP and t.value in ("+", "-", "||"):
                self.next()
                e = ast.BinaryOp(t.value, e, self.multiplicative())
            else:
                break
        return e

    def multiplicative(self) -> ast.Expr:
        e = self.unary()
        while True:
            t = self.peek()
            if t.kind == OP and t.value in ("*", "/", "%"):
                self.next()
                e = ast.BinaryOp(t.value, e, self.unary())
            else:
                break
        return e

    def unary(self) -> ast.Expr:
        if self.accept_op("-"):
            return ast.UnaryOp("-", self.unary())
        if self.accept_op("+"):
            return self.unary()
        return self.postfix()

    def postfix(self) -> ast.Expr:
        e = self.primary()
        while self.accept_op("::"):
            tname, targs = self.type_name()
            e = ast.Cast(e, tname, targs)
        return e

    def primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == NUM:
            self.next()
            if t.value == "?":
                # placeholder: type resolves from context at bind; the
                # value is pure parameter (never structural)
                return ast.Literal(None, param=t.param, type_hint="PARAM")
            return ast.Literal(_num(t), param=t.param)
        if t.kind == STR:
            self.next()
            return ast.Literal(t.value, param=t.param)
        if t.kind == KW:
            if t.value in ("TRUE", "FALSE"):
                self.next()
                return ast.Literal(t.value == "TRUE")
            if t.value == "NULL":
                self.next()
                return ast.Literal(None)
            if t.value in ("DATE", "TIMESTAMP") and self.peek(1).kind == STR:
                self.next()
                s = self.next()
                return ast.Literal(s.value, param=s.param, type_hint=t.value)
            if t.value == "INTERVAL":
                self.next()
                s = self._mark(self.next())  # value is baked into the plan
                unit = self.ident().lower().rstrip("s")
                val = s.value if s.kind == STR else _num(s)
                return ast.Literal(str(val), param=s.param, type_hint=f"INTERVAL:{unit}")
            if t.value == "CAST":
                self.next()
                self.expect_op("(")
                e = self.expr()
                self.expect_kw("AS")
                tname, targs = self.type_name()
                self.expect_op(")")
                return ast.Cast(e, tname, targs)
            if t.value == "CASE":
                self.next()
                operand = None
                if not self.at_kw("WHEN"):
                    operand = self.expr()
                whens = []
                while self.accept_kw("WHEN"):
                    c = self.expr()
                    self.expect_kw("THEN")
                    whens.append((c, self.expr()))
                else_ = self.expr() if self.accept_kw("ELSE") else None
                self.expect_kw("END")
                return ast.Case(operand, whens, else_)
            if t.value == "EXISTS":
                self.next()
                self.expect_op("(")
                sub = self.select_stmt()
                self.expect_op(")")
                return ast.Exists(sub)
            if t.value == "NOT":
                self.next()
                if self.accept_kw("EXISTS"):
                    self.expect_op("(")
                    sub = self.select_stmt()
                    self.expect_op(")")
                    return ast.Exists(sub, negated=True)
                return ast.UnaryOp("not", self.not_expr())
            if t.value == "EXTRACT":
                self.next()
                self.expect_op("(")
                part = self.ident()
                self.expect_kw("FROM")
                e = self.expr()
                self.expect_op(")")
                return ast.FuncCall("extract_" + part.lower(), [e])
            if t.value == "SUBSTRING":
                self.next()
                self.expect_op("(")
                e = self.expr()
                if self.accept_kw("FROM"):
                    start = self.expr()
                    length = self.expr() if self.accept_kw("FOR") else None
                else:
                    self.expect_op(",")
                    start = self.expr()
                    length = self.expr() if self.accept_op(",") else None
                self.expect_op(")")
                args = [e, start] + ([length] if length else [])
                return ast.FuncCall("substring", args)
        if t.kind == OP and t.value == "(":
            self.next()
            if self.at_kw("SELECT", "WITH"):
                sub = self.select_stmt()
                self.expect_op(")")
                return ast.ScalarSubquery(sub)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == OP and t.value == "*":
            self.next()
            return ast.Star()
        if t.kind == KW and t.value in ("LEFT", "RIGHT", "REPLACE", "IF") \
                and self.peek(1).kind == OP and self.peek(1).value == "(":
            # LEFT/RIGHT/REPLACE/IF are statement keywords but also scalar
            # functions when directly followed by an argument list
            self.next()
            name = t.value.lower()
            self.next()  # '('
            args = []
            if not self.at(OP, ")"):
                while True:
                    args.append(self.expr())
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            return ast.FuncCall(name, args)
        if t.kind in (IDENT, KW):
            name = self.ident()
            # function call
            if self.at(OP, "("):
                self.next()
                if self.accept_op("*"):
                    self.expect_op(")")
                    fc = ast.FuncCall(name.lower(), [], star=True)
                else:
                    distinct = bool(self.accept_kw("DISTINCT"))
                    args = []
                    if not self.at(OP, ")"):
                        while True:
                            args.append(self.expr())
                            if not self.accept_op(","):
                                break
                    self.expect_op(")")
                    fc = ast.FuncCall(name.lower(), args, distinct=distinct)
                if self.at_kw("OVER"):
                    self.next()
                    fc.over = self.window_spec()
                return fc
            # qualified reference: t.c or t.*
            if self.accept_op("."):
                if self.accept_op("*"):
                    return ast.Star(table=name)
                col = self.ident()
                return ast.ColumnRef(col, table=name)
            return ast.ColumnRef(name)
        raise ParserError(f"unexpected token {t.value!r} in expression")


def _num(t: Token):
    return NumText(t.value) if any(c in t.value for c in ".eE") \
        else int(t.value)
