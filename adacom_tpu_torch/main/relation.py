"""Relation API: composable lazy query building (reference
src/main/relation.cpp + relation/*.cpp — Connection::Table/Values and
the filter/project/aggregate/join/order/limit combinators). Port of
adacom_tpu/main/relation.py.

Relations compose by SQL-text construction over named subqueries, so
every combinator rides the full optimizer/executor stack at execution:

    con.table("lineitem").filter("l_quantity > 10") \\
       .aggregate("l_returnflag, sum(l_quantity) AS q", "l_returnflag") \\
       .order("l_returnflag").fetchall()
"""

from __future__ import annotations

from typing import Optional


class Relation:
    def __init__(self, connection, sql: str):
        self.con = connection
        self._sql = sql

    # ---------------- combinators (lazy) ----------------
    def _wrap(self, select: str, suffix: str = "") -> "Relation":
        return Relation(self.con,
                        f"SELECT {select} FROM ({self._sql}) __r{suffix}")

    def filter(self, condition: str) -> "Relation":
        return Relation(self.con,
                        f"SELECT * FROM ({self._sql}) __r WHERE {condition}")

    where = filter

    def project(self, exprs: str) -> "Relation":
        return self._wrap(exprs)

    select = project

    def aggregate(self, aggs: str, group: Optional[str] = None) -> "Relation":
        g = f" GROUP BY {group}" if group else ""
        return Relation(self.con,
                        f"SELECT {aggs} FROM ({self._sql}) __r{g}")

    def order(self, keys: str) -> "Relation":
        return Relation(self.con,
                        f"SELECT * FROM ({self._sql}) __r ORDER BY {keys}")

    sort = order

    def limit(self, n: int, offset: int = 0) -> "Relation":
        off = f" OFFSET {int(offset)}" if offset else ""
        return Relation(self.con,
                        f"SELECT * FROM ({self._sql}) __r LIMIT {int(n)}{off}")

    def join(self, other: "Relation", condition: str,
             how: str = "inner") -> "Relation":
        kw = {"inner": "JOIN", "left": "LEFT JOIN", "right": "RIGHT JOIN",
              "full": "FULL JOIN"}[how]
        return Relation(
            self.con,
            f"SELECT * FROM ({self._sql}) __l {kw} ({other._sql}) __rr "
            f"ON {condition}")

    def distinct(self) -> "Relation":
        return Relation(self.con,
                        f"SELECT DISTINCT * FROM ({self._sql}) __r")

    def union(self, other: "Relation", all: bool = True) -> "Relation":
        op = "UNION ALL" if all else "UNION"
        return Relation(self.con, f"({self._sql}) {op} ({other._sql})")

    def sample(self, n: int) -> "Relation":
        return Relation(self.con,
                        f"SELECT * FROM ({self._sql}) __r USING SAMPLE {int(n)}")

    # ---------------- execution ----------------
    @property
    def sql(self) -> str:
        return self._sql

    def execute(self):
        return self.con.query(self._sql)

    def fetchall(self):
        return self.execute().fetchall()

    def fetchone(self):
        return self.execute().fetchone()

    def scalar(self):
        return self.execute().scalar()

    def fetchdf(self):
        return self.execute().fetchdf()

    df = fetchdf

    def arrow(self):
        return self.execute().fetch_arrow_table()

    def count(self) -> int:
        return int(self.con.query(
            f"SELECT count(*) FROM ({self._sql}) __r").scalar())

    def create_view(self, name: str, replace: bool = True) -> "Relation":
        orr = "OR REPLACE " if replace else ""
        self.con.query(f"CREATE {orr}VIEW {name} AS {self._sql}")
        return self

    def to_table(self, name: str) -> None:
        self.con.query(f"CREATE TABLE {name} AS {self._sql}")

    def explain(self) -> str:
        return self.con.query(f"EXPLAIN {self._sql}").fetchone()[0]

    def __repr__(self):
        return f"<Relation {self._sql[:120]!r}>"
