"""Subquery results belong to one execution, not to the plan that the plan
cache shares between connections (ROADMAP queue C item 2).

Two connections of one database run one query template with different
literals, so they share one cached plan. `Interleave` holds the first
connection after its subqueries are evaluated and before the plan that
reads them runs, until the second connection has evaluated its own. A
plan that kept the results on its nodes then gives the first connection
the second one's results. The port answers each connection with its own
(sqlite is the oracle); the JAX package, whose executor stores them on
the shared plan, is forced the same way and answers the first connection
with the second one's result (or, where the first one's is NULL, the
second with the first one's), asserted beside the port's.

Cases: a scalar subquery, a NULL scalar result, EXISTS, IN (in an OR, so
that it is not rewritten to a semi join), and a nested scalar subquery.
Then TPC-H Q15 as written, at SF 0.01 with the benchmark's generator,
three connections on different quarters at once and a forced pair,
against sqlite and against the benchmark's plain reference; and a plan
with a subquery that serialization round-trips with no runtime field."""

import json
import os
import sqlite3
import sys
import threading
from fractions import Fraction

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch as att
from adacom_tpu.exec import executor as jax_executor
from adacom_tpu_torch.exec import executor as port_executor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import compare, registry  # noqa: E402

N = 5000
WAIT_S = 60


@pytest.fixture(scope="module", autouse=True)
def _cold_pallas_runner_caches():
    """tests/test_pallas.py counts its Pallas runner caches' misses: leave
    them cold for the modules that run after this one in the process."""
    yield
    from adacom_tpu.ops import pallas_scan

    for f in vars(pallas_scan).values():
        if hasattr(f, "cache_clear") and \
                getattr(f, "__module__", None) == pallas_scan.__name__:
            f.cache_clear()


class Interleave:
    """Patches `executor_cls` so that a statement run on a thread marked
    "a" stops after its subqueries are evaluated, at the first `_exec` of
    its root plan, until a statement on a thread marked "b" has reached
    the same point. `execute` is the root call when it is not nested in
    another on its thread."""

    def __init__(self, monkeypatch, executor_cls):
        self.local = threading.local()
        self.a_ready = threading.Event()
        self.b_ready = threading.Event()
        real_execute, real_exec = executor_cls.execute, executor_cls._exec
        loc = self.local

        def execute(ex, plan, lits):
            depth = getattr(loc, "depth", 0)
            if depth == 0:
                loc.root = plan
            loc.depth = depth + 1
            try:
                return real_execute(ex, plan, lits)
            finally:
                loc.depth = depth

        def _exec(ex, node, lits):
            role = getattr(loc, "role", None)
            if role is not None and node is loc.root:
                loc.role = None
                if role == "a":
                    self.a_ready.set()
                    assert self.b_ready.wait(WAIT_S), "b never reached its plan"
                else:
                    self.b_ready.set()
            return real_exec(ex, node, lits)

        monkeypatch.setattr(executor_cls, "execute", execute)
        monkeypatch.setattr(executor_cls, "_exec", _exec)

    def run(self, con_a, sql_a, con_b, sql_b):
        """(a's rows, b's rows), b started once a holds its results."""
        out, errors = {}, []

        def client(role, con, sql):
            self.local.role = role
            try:
                out[role] = con.query(sql).fetchall()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
                self.a_ready.set()
                self.b_ready.set()

        ta = threading.Thread(target=client, args=("a", con_a, sql_a))
        ta.start()
        assert self.a_ready.wait(WAIT_S), "a never reached its plan"
        tb = threading.Thread(target=client, args=("b", con_b, sql_b))
        tb.start()
        tb.join(WAIT_S)
        ta.join(WAIT_S)
        assert not ta.is_alive() and not tb.is_alive()
        assert not errors, errors
        return out["a"], out["b"]


def _rows():
    rng = np.random.default_rng(22)
    k = rng.integers(0, 10, N).astype(np.int32)
    return k, (k.astype(np.int64) * 100 + rng.integers(0, 100, N))


def _fill(con, k, v):
    con.query("CREATE TABLE t(k INTEGER, v BIGINT)")
    app = con.appender("t")
    app.append_columns({"k": k, "v": v})
    app.close()


@pytest.fixture(scope="module")
def tables():
    k, v = _rows()
    lite = sqlite3.connect(":memory:", check_same_thread=False)
    lite.execute("CREATE TABLE t(k INTEGER, v BIGINT)")
    lite.executemany("INSERT INTO t VALUES (?, ?)", zip(k.tolist(), v.tolist()))
    port = att.Database(platform="cpu")
    _fill(port.connect(), k, v)
    jdb = adacom_tpu.Database()
    _fill(jdb.connect(), k, v)
    yield port, jdb, lite
    port.close()
    jdb.close()


CASES = {
    "scalar": ("SELECT count(*) FROM t WHERE v <= (SELECT max(v) FROM t WHERE k = {x})",
               2, 7),
    # a template of its own: the JAX package keeps the NULL test of the
    # first execution it traced for a template
    "scalar_null": ("SELECT count(*) FROM t WHERE v < (SELECT max(v) FROM t WHERE k = {x})",
                    50, 7),
    "exists": ("SELECT count(*) FROM t WHERE EXISTS (SELECT k FROM t WHERE k = {x})",
               3, 99),
    "in": ("SELECT count(*) FROM t WHERE v < 0 OR k IN (SELECT k FROM t WHERE v > {x})",
           850, 150),
    "nested": ("SELECT count(*) FROM t WHERE v > (SELECT avg(v) FROM t WHERE "
               "v < (SELECT max(v) FROM t WHERE k = {x}))", 2, 7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forced_interleaving_keeps_each_connections_result(tables, monkeypatch, case):
    port, jdb, lite = tables
    tpl, xa, xb = CASES[case]
    sql_a, sql_b = tpl.format(x=xa), tpl.format(x=xb)
    want_a = lite.execute(sql_a).fetchall()
    want_b = lite.execute(sql_b).fetchall()
    assert want_a != want_b
    # one plan for both: the first run caches it, the second hits it
    con_a, con_b = port.connect(), port.connect()
    assert con_a.query(sql_a).fetchall() == want_a
    hook = Interleave(monkeypatch, port_executor.Executor)
    got_a, got_b = hook.run(con_a, sql_a, con_b, sql_b)
    assert hook.a_ready.is_set() and hook.b_ready.is_set()
    assert (got_a, got_b) == (want_a, want_b)

    # the JAX package, forced the same way: a reads b's result; where a's
    # result is NULL, b reads a's instead (its compiled expression keeps the
    # NULL test that its first execution traced, whatever runs later)
    monkeypatch.undo()
    jcon_a, jcon_b = jdb.connect(), jdb.connect()
    assert [tuple(r) for r in jcon_a.query(sql_a).fetchall()] == want_a
    jhook = Interleave(monkeypatch, jax_executor.Executor)
    jgot = [[tuple(r) for r in rows] for rows in jhook.run(jcon_a, sql_a, jcon_b, sql_b)]
    assert jgot == ([want_a, want_a] if case == "scalar_null" else [want_b, want_b])


def test_null_and_nested_results_alone(tables):
    port, _jdb, lite = tables
    con = port.connect()
    for sql in ("SELECT (SELECT max(v) FROM t WHERE k = 50) IS NULL",
                "SELECT count(*) FROM t WHERE v <= (SELECT max(v) FROM t WHERE k = 50)",
                "SELECT count(*) FROM t WHERE v > (SELECT avg(v) FROM t WHERE "
                "v < (SELECT max(v) FROM t WHERE k = (SELECT min(k) + 4 FROM t)))",
                "SELECT count(*) FROM t WHERE k IN (SELECT k FROM t WHERE v > 99999) OR v < 0",
                "SELECT count(*) FROM t WHERE NOT EXISTS (SELECT k FROM t WHERE k = 99)"):
        want = lite.execute(sql).fetchall()
        assert [tuple(int(x) for x in r) for r in con.query(sql).fetchall()] == want, sql


def test_plan_holds_no_subquery_result(tables):
    """After an execution the shared plan is as it was planned: its
    BSubquery nodes carry no field for a result, and its JSON round-trips
    to the same rows."""
    from adacom_tpu_torch.sql import bound as b
    from adacom_tpu_torch.sql.parser import parse
    from adacom_tpu_torch.sql.serialize import deserialize_plan, serialize_plan

    port, _jdb, lite = tables
    con = port.connect()
    sql = CASES["nested"][0].format(x=7)
    rows = con.query(sql).fetchall()
    _stmts, key, lits, _structural = parse(sql)
    plans = [p for k, p in port.plan_cache.items() if k[0] == key]
    assert len(plans) == 1
    subqueries = [e for n in b.walk(plans[0]) for x in b.iter_node_exprs(n)
                  for e in b.expr_walk(x) if isinstance(e, b.BSubquery)]
    assert subqueries and not any(hasattr(e, "cached_value") for e in subqueries)
    payload = json.dumps(serialize_plan(plans[0], port.catalog))
    assert "cached_value" not in payload
    again = port_executor.Executor(port).execute(
        deserialize_plan(json.loads(payload), port.catalog), lits)
    assert [tuple(int(c[i]) for c in again.cols) for i in range(again.nrows)] \
        == rows == lite.execute(sql).fetchall()


# ---------------------------------------------------------------- Q15
Q15 = registry.load_json("traffic", "q15")["templates"]["q15"]
QUARTERS = [("1993-01-01", "1993-04-01"), ("1994-07-01", "1994-10-01"),
            ("1995-10-01", "1996-01-01"), ("1996-02-01", "1996-05-01"),
            ("1997-08-01", "1997-11-01"), ("1993-11-01", "1994-02-01"),
            ("1995-03-01", "1995-06-01"), ("1996-11-01", "1997-02-01"),
            ("1994-01-01", "1994-04-01"), ("1997-01-01", "1997-04-01"),
            ("1995-06-01", "1995-09-01"), ("1993-06-01", "1993-09-01")]
LITE_Q15 = """
WITH revenue AS (SELECT supp AS supplier_no, sum(p * (100 - d)) AS total_revenue
                 FROM lineitem WHERE ship >= ? AND ship < ? GROUP BY supp)
SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier, revenue
WHERE s_suppkey = supplier_no AND total_revenue = (SELECT max(total_revenue) FROM revenue)
ORDER BY s_suppkey"""


@pytest.fixture(scope="module")
def q15():
    """TPC-H lineitem and supplier at SF 0.01 from the benchmark's
    generator, in the port, sqlite and the benchmark's reference."""
    spec = registry.load_spec()
    desc = registry.config_desc(spec, "tpch_sf10_q15")
    desc["scale_factor"] = 0.01
    data = registry.load_module("configs", "tpch_sf10_q15").generate(desc, 2**31 + 22)
    db = att.Database(platform="cpu")
    con = db.connect()
    for table, cols in desc["tables"].items():
        con.query(f"CREATE TABLE {table}("
                  + ", ".join(f"{c} {t}" for c, t in cols.items()) + ")")
        app = con.appender(table)
        app.append_columns({c: data[table][c] for c in cols})
        app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    lite = sqlite3.connect(":memory:", check_same_thread=False)
    li, su = data["lineitem"], data["supplier"]
    lite.execute("CREATE TABLE lineitem(p INTEGER, d INTEGER, ship TEXT, supp INTEGER)")
    ship = np.datetime_as_string(li["l_shipdate"].astype("datetime64[D]"))
    lite.executemany("INSERT INTO lineitem VALUES (?,?,?,?)", zip(
        li["l_extendedprice"].tolist(), li["l_discount"].tolist(), ship.tolist(),
        li["l_suppkey"].tolist()))
    lite.execute("CREATE TABLE supplier(s_suppkey INTEGER, s_name TEXT, s_address TEXT, "
                 "s_phone TEXT)")
    lite.executemany("INSERT INTO supplier VALUES (?,?,?,?)", zip(
        su["s_suppkey"].tolist(), list(su["s_name"]), list(su["s_address"]),
        list(su["s_phone"])))
    ref = registry.load_module("reference", "tpch_sf10_q15").Reference(data)
    yield db, lite, ref
    db.close()


def _sql(quarter):
    return "\n".join(Q15["sql"]).format(date=quarter[0], date_end=quarter[1])


def _check(got, quarter, lite, ref):
    """The port's answer against sqlite's and the reference's: the same
    rows and strings, revenues to a rounding of the exact DECIMAL."""
    params = {"date": quarter[0], "date_end": quarter[1]}
    want = [(k, n, a, ph, Fraction(r, 10**4))
            for k, n, a, ph, r in lite.execute(LITE_Q15, quarter).fetchall()]
    assert want and ref.tpch_q15(params) == want
    wrong, gap = compare.answer_gap(got, want)
    assert not wrong and gap < 1e-12, (quarter, got, want)


def test_q15_three_connections_on_different_quarters(q15):
    db, lite, ref = q15
    per_client = [QUARTERS[c::3] for c in range(3)]
    got = [[] for _ in range(3)]
    start = threading.Barrier(3)

    def client(c):
        con = db.connect()
        start.wait()
        for _round in range(2):
            for quarter in per_client[c]:
                got[c].append((quarter, con.query(_sql(quarter)).fetchall()))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S * 4)
    assert not any(t.is_alive() for t in threads)
    assert sum(len(g) for g in got) == 2 * len(QUARTERS)
    for answers in got:
        for quarter, rows in answers:
            _check(rows, quarter, lite, ref)


def test_q15_forced_interleaving(q15, monkeypatch):
    db, lite, ref = q15
    qa, qb = QUARTERS[0], QUARTERS[4]
    con_a, con_b = db.connect(), db.connect()
    _check(con_a.query(_sql(qa)).fetchall(), qa, lite, ref)
    hook = Interleave(monkeypatch, port_executor.Executor)
    got_a, got_b = hook.run(con_a, _sql(qa), con_b, _sql(qb))
    _check(got_a, qa, lite, ref)
    _check(got_b, qb, lite, ref)
