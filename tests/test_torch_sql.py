"""End-to-end single-table SQL of the port against the JAX package and
sqlite: the twins of tests/test_sql.py's cases outside the set-operation,
subquery and join cases that tests/test_torch_relational.py already runs.

The same seeded 20,000-row table t(a, b, c, s) and the small u(k, v) are
loaded into both packages (the JAX package on its CPU backend, the port
with platform="cpu") and into sqlite. Every query of `CASES` (scans and
filters, LIKE, CASE, aggregates, GROUP BY on integers and strings,
HAVING, count over a grouped subquery, ORDER BY, LIMIT/OFFSET, a view)
runs in two modes, as in the reference: on plain segments and after
PRAGMA compact_all_segments. The port's rows must equal the JAX
package's and sqlite's. The scenarios of `TWINS` (DML, ROLLBACK, NULLs,
DATE/DECIMAL with extract, the plan cache, errors, the streamed join
pipeline) run on both packages and return their answers, which must be
equal. Tolerance: integers, DECIMAL, DATE and strings exactly; floats
rounded to 6 decimals before the comparison (the reference's `_norm`).
The reference's `test_differential_fuzz_smoke` runs tools/
fuzz_differential.py; tests/test_torch_tools.py covers its port."""

import importlib
import sqlite3

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch

PKGS = {"jax": adacom_tpu, "port": adacom_tpu_torch}


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


def _db(pkg, **cfg_kw):
    cfg = pkg.DBConfig(**cfg_kw)
    kw = {"platform": "cpu"} if pkg is adacom_tpu_torch else {}
    db = pkg.Database(config=cfg, **kw)
    return db, db.connect()


@pytest.fixture(scope="module")
def engines():
    """({package: connection}, sqlite) over the reference's t and u, with
    the reference's view v1."""
    rng = np.random.default_rng(42)
    n = 20_000
    data = {
        "a": rng.integers(0, 1000, n).astype(np.int64),
        "b": rng.integers(-500, 500, n).astype(np.int64),
        "c": rng.random(n).round(6),
        "s": np.asarray([["red", "green", "blue", "lime", "teal"][k % 5]
                         for k in range(n)], dtype=object),
    }
    u_rows = "(1,'one'),(2,'two'),(3,'three'),(700,'seven hundred')"
    view = "CREATE VIEW v1 AS SELECT a, s FROM t WHERE a < 10"
    dbs, cons = [], {}
    for k, pkg in PKGS.items():
        db, con = _db(pkg, segment_rows=4096)
        con.query("CREATE TABLE t(a BIGINT, b BIGINT, c DOUBLE, s VARCHAR)")
        app = con.appender("t")
        app.append_columns(data)
        app.close()
        con.query("CREATE TABLE u(k BIGINT, v VARCHAR)")
        con.query(f"INSERT INTO u VALUES {u_rows}")
        con.query(view)
        dbs.append(db)
        cons[k] = con
    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE t(a INTEGER, b INTEGER, c REAL, s TEXT)")
    lite.executemany("INSERT INTO t VALUES (?,?,?,?)", zip(
        data["a"].tolist(), data["b"].tolist(), data["c"].tolist(),
        data["s"].tolist()))
    lite.execute("CREATE TABLE u(k INTEGER, v TEXT)")
    lite.execute(f"INSERT INTO u VALUES {u_rows}")
    lite.execute(view)
    yield cons, lite
    lite.close()
    for db in dbs:
        db.close()


def _norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None:
                nr.append(None)
            elif isinstance(v, (bool, np.bool_)):
                nr.append(int(v))
            elif isinstance(v, (float, np.floating)):
                nr.append(round(float(v), 6))
            elif isinstance(v, (int, np.integer)):
                nr.append(int(v))
            elif isinstance(v, np.str_):
                nr.append(str(v))
            else:
                nr.append(v)
        out.append(tuple(nr))
    return out


# (id, SQL, ordered, the SQL for sqlite where it differs)
CASES = [
    ("count_star", "SELECT count(*) FROM t", False, None),
    ("point_lookup", "SELECT a FROM t WHERE a = 123", False, None),
    ("range_filter", "SELECT count(*), sum(a), sum(b) FROM t WHERE a < 100 "
     "AND b >= 0", False, None),
    ("between_and_or", "SELECT count(*) FROM t WHERE a BETWEEN 10 AND 40 OR "
     "b = -7", False, None),
    ("in_list", "SELECT count(*) FROM t WHERE a IN (5, 17, 998)", False,
     None),
    ("not", "SELECT count(*) FROM t WHERE NOT (a < 500)", False, None),
    ("arithmetic_projection", "SELECT a + b, a * 2, a - b, a % 7 FROM t "
     "WHERE a = 77", False, None),
    ("string_eq", "SELECT count(*) FROM t WHERE s = 'green'", False, None),
    ("string_like", "SELECT count(*) FROM t WHERE s LIKE '%e%'", False,
     None),
    ("string_not_like", "SELECT count(*) FROM t WHERE s NOT LIKE 're%'",
     False, None),
    ("neq", "SELECT count(*) FROM t WHERE s <> 'red' AND a <> 5", False,
     None),
    ("case_expr", "SELECT sum(CASE WHEN a < 500 THEN 1 ELSE 0 END), "
     "sum(CASE WHEN b > 0 THEN a ELSE -a END) FROM t", False, None),
    ("ungrouped_aggs", "SELECT count(*), sum(a), min(a), max(a), min(b), "
     "max(b) FROM t", False, None),
    ("avg", "SELECT avg(a), avg(c) FROM t WHERE b > 100", False, None),
    ("group_by_int", "SELECT b, count(*), sum(a) FROM t WHERE a < 50 "
     "GROUP BY b", False, None),
    ("group_by_string", "SELECT s, count(*), sum(a), min(b), max(b) FROM t "
     "GROUP BY s", False, None),
    ("group_by_two_cols", "SELECT s, a % 3, count(*) FROM t WHERE a < 300 "
     "GROUP BY s, a % 3", False, None),
    ("having", "SELECT b, count(*) FROM t GROUP BY b HAVING count(*) > 25",
     False, None),
    ("count_distinct_groups", "SELECT count(*) FROM (SELECT s, count(*) "
     "FROM t GROUP BY s) x", False,
     "SELECT count(*) FROM (SELECT s, count(*) c FROM t GROUP BY s)"),
    ("order_by_limit", "SELECT a, b FROM t WHERE a < 100 ORDER BY a, b "
     "LIMIT 20", True, None),
    ("order_desc", "SELECT a FROM t WHERE b = 17 ORDER BY a DESC", True,
     None),
    ("order_by_alias", "SELECT a + b AS ab FROM t WHERE a < 30 ORDER BY ab "
     "LIMIT 10", True, None),
    ("order_by_string", "SELECT s, count(*) FROM t GROUP BY s ORDER BY s",
     True, None),
    ("limit_offset", "SELECT a FROM t WHERE a < 100 ORDER BY a LIMIT 10 "
     "OFFSET 5", True, None),
    ("view", "SELECT s, count(*) FROM v1 GROUP BY s", False, None),
]


@pytest.mark.parametrize("mode", ["plain", "packed"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sql_case_both_engines(engines, case, mode):
    _name, sql, ordered, lite_sql = case
    cons, lite = engines
    exp = _norm(lite.execute(lite_sql or sql).fetchall())
    got = {}
    for k, con in cons.items():
        con.query("PRAGMA compact_all_segments" if mode == "packed"
                  else "PRAGMA uncompact_all")
        got[k] = _norm(con.query(sql).fetchall())
    if not ordered:
        exp = sorted(exp, key=repr)
        got = {k: sorted(v, key=repr) for k, v in got.items()}
    assert got["port"] == exp, f"[{mode}] port vs sqlite: {sql}"
    assert got["port"] == got["jax"], f"[{mode}] port vs JAX: {sql}"


# ======================================================================
# twins: the reference's scenarios with databases of their own
# ======================================================================


def _sql_error(pkg):
    return importlib.import_module(f"{pkg.__name__}.main.connection").SQLError


def _insert_delete_update(pkg):
    db, con = _db(pkg, segment_rows=1024)
    con.query("CREATE TABLE x(i INTEGER, s VARCHAR)")
    con.query("INSERT INTO x VALUES (1,'a'),(2,'b'),(3,'c')")
    out = [int(con.query("SELECT count(*) FROM x").scalar())]
    con.query("INSERT INTO x SELECT i + 10, s FROM x")
    out.append(int(con.query("SELECT count(*) FROM x").scalar()))
    con.query("DELETE FROM x WHERE i > 10")
    out.append(int(con.query("SELECT count(*) FROM x").scalar()))
    con.query("UPDATE x SET i = i * 100 WHERE s = 'b'")
    out.append(sorted(_norm(con.query("SELECT i FROM x").fetchall())))
    assert out == [3, 6, 3, [(1,), (3,), (200,)]]
    db.close()
    return out


def _transaction_rollback(pkg):
    db, con = _db(pkg)
    con.query("CREATE TABLE x(i INTEGER)")
    con.query("INSERT INTO x VALUES (1),(2)")
    con.query("BEGIN TRANSACTION")
    con.query("INSERT INTO x VALUES (3),(4)")
    out = [int(con.query("SELECT count(*) FROM x").scalar())]
    con.query("ROLLBACK")
    out.append(int(con.query("SELECT count(*) FROM x").scalar()))
    con.query("BEGIN; INSERT INTO x VALUES (9); COMMIT")
    out.append(_norm(con.query("SELECT i FROM x ORDER BY i").fetchall()))
    assert out == [4, 2, [(1,), (2,), (9,)]]
    db.close()
    return out


def _null_handling(pkg):
    db, con = _db(pkg)
    con.query("CREATE TABLE nt(i INTEGER, j INTEGER)")
    con.query("INSERT INTO nt VALUES (1, 10), (2, NULL), (NULL, 30), "
              "(4, 40)")
    qs = ["SELECT count(*) FROM nt", "SELECT count(i) FROM nt",
          "SELECT sum(j) FROM nt", "SELECT count(*) FROM nt WHERE i IS NULL",
          "SELECT count(*) FROM nt WHERE i IS NOT NULL",
          # comparisons with NULL are not true
          "SELECT count(*) FROM nt WHERE i > 0",
          "SELECT count(*) FROM nt WHERE NOT (i > 0)",
          "SELECT coalesce(i, -1) FROM nt WHERE j = 30"]
    out = [int(con.query(q).scalar()) for q in qs]
    assert out == [4, 3, 80, 1, 3, 3, 0, -1]
    db.close()
    return out


def _dates_and_decimals(pkg):
    db, con = _db(pkg)
    con.query("CREATE TABLE o(d DATE, price DECIMAL(12,2))")
    con.query("INSERT INTO o VALUES ('1994-01-15', 10.50), "
              "('1994-03-01', 20.25), ('1995-01-01', 1.00)")
    out = [int(con.query("SELECT count(*) FROM o WHERE d < DATE "
                         "'1994-06-01'").scalar()),
           int(con.query("SELECT count(*) FROM o WHERE d >= DATE "
                         "'1994-01-01' AND d < DATE '1994-01-01' + "
                         "INTERVAL '1' YEAR").scalar()),
           con.query("SELECT sum(price) FROM o").scalar(),
           _norm(con.query("SELECT extract(year FROM d), count(*) FROM o "
                           "GROUP BY 1 ORDER BY 1").fetchall()),
           _norm(con.query("SELECT d, price FROM o ORDER BY d").fetchall())]
    assert out[:2] == [2, 2] and abs(float(out[2]) - 31.75) < 1e-9
    assert out[3] == [(1994, 2), (1995, 1)]
    db.close()
    return out


def _plan_cache_hit(pkg):
    db, con = _db(pkg)
    con.query("CREATE TABLE pc(i UINTEGER)")
    app = con.appender("pc")
    app.append_column("i", np.arange(10000, dtype=np.uint32))
    app.close()
    out = [int(con.query(f"SELECT i FROM pc WHERE i = {v}").scalar())
           for v in (5, 17, 4999, 9999)]
    assert out == [5, 17, 4999, 9999]
    out.append(len(db.plan_cache))
    assert out[-1] <= 2  # one template (and its alias key)
    db.close()
    return out


def _errors(pkg):
    db, con = _db(pkg)
    err = _sql_error(pkg)
    for sql in ("SELECT * FROM missing_table", "SELEC 1"):
        with pytest.raises(err):
            con.query(sql)
    con.query("CREATE TABLE e(i INTEGER)")
    with pytest.raises(Exception):
        con.query("CREATE TABLE e(i INTEGER)")
    con.query("CREATE TABLE IF NOT EXISTS e(i INTEGER)")
    out = [sorted(db.catalog.tables)]
    db.close()
    return out


def _streaming_join_pipeline_engages(pkg):
    """A base-table probe side streams morsel by morsel through the native
    hash table; dist_stats shows it."""
    db, con = _db(pkg, segment_rows=2048)
    con.query("CREATE TABLE f(k INTEGER, v BIGINT)")
    rng = np.random.default_rng(17)
    k = rng.integers(0, 3000, 50_000).astype(np.int32)
    v = rng.integers(0, 10_000, 50_000)
    app = con.appender("f")
    app.append_columns({"k": k, "v": v})
    app.close()
    con.query("CREATE TABLE d(k INTEGER, grp INTEGER)")
    dk = np.arange(3000, dtype=np.int32)
    app = con.appender("d")
    app.append_columns({"k": dk, "grp": (dk % 7).astype(np.int32)})
    app.close()
    r = _norm(con.query(
        "SELECT d.grp, sum(f.v), count(*) FROM f JOIN d ON f.k = d.k "
        "WHERE f.v >= 100 GROUP BY d.grp ORDER BY d.grp").fetchall())
    assert db.dist_stats.get("streamed_join", 0) + \
        db.dist_stats.get("streamed_join_agg", 0) > 0, \
        "the streamed join did not engage"
    m = v >= 100
    want = [(g, int(v[m & (k % 7 == g)].sum()), int((m & (k % 7 == g)).sum()))
            for g in range(7)]
    assert r == want
    db.close()
    return r


TWINS = {f.__name__.lstrip("_"): f for f in (
    _insert_delete_update, _transaction_rollback, _null_handling,
    _dates_and_decimals, _plan_cache_hit, _errors,
    _streaming_join_pipeline_engages)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_of_test_sql(name):
    got = {k: TWINS[name](pkg) for k, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
