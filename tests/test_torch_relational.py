"""The port's host plan nodes: joins of every type (NULL keys included),
the index join, the streamed probe and the streamed join -> aggregate
pipeline, VALUES, FROM-less SELECT, SAMPLE, DISTINCT and the set
operations, the host scan's move to the device path, the bounded pool
cache, and the client modules (relation API, verification, COPY and the
read_* table functions) against the JAX package.

Oracles: sqlite3 where the JAX package is not SQL (a NULL join key, a
FROM-less SELECT, set operations over NULLs; ROADMAP queue C), the JAX
package on the set-operation and subquery cases of tests/test_sql.py
(run on both engines and sqlite), numpy elsewhere. Floats agree to 1e-9
relative; everything else is exact."""

import math
import sqlite3

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu_torch.exec import device_scan


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
                nr.append(float(v))
            elif isinstance(v, (int, np.integer)):
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return out


def _same(got, exp, what):
    got, exp = sorted(_norm(got), key=repr), sorted(_norm(exp), key=repr)
    assert len(got) == len(exp), f"{what}: {len(got)} rows != {len(exp)}\n" \
                                 f" got {got[:6]}\n exp {exp[:6]}"
    for g, e in zip(got, exp):
        assert len(g) == len(e), (what, g, e)
        for a, b in zip(g, e):
            if isinstance(a, float) or isinstance(b, float):
                assert a is not None and b is not None and math.isclose(
                    a, b, rel_tol=1e-9, abs_tol=1e-9), (what, g, e)
            else:
                assert a == b, f"{what}: {g} != {e}"


def _port(segment_rows=1024, **cfg):
    config = adacom_tpu_torch.DBConfig()
    config.segment_rows = segment_rows
    for k, v in cfg.items():
        setattr(config, k, v)
    db = adacom_tpu_torch.Database(platform="cpu", config=config)
    return db, db.connect()


# ======================================================================
# joins with NULL keys, against sqlite
# ======================================================================

N_L, N_R = 6000, 700


@pytest.fixture(scope="module")
def nulls():
    rng = np.random.default_rng(0x7011)
    lk = rng.integers(0, 400, N_L).astype(np.int32)
    lk2 = rng.integers(0, 3, N_L).astype(np.int32)
    la = rng.integers(-100, 100, N_L).astype(np.int32)
    rk = rng.integers(0, 500, N_R).astype(np.int32)
    rk2 = rng.integers(0, 3, N_R).astype(np.int32)
    rb = rng.integers(-100, 100, N_R).astype(np.int32)
    lv, rv = rng.random(N_L) > 0.1, rng.random(N_R) > 0.15
    lv2, rv2 = rng.random(N_L) > 0.05, rng.random(N_R) > 0.05
    # a key whose value under NULL would match: 0 is a real key value
    lk[~lv] = 0
    rk[~rv] = 0
    db, con = _port()
    con.query("CREATE TABLE l(k INTEGER, k2 INTEGER, a INTEGER)")
    con.query("CREATE TABLE r(k INTEGER, k2 INTEGER, b INTEGER)")
    app = con.appender("l")
    app.append_columns({"k": lk, "k2": lk2, "a": la}, {"k": lv, "k2": lv2})
    app.close()
    app = con.appender("r")
    app.append_columns({"k": rk, "k2": rk2, "b": rb}, {"k": rv, "k2": rv2})
    app.close()
    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE l(k INTEGER, k2 INTEGER, a INTEGER)")
    lite.execute("CREATE TABLE r(k INTEGER, k2 INTEGER, b INTEGER)")

    def rows(k, kv, k2, k2v, x):
        return [(int(a) if va else None, int(b) if vb else None, int(c))
                for a, va, b, vb, c in zip(k, kv, k2, k2v, x)]

    lite.executemany("INSERT INTO l VALUES (?,?,?)", rows(lk, lv, lk2, lv2, la))
    lite.executemany("INSERT INTO r VALUES (?,?,?)", rows(rk, rv, rk2, rv2, rb))
    yield db, con, lite
    db.close()


JOINS = {
    "inner": "SELECT l.k, l.a, r.b FROM l JOIN r ON l.k = r.k",
    "inner two keys": "SELECT l.a, r.b FROM l JOIN r ON l.k = r.k AND l.k2 = r.k2",
    "left": "SELECT l.k, l.a, r.b FROM l LEFT JOIN r ON l.k = r.k",
    "right": "SELECT l.a, r.k, r.b FROM l RIGHT JOIN r ON l.k = r.k",
    "full": "SELECT l.a, r.b FROM l FULL OUTER JOIN r ON l.k = r.k",
    "semi (IN)": "SELECT k, a FROM l WHERE k IN (SELECT k FROM r)",
    "semi (EXISTS)": "SELECT k, a FROM l WHERE EXISTS "
                     "(SELECT 1 FROM r WHERE r.k = l.k AND r.k2 = l.k2)",
    "anti (NOT EXISTS)": "SELECT k, a FROM l WHERE NOT EXISTS "
                         "(SELECT 1 FROM r WHERE r.k = l.k)",
    "cross": "SELECT count(*), sum(l.a), sum(r.b) FROM l, r "
             "WHERE l.a = 7 AND r.b > 90",
    "residual": "SELECT l.a, r.b FROM l JOIN r ON l.k = r.k AND l.a < r.b",
    "left residual": "SELECT l.k, l.a, r.b FROM l LEFT JOIN r "
                     "ON l.k = r.k AND l.a < r.b",
    "semi residual": "SELECT k, a FROM l WHERE EXISTS "
                     "(SELECT 1 FROM r WHERE r.k = l.k AND r.b > l.a)",
    "anti residual": "SELECT k, a FROM l WHERE NOT EXISTS "
                     "(SELECT 1 FROM r WHERE r.k = l.k AND r.b > l.a)",
    "grouped over left join": "SELECT (l.a + 100) % 5, count(*), "
                              "count(r.b), sum(r.b) FROM l LEFT JOIN r "
                              "ON l.k = r.k GROUP BY (l.a + 100) % 5",
    "NOT IN, no NULL on either side": "SELECT count(*) FROM l WHERE a NOT IN "
                                      "(SELECT k FROM r WHERE k IS NOT NULL)",
}


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["streamed", "materialized"])
@pytest.mark.parametrize("name", sorted(JOINS))
def test_join_null_keys_vs_sqlite(nulls, name, streaming):
    db, con, lite = nulls
    sql = JOINS[name]
    con.query(f"SET streaming_join_enabled={str(streaming).lower()}")
    try:
        got = con.query(sql).fetchall()
    finally:
        con.query("SET streaming_join_enabled=true")
    _same(got, lite.execute(sql).fetchall(), name)


@pytest.mark.parametrize("outer, inner", [
    ("a", "SELECT k FROM r"),                        # a NULL in the subquery
    ("k", "SELECT k FROM r WHERE k IS NOT NULL"),    # a NULL outer value
    ("k", "SELECT k FROM r WHERE b > 1000"),         # an empty subquery
])
def test_not_in_with_nulls_follows_the_rewrite(nulls, outer, inner):
    """NOT IN has SQL's null-aware semantics, as sqlite answers: no row
    survives a NULL in the subquery (x NOT IN (..., NULL) is never true),
    a NULL outer value survives only an empty subquery, where every row
    survives. The binder's anti join carries the rule (null_aware);
    NOT EXISTS keeps the plain anti join's answer."""
    db, con, lite = nulls
    sql = f"SELECT count(*) FROM l WHERE {outer} NOT IN ({inner})"
    _same(con.query(sql).fetchall(), lite.execute(sql).fetchall(), sql)
    sql = (f"SELECT count(*) FROM l WHERE NOT EXISTS (SELECT 1 FROM "
           f"({inner}) s WHERE s.k = l.{outer})")
    _same(con.query(sql).fetchall(), lite.execute(sql).fetchall(), sql)


def test_streamed_probe_engages_on_null_keys(nulls):
    db, con, lite = nulls
    before = db.dist_stats.get("streamed_join", 0)
    sql = JOINS["semi (IN)"]
    _same(con.query(sql).fetchall(), lite.execute(sql).fetchall(), "semi")
    assert db.dist_stats.get("streamed_join", 0) > before


# ======================================================================
# the index join and the streamed join -> aggregate pipeline
# ======================================================================


@pytest.fixture(scope="module")
def star():
    rng = np.random.default_rng(0x5CA1)
    n, m = 40_000, 3_000
    data = {"fk": rng.integers(0, m, n).astype(np.int64),
            "v": rng.integers(0, 10_000, n).astype(np.int64),
            "q": rng.integers(1, 50, n).astype(np.int32)}
    dim = {"pk": np.arange(m, dtype=np.int64),
           "grp": (np.arange(m) % 7).astype(np.int32),
           "w": rng.integers(0, 100, m).astype(np.int32)}
    db, con = _port(segment_rows=4096)
    con.query("CREATE TABLE f(fk BIGINT, v BIGINT, q INTEGER)")
    con.query("CREATE TABLE d(pk BIGINT, grp INTEGER, w INTEGER)")
    for t, cols in (("f", data), ("d", dim)):
        app = con.appender(t)
        app.append_columns(cols)
        app.close()
    con.query("CREATE INDEX f_fk ON f(fk)")
    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE f(fk INTEGER, v INTEGER, q INTEGER)")
    lite.execute("CREATE TABLE d(pk INTEGER, grp INTEGER, w INTEGER)")
    lite.executemany("INSERT INTO f VALUES (?,?,?)",
                     zip(*(data[c].tolist() for c in ("fk", "v", "q"))))
    lite.executemany("INSERT INTO d VALUES (?,?,?)",
                     zip(*(dim[c].tolist() for c in ("pk", "grp", "w"))))
    lite.execute("CREATE INDEX d_pk ON d(pk)")
    lite.execute("CREATE INDEX f_fk ON f(fk)")
    yield db, con, lite
    db.close()


def _counted(db, con, sql, counter, **off):
    """The answer with the route on (its counter must rise) and with the
    route's knobs switched off (the materializing path)."""
    before = db.dist_stats.get(counter, 0)
    got = con.query(sql).fetchall()
    assert db.dist_stats.get(counter, 0) > before, f"{counter} did not run"
    saved = {k: getattr(db.config, k) for k in off}
    for k, v in off.items():
        setattr(db.config, k, v)
    try:
        before = db.dist_stats.get(counter, 0)
        plain = con.query(sql).fetchall()
        assert db.dist_stats.get(counter, 0) == before
    finally:
        for k, v in saved.items():
            setattr(db.config, k, v)
    return got, plain


@pytest.mark.parametrize("sql", [
    "SELECT d.grp, f.v, f.q FROM d JOIN f ON f.fk = d.pk WHERE d.w = 3",
    "SELECT d.grp, sum(f.v), count(*) FROM d JOIN f ON f.fk = d.pk "
    "WHERE d.w = 3 GROUP BY d.grp",
])
def test_index_join(star, sql):
    db, con, lite = star
    got, plain = _counted(db, con, sql, "index_join", index_join_max_probe=0)
    _same(got, plain, "index join vs scan")
    _same(got, lite.execute(sql).fetchall(), "index join vs sqlite")


@pytest.mark.parametrize("sql", [
    "SELECT d.grp, sum(f.v), count(*), min(f.q), max(f.v) FROM f "
    "JOIN d ON f.fk = d.pk WHERE f.v >= 100 GROUP BY d.grp",
    "SELECT d.grp, sum(f.v * f.q), avg(f.q) FROM f JOIN d ON f.fk = d.pk "
    "AND f.q > d.w GROUP BY d.grp",
    "SELECT f.q % 7, count(*), count(d.w), sum(d.w) FROM f LEFT JOIN d "
    "ON f.fk = d.pk AND d.w < 50 GROUP BY f.q % 7",
    "SELECT count(*), sum(v) FROM f WHERE NOT EXISTS "
    "(SELECT 1 FROM d WHERE d.pk = f.fk AND d.w > 90)",
])
def test_streamed_join_aggregate(star, sql):
    db, con, lite = star
    con.query("SET index_join_max_probe=0")
    try:
        got, plain = _counted(db, con, sql, "streamed_join_agg",
                              streaming_agg_sink_enabled=False)
        _, no_stream = _counted(db, con, sql, "streamed_join_agg",
                                streaming_join_enabled=False)
    finally:
        con.query("SET index_join_max_probe=8192")
    _same(got, plain, "streamed aggregate vs host aggregate")
    _same(got, no_stream, "streamed aggregate vs materialized join")
    _same(got, lite.execute(sql).fetchall(), "streamed aggregate vs sqlite")


# ======================================================================
# tests/test_sql.py's set-operation, subquery and join cases on both
# engines, against sqlite
# ======================================================================


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(42)
    n = 20_000
    data = {
        "a": rng.integers(0, 1000, n).astype(np.int64),
        "b": rng.integers(-500, 500, n).astype(np.int64),
        "c": rng.random(n).round(6),
        "s": np.asarray([["red", "green", "blue", "lime", "teal"][k % 5]
                         for k in range(n)], dtype=object),
    }
    out = []
    for mod, kw in ((adacom_tpu_torch, {"platform": "cpu"}), (adacom_tpu, {})):
        db = mod.Database(config=mod.DBConfig(segment_rows=4096), **kw)
        con = db.connect()
        con.query("CREATE TABLE t(a BIGINT, b BIGINT, c DOUBLE, s VARCHAR)")
        app = con.appender("t")
        app.append_columns(data)
        app.close()
        con.query("CREATE TABLE u(k BIGINT, v VARCHAR)")
        con.query("INSERT INTO u VALUES (1,'one'),(2,'two'),(3,'three'),"
                  "(700,'seven hundred')")
        con.query("CREATE TABLE x(v BIGINT)")
        con.query("INSERT INTO x VALUES (10)")
        out.append(con)
    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE t(a INTEGER, b INTEGER, c REAL, s TEXT)")
    lite.executemany("INSERT INTO t VALUES (?,?,?,?)", zip(
        data["a"].tolist(), data["b"].tolist(), data["c"].tolist(),
        data["s"].tolist()))
    lite.execute("CREATE TABLE u(k INTEGER, v TEXT)")
    lite.executemany("INSERT INTO u VALUES (?,?)", [
        (1, "one"), (2, "two"), (3, "three"), (700, "seven hundred")])
    lite.execute("CREATE TABLE x(v INTEGER)")
    lite.execute("INSERT INTO x VALUES (10)")
    return out[0], out[1], lite


SQL_CASES = [
    "SELECT DISTINCT s FROM t",
    "SELECT a FROM t WHERE a = 1 UNION ALL SELECT a FROM t WHERE a = 2",
    "SELECT s FROM t WHERE a < 100 UNION SELECT v FROM u",
    "SELECT DISTINCT a FROM t WHERE a < 20 EXCEPT SELECT a FROM t "
    "WHERE a IN (5, 7)",
    "SELECT DISTINCT a FROM t WHERE a < 50 INTERSECT SELECT k FROM u",
    "SELECT u.v, count(*) FROM t JOIN u ON t.a = u.k GROUP BY u.v",
    "SELECT u.k, count(t.a) FROM u LEFT JOIN t ON t.a = u.k GROUP BY u.k",
    "SELECT t.a, t.b, u.v FROM t, u WHERE t.a = u.k AND t.b > 400",
    "SELECT count(*) FROM u u1 JOIN u u2 ON u1.k = u2.k",
    "SELECT count(*) FROM u u1, u u2",
    "SELECT s, total FROM (SELECT s, sum(a) AS total FROM t GROUP BY s) x "
    "WHERE total > 0",
    "WITH big AS (SELECT a, b FROM t WHERE a > 900) SELECT count(*), min(a) "
    "FROM big",
    "SELECT count(*) FROM t WHERE a > (SELECT avg(a) FROM t)",
    "SELECT count(*) FROM t WHERE a IN (SELECT k FROM u)",
    "SELECT count(*) FROM t WHERE a < 100 AND a NOT IN (SELECT k FROM u)",
    "SELECT count(*) FROM t WHERE EXISTS (SELECT 1 FROM u WHERE k = 700)",
    "SELECT count(*) FROM t WHERE NOT EXISTS (SELECT 1 FROM u WHERE k = 701)",
    "SELECT count(*) FROM t WHERE a = 999 OR a IN "
    "(SELECT k FROM u WHERE k < 5)",
    "SELECT count(*) FROM t WHERE b > (SELECT v FROM x)",
    ("SELECT v.col0, v.col1, u.v FROM (VALUES (1, 'a'), (3, NULL), "
     "(5, 'c')) v JOIN u ON u.k = v.col0",
     "SELECT v.n, v.w, u.v FROM (SELECT 1 AS n, 'a' AS w UNION ALL "
     "SELECT 3, NULL UNION ALL SELECT 5, 'c') v JOIN u ON u.k = v.n"),
]


@pytest.mark.parametrize("mode", ["plain", "packed"])
@pytest.mark.parametrize("qid", range(len(SQL_CASES)))
def test_sql_cases_both_engines(engines, qid, mode):
    port, ref, lite = engines
    sql, lite_sql = (SQL_CASES[qid] if isinstance(SQL_CASES[qid], tuple)
                     else (SQL_CASES[qid],) * 2)
    exp = lite.execute(lite_sql).fetchall()
    for con in (port, ref):
        con.query("PRAGMA compact_all_segments" if mode == "packed"
                  else "PRAGMA uncompact_all")
    got = port.query(sql).fetchall()
    _same(got, exp, f"[{mode}] port vs sqlite: {sql}")
    _same(got, ref.query(sql).fetchall(), f"[{mode}] port vs JAX: {sql}")


# FROM-less SELECT: one row (the JAX package returns none, ROADMAP queue C)
@pytest.mark.parametrize("sql", [
    "SELECT 1",
    "SELECT 1 + 2, 'x'",
    "SELECT count(*) FROM t WHERE b > (SELECT 10)",
    "SELECT count(*) FROM t WHERE b > (SELECT 10) AND a IN (SELECT 3)",
    "SELECT DISTINCT 7",
    "SELECT 5 UNION SELECT 5",
])
def test_fromless_select_vs_sqlite(engines, sql):
    port, _ref, lite = engines
    _same(port.query(sql).fetchall(), lite.execute(sql).fetchall(), sql)


def test_fromless_scalar_equals_table_scalar(engines):
    port, _ref, lite = engines
    a = port.query("SELECT count(*) FROM t WHERE b > (SELECT 10)").fetchall()
    b = port.query("SELECT count(*) FROM t WHERE b > (SELECT v FROM x)"
                   ).fetchall()
    assert a == b and a[0][0] == lite.execute(
        "SELECT count(*) FROM t WHERE b > 10").fetchone()[0] > 0


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM t USING SAMPLE 100",
    "SELECT count(*) FROM t USING SAMPLE 10%",
    "SELECT count(*) FROM t TABLESAMPLE 2 PERCENT",
    "SELECT a, b, s FROM t USING SAMPLE 50",
])
def test_sample_same_rows_as_jax(engines, sql):
    port, ref, _lite = engines
    got = port.query(sql).fetchall()
    assert _norm(got) == _norm(ref.query(sql).fetchall())
    if "count" in sql:
        assert got[0][0] == {"100": 100, "10%": 2000, "2 PERCENT": 400}[
            sql.split("SAMPLE ")[-1] if "USING" in sql else "2 PERCENT"]


# DISTINCT and the set operations over NULL-able columns, against sqlite
# (the JAX package compares the values under NULLs, ROADMAP queue C)
@pytest.fixture(scope="module")
def nullsets():
    rng = np.random.default_rng(0x5E7)
    n = 3000
    cols = {"p": rng.integers(0, 6, n).astype(np.int32),
            "q": rng.integers(0, 4, n).astype(np.int64),
            "s": rng.choice(["x", "y", "z"], n).astype(object)}
    valid = {"p": rng.random(n) > 0.2, "q": rng.random(n) > 0.3,
             "s": rng.random(n) > 0.25}
    # the value under a NULL equals a real value
    cols["p"][~valid["p"]] = 0
    db, con = _port()
    con.query("CREATE TABLE n1(p INTEGER, q BIGINT, s VARCHAR)")
    con.query("CREATE TABLE n2(p INTEGER, q BIGINT, s VARCHAR)")
    lite = sqlite3.connect(":memory:")
    for t, sl in (("n1", slice(0, 2000)), ("n2", slice(1500, n))):
        app = con.appender(t)
        app.append_columns({c: v[sl] for c, v in cols.items()},
                           {c: v[sl] for c, v in valid.items()})
        app.close()
        lite.execute(f"CREATE TABLE {t}(p INTEGER, q INTEGER, s TEXT)")
        lite.executemany(f"INSERT INTO {t} VALUES (?,?,?)", [
            tuple(None if not valid[c][i] else
                  (str(cols[c][i]) if c == "s" else int(cols[c][i]))
                  for c in ("p", "q", "s"))
            for i in range(n)[sl]])
    yield con, lite
    db.close()


@pytest.mark.parametrize("sql", [
    "SELECT DISTINCT p FROM n1",
    "SELECT DISTINCT p, q, s FROM n1",
    "SELECT p, q FROM n1 UNION SELECT p, q FROM n2",
    "SELECT p, s FROM n1 UNION ALL SELECT p, s FROM n2",
    "SELECT p, q FROM n1 EXCEPT SELECT p, q FROM n2",
    "SELECT p, q, s FROM n1 INTERSECT SELECT p, q, s FROM n2",
    "SELECT p FROM n1 WHERE q = 1 EXCEPT SELECT p FROM n2 WHERE q = 2",
    "SELECT s FROM n1 INTERSECT SELECT s FROM n2",
])
@pytest.mark.parametrize("mode", ["plain", "packed"])
def test_distinct_setops_with_nulls_vs_sqlite(nullsets, sql, mode):
    con, lite = nullsets
    con.query("PRAGMA compact_all_segments" if mode == "packed"
              else "PRAGMA uncompact_all")
    _same(con.query(sql).fetchall(), lite.execute(sql).fetchall(), sql)


# ======================================================================
# the host scan moves to the device path; the pool cache is bounded
# ======================================================================


def test_host_scan_falls_back_to_device(monkeypatch):
    from adacom_tpu_torch.exec import adaptive_filter

    rng = np.random.default_rng(3)
    a = rng.integers(0, 100, 20_000).astype(np.int32)
    b = rng.integers(0, 100, 20_000).astype(np.int32)
    db, con = _port(segment_rows=4096)
    con.query("CREATE TABLE h(a INTEGER, b INTEGER)")
    app = con.appender("h")
    app.append_columns({"a": a, "b": b})
    app.close()
    monkeypatch.setattr(adaptive_filter.AdaptiveFilter, "select",
                        lambda self, cols, lits: None)
    device_scan.RUNS = 0
    got = con.query("SELECT a, b FROM h WHERE a < 30 AND b > 60").fetchall()
    assert device_scan.RUNS > 0
    m = (a < 30) & (b > 60)
    assert [tuple(r) for r in got] == list(zip(a[m].tolist(), b[m].tolist()))
    db.close()


def test_pool_cache_bounded_by_encoded_bytes():
    n = 60_000
    row = np.arange(n)
    db, con = _port(segment_rows=4096, host_materialize=False)
    con.query("CREATE TABLE g(k BIGINT, r INTEGER, d INTEGER, f DOUBLE)")
    app = con.appender("g")
    app.append_columns({"k": row.astype(np.int64),
                        "r": ((row // 512) % 50).astype(np.int32),
                        "d": (row * 7919 % 1000).astype(np.int32),
                        "f": np.round(row * 0.25, 2)})
    app.close()
    con.query("SET compression_codec='auto'")
    db.catalog.get_column_segment_catalog().compact_all_segments()
    table = db.catalog.get_table("g")
    bound = table.footprint_bytes()
    queries = [  # three column sets, each most of the table
        ("SELECT count(*), sum(k), sum(r), min(d), max(f) FROM g",
         (n, int(row.sum()), int(((row // 512) % 50).sum()), 0,
          float(np.round((n - 1) * 0.25, 2)))),
        ("SELECT sum(k), max(d), sum(f) FROM g WHERE r < 49",
         None),
        ("SELECT r, count(*), sum(d) FROM g GROUP BY r ORDER BY r", None),
    ]
    for sql, want in queries * 2:
        device_scan.RUNS = 0
        got = con.query(sql).fetchall()
        assert device_scan.RUNS > 0, sql
        if want is not None:
            assert [tuple(got[0])] == [want]
        cache = table._pool_cache
        assert 0 < cache.nbytes <= bound, (sql, cache.nbytes, bound)
        assert db.buffer_manager.cache_bytes == cache.nbytes
    # a query over one column set keeps its stacks between runs
    sql = queries[2][0]
    con.query(sql)
    held = cache.nbytes
    con.query(sql)
    assert cache.nbytes == held
    # a dropped table gives its cache back
    con.query("DROP TABLE g")
    assert db.buffer_manager.cache_bytes == 0
    db.close()


# ======================================================================
# the client modules (relation API, verification, COPY, read_*), against
# the JAX package on the same data; the tests keep the names they had
# while the modules were not yet ported
# ======================================================================


@pytest.fixture
def small():
    """The same table c in both engines: (port connection, JAX package
    connection)."""
    pdb, pcon = _port()
    jdb = adacom_tpu.Database()
    jcon = jdb.connect()
    for con in (pcon, jcon):
        con.query("CREATE TABLE c(i INTEGER, s VARCHAR)")
        con.query("INSERT INTO c VALUES (1, 'a'), (2, 'b'), (3, NULL), "
                  "(4, 'a')")
    yield pcon, jcon
    pdb.close()
    jdb.close()


def _small_lite():
    """Table c of `small` in sqlite: the oracle of a GROUP BY over its
    NULL-able s, whose NULL the JAX package groups with the value stored
    under it (ROADMAP queue C)."""
    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE c(i INTEGER, s VARCHAR)")
    lite.execute("INSERT INTO c VALUES (1, 'a'), (2, 'b'), (3, NULL), "
                 "(4, 'a')")
    return lite


def test_relation_api_not_yet_ported(small):
    got = small[0].table("c").filter("i > 1").aggregate(
        "s, count(*) AS n, sum(i) AS t", "s").order("s").fetchall()
    assert _norm(got) == _norm(_small_lite().execute(
        "SELECT s, count(*) AS n, sum(i) AS t FROM c WHERE i > 1 "
        "GROUP BY s ORDER BY s NULLS LAST").fetchall())
    for build in (
            lambda con: con.table("c").project("i * 10 AS v").order(
                "v DESC").limit(2),
            lambda con: con.values([(1, "x"), (2, None)])):
        got, want = (build(con).fetchall() for con in small)
        assert _norm(got) == _norm(want)
    assert [con.table("c").count() for con in small] == [4, 4]


def test_query_verification_not_yet_ported(small):
    lite = _small_lite()
    for sql in ("SELECT i FROM c ORDER BY i",
                "SELECT s, sum(i) FROM c GROUP BY s"):
        got = []
        for con in small:
            con.query("SET query_verification_enabled=true")
            got.append(con.query(sql).fetchall())
        if "GROUP BY" in sql:
            _same(got[0], lite.execute(sql).fetchall(), sql)
        else:
            _same(got[0], got[1], sql)


def test_copy_not_yet_ported(small, tmp_path):
    outs = []
    for name, con in zip(("port", "jax"), small):
        path = tmp_path / f"{name}.csv"
        assert con.query(f"COPY c TO '{path}'").scalar() == 4
        outs.append(path.read_bytes())
        con.query("CREATE TABLE c2(i INTEGER, s VARCHAR)")
        assert con.query(f"COPY c2 FROM '{path}'").scalar() == 4
    assert outs[0] == outs[1]
    _same(small[0].query("SELECT * FROM c2").fetchall(),
          small[1].query("SELECT * FROM c2").fetchall(), "COPY FROM")


def _table_file(fn, path):
    """A three-row file of fn's format with a NULL in each column."""
    if fn == "read_parquet":
        pa = pytest.importorskip("pyarrow")
        import pyarrow.parquet as pq

        pq.write_table(pa.table({"k": pa.array([1, None, 3]),
                                 "w": pa.array(["x", "y", None])}), path)
    elif fn == "read_json":
        path.write_text('{"k": 1, "w": "x"}\n{"k": null, "w": "y"}\n'
                        '{"k": 3}\n')
    else:
        path.write_text("k,w\n1,x\n,y\n3,\n")


@pytest.mark.parametrize("fn", ["read_csv", "read_parquet", "read_json"])
def test_table_functions_not_yet_ported(small, tmp_path, fn):
    path = tmp_path / "x"
    _table_file(fn, path)
    sql = f"SELECT k, w FROM {fn}('{path}') ORDER BY k NULLS LAST"
    got, want = (con.query(sql).fetchall() for con in small)
    assert _norm(got) == _norm(want)
    assert len(got) == 3
