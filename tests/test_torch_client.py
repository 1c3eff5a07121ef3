"""The client surface of the port against the JAX package: COPY and
read_csv, table functions, the DB-API, the shell, samples, Arrow and
pandas results, prepared statements and the relation API.

Twins of tests/test_client.py: the same SQL on both packages (the JAX
package on its CPU backend, the port with platform="cpu") with equal
answers (floats within 1e-12 relative, everything else exact); COPY ... TO
writes the same bytes; the shell prints the same lines for one piped
script, and `python3 -m adacom_tpu_torch` prints them too."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu import dbapi as jax_dbapi
from adacom_tpu import shell as jax_shell
from adacom_tpu_torch import dbapi, shell


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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dbs(segment_rows=4096):
    """A connection of each package: {"port": con, "jax": con}."""
    out = {}
    for name, pkg in (("port", adacom_tpu_torch), ("jax", adacom_tpu)):
        cfg = pkg.DBConfig()
        cfg.segment_rows = segment_rows
        kw = {"platform": "cpu"} if name == "port" else {}
        out[name] = pkg.Database(config=cfg, **kw).connect()
    return out


def _close(cons):
    for con in cons.values():
        con.db.close()


def _norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None or isinstance(v, str):
                nr.append(v)
            elif isinstance(v, (float, np.floating)):
                nr.append(float(v))
            elif isinstance(v, (bool, int, np.integer, np.bool_)):
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return out


def _equal(got, want, what=""):
    got, want = _norm(got), _norm(want)
    assert len(got) == len(want), (what, got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w), (what, g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert a is not None and b is not None and math.isclose(
                    a, b, rel_tol=1e-12, abs_tol=0.0), (what, g, w)
            else:
                assert a == b, (what, g, w)


def _both(cons, sql):
    """Run sql on both packages; equal answers; returns the port's."""
    got = cons["port"].query(sql)
    want = cons["jax"].query(sql)
    got = [] if got is None else got.fetchall()
    want = [] if want is None else want.fetchall()
    _equal(got, want, sql)
    return got


# ---------------------------------------------------------------- CSV/COPY


def test_copy_roundtrip(tmp_path):
    cons = _dbs()
    out = {}
    for name, con in cons.items():
        con.query("CREATE TABLE t(i BIGINT, x DOUBLE, s VARCHAR, "
                  "p DECIMAL(10,2), d DATE)")
        app = con.appender("t")
        app.append_columns({
            "i": np.arange(5_000, dtype=np.int64),
            "x": np.round(np.arange(5_000) * 0.5, 1),
            "s": np.asarray([f"s{k % 11}" for k in range(5_000)],
                            dtype=object),
            "p": np.arange(5_000, dtype=np.int64) * 7,
            "d": (np.arange(5_000) % 3000 + 8000).astype(np.int32),
        }, {"s": np.arange(5_000) % 13 != 0})
        app.close()
        p = str(tmp_path / f"{name}.csv")
        assert con.query(f"COPY t TO '{p}' (HEADER)").scalar() == 5_000
        out[name] = open(p, "rb").read()
        con.query("CREATE TABLE t2(i BIGINT, x DOUBLE, s VARCHAR, "
                  "p DECIMAL(10,2), d DATE)")
        assert con.query(f"COPY t2 FROM '{p}'").scalar() == 5_000
    assert out["port"] == out["jax"]
    a = _both(cons, "SELECT SUM(i), COUNT(*), SUM(x), COUNT(s), MIN(d), "
                    "MAX(d) FROM t2")
    b = _both(cons, "SELECT SUM(i), COUNT(*), SUM(x), COUNT(s), MIN(d), "
                    "MAX(d) FROM t")
    assert _norm(a) == _norm(b)
    # the file holds p as 0.07, 0.14, ...: the port reads each field as
    # p's DECIMAL(10,2), so t2 holds t's values; the JAX package reads a
    # DOUBLE and casts it to p's scaled integer unscaled, truncating
    # (0.07 -> 0.00, 9.99 -> 0.09)
    sql = "SELECT SUM(p), MAX(p) FROM {}"
    assert _norm(cons["port"].query(sql.format("t2")).fetchall()) == \
        _norm(cons["port"].query(sql.format("t")).fetchall()) == \
        [(sum(k * 7 for k in range(5_000)) / 100, 4_999 * 7 / 100)]
    cents = np.arange(5_000) * 7
    assert _norm(cons["jax"].query(sql.format("t2")).fetchall()) == \
        [(int((cents // 100).sum()) / 100, int(cents[-1] // 100) / 100)]
    # a GROUP BY over the NULL-able s: the JAX package puts the NULL rows
    # in the group of the value stored under them (ROADMAP queue C), so
    # numpy holds the port
    r = cons["port"].query("SELECT s, COUNT(*) FROM t2 GROUP BY s ORDER BY "
                           "s NULLS LAST LIMIT 2").fetchall()
    k = np.arange(5_000)
    assert _norm(r) == _norm([
        (f"s{g}", int(np.count_nonzero((k % 11 == g) & (k % 13 != 0))))
        for g in (0, 1)])
    _close(cons)


@pytest.mark.parametrize("suffix", ["csv", "json"])
def test_copy_select_to(tmp_path, suffix):
    """COPY (SELECT ...) TO a .csv or a .json path: both packages write
    the same bytes (CSV text in both cases: COPY TO has no JSON writer)."""
    cons = _dbs()
    out = {}
    for name, con in cons.items():
        con.query("CREATE TABLE t(i INTEGER, s VARCHAR, x DOUBLE)")
        con.query("INSERT INTO t VALUES (3, 'c', 0.1), (1, NULL, 2.5), "
                  "(2, 'b,\"q\"', NULL)")
        p = str(tmp_path / f"{name}.{suffix}")
        con.query(f"COPY (SELECT i * 10 AS v, s, x FROM t ORDER BY i) "
                  f"TO '{p}'")
        out[name] = open(p, "rb").read()
    assert out["port"] == out["jax"]
    assert out["port"].decode().splitlines()[:2] == ["v,s,x", "10,,2.5"]
    _close(cons)


def test_read_csv_table_function(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("a,b,c,d\n1,1.5,x,1996-01-02\n2,2.5,y,1997-03-04\n"
                 "3,,z,\n")
    cons = _dbs()
    r = _both(cons, f"SELECT a, b, c, d FROM read_csv('{p}') ORDER BY a")
    assert _norm(r)[0][:3] == (1, 1.5, "x") and r[2][1] is None
    assert _norm(_both(cons, f"SELECT SUM(a) FROM read_csv('{p}') "
                             f"WHERE c <> 'y'")) == [(4,)]
    _close(cons)


def test_range_table_function():
    cons = _dbs()
    assert _norm(_both(cons, "SELECT COUNT(*) FROM range(100)")) == [(100,)]
    assert _norm(_both(cons, "SELECT SUM(range) FROM range(5, 10)")) == [
        (35,)]
    r = _both(cons, "SELECT range FROM range(0, 10, 3) ORDER BY range")
    assert [x[0] for x in _norm(r)] == [0, 3, 6, 9]
    _close(cons)


def test_create_table_as_read_csv(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("k,v,w\n1,10,a\n2,20,\n3,30,c\n")
    cons = _dbs()
    for con in cons.values():
        con.query(f"CREATE TABLE imported AS SELECT * FROM read_csv('{p}')")
    assert _norm(_both(cons, "SELECT SUM(v) FROM imported")) == [(60,)]
    _both(cons, "SELECT k, w FROM imported ORDER BY k")
    _close(cons)


# ---------------------------------------------------------------- DB-API


def _dbapi_session(mod, kw):
    con = mod.connect(**kw)
    cur = con.cursor()
    cur.execute("CREATE TABLE t(i INTEGER, s VARCHAR)")
    cur.executemany("INSERT INTO t VALUES (?, ?)",
                    [(1, "a"), (2, "it's"), (None, "n")])
    cur.execute("SELECT i, s FROM t ORDER BY s")
    out = [cur.rowcount, [d[:2] for d in cur.description], cur.fetchall()]
    cur.execute("SELECT i FROM t WHERE i = ?", (2,))
    out += [cur.fetchone(), cur.fetchone()]
    with pytest.raises(mod.DatabaseError):
        cur.execute("SELECT nope FROM t")
    con.close()
    return out


def test_dbapi_basic():
    got = _dbapi_session(dbapi, {"platform": "cpu"})
    want = _dbapi_session(jax_dbapi, {})
    assert got[0] == want[0] == 3
    assert got[1] == want[1] and got[1][0][0] == "i"
    _equal(got[2], want[2])
    assert _norm([got[3]]) == _norm([want[3]]) == [(2,)]
    assert got[4] is None and want[4] is None


def test_dbapi_context_iteration_and_path(tmp_path):
    got = {}
    for name, mod, kw in (("port", dbapi, {"platform": "cpu"}),
                          ("jax", jax_dbapi, {})):
        path = str(tmp_path / name)
        with mod.connect(path=path, **kw) as con:
            con.execute("CREATE TABLE t(i INTEGER)")
            con.execute("INSERT INTO t VALUES (1), (2), (3)")
            first = [r[0] for r in con.execute("SELECT i FROM t ORDER BY i")]
        # the context's close checkpointed: a new connection reads it back
        with mod.connect(path=path, **kw) as con:
            again = con.execute("SELECT sum(i) FROM t").fetchall()
        got[name] = (first, again)
    assert [int(v) for v in got["port"][0]] == [1, 2, 3]
    _equal(got["port"][1], got["jax"][1])
    assert _norm(got["port"][1]) == [(6,)]


# ---------------------------------------------------------------- shell

SCRIPT = ("CREATE TABLE t(i INTEGER, s VARCHAR); "
          "INSERT INTO t VALUES (1, 'a'), (2, NULL), (3, 'c');\n"
          "SELECT i, i * 2 AS d, s FROM t ORDER BY i;\n"
          "SELECT count(*), sum(i) FROM t WHERE i > 1;")


def test_shell_pipe(capsys):
    outs = {}
    for name, sh in (("port", shell.Shell(platform="cpu")),
                     ("jax", jax_shell.Shell())):
        sh.mode = "csv"
        sh.run_sql(SCRIPT)
        out = capsys.readouterr().out
        assert sh.dot_command(".tables")
        assert sh.dot_command(".schema t")
        assert sh.dot_command(".indexes")
        sh.mode = "box"
        sh.run_sql("SELECT s FROM t ORDER BY i;")
        assert not sh.dot_command(".quit")
        outs[name] = (out, capsys.readouterr().out)
        sh.db.close()
    assert outs["port"] == outs["jax"]
    # a script prints the result of its last statement
    assert outs["port"][0] == "count,sum\n2,5\n"
    assert "CREATE TABLE t" in outs["port"][1]
    assert "| a " in outs["port"][1] and "(3 rows)" in outs["port"][1]


def test_shell_module_pipe_equals_the_jax_shell(capsys, tmp_path):
    """`python3 -m adacom_tpu_torch --platform cpu <dir>` with a piped
    script prints what the JAX package's shell prints (no banner in pipe
    mode), and the directory holds the table afterwards."""
    sh = jax_shell.Shell()
    sh.mode = "csv"
    sh.run_sql(SCRIPT)
    want = capsys.readouterr().out
    sh.db.close()
    d = str(tmp_path / "db")
    proc = subprocess.run(
        [sys.executable, "-m", "adacom_tpu_torch", "--platform", "cpu", d],
        input=SCRIPT, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want
    db = adacom_tpu_torch.Database(path=d, platform="cpu")
    assert db.connect().query("SELECT count(*) FROM t").scalar() == 3
    db.close()


# ---------------------------------------------------------------- results


def test_using_sample():
    cons = _dbs(segment_rows=65536)
    for con in cons.values():
        con.query("CREATE TABLE t(i INTEGER)")
        app = con.appender("t")
        app.append_column("i", np.arange(5000, dtype=np.int32))
        app.close()
    assert _norm(_both(cons, "SELECT count(*) FROM t USING SAMPLE 100")) \
        == [(100,)]
    assert _norm(_both(cons, "SELECT count(*) FROM t USING SAMPLE 10%")) \
        == [(500,)]
    assert _norm(_both(cons, "SELECT count(*) FROM t TABLESAMPLE 2 "
                             "PERCENT")) == [(100,)]
    a = cons["port"].query("SELECT i FROM t USING SAMPLE 20").fetchall()
    b = cons["port"].query("SELECT i FROM t USING SAMPLE 20").fetchall()
    assert a == b and all(0 <= r[0] < 5000 for r in a)
    _close(cons)


def test_arrow_and_dataframe_results():
    pytest.importorskip("pyarrow")
    pytest.importorskip("pandas")
    cons = _dbs()
    got = {}
    for name, con in cons.items():
        con.query("CREATE TABLE t(i INTEGER, s VARCHAR, x DOUBLE)")
        con.query("INSERT INTO t VALUES (1, 'a', 0.5), (2, 'b', NULL), "
                  "(NULL, 'c', 2.0)")
        tbl = con.query("SELECT i, s, x FROM t ORDER BY s"
                        ).fetch_arrow_table()
        df = con.query("SELECT i, s, x FROM t ORDER BY s").fetchdf()
        got[name] = (tbl.column_names, tbl.to_pylist(), list(df.columns),
                     df.astype(object).where(df.notna(), None).values
                     .tolist())
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["i", "s", "x"]
    assert [r["s"] for r in got["port"][1]] == ["a", "b", "c"]
    _close(cons)


def test_prepared_statements():
    """Connection.prepare + SQL PREPARE/EXECUTE with ? parameters."""
    got = {}
    for name, con in _dbs().items():
        con.query("CREATE TABLE t(i INTEGER)")
        app = con.appender("t")
        app.append_column("i", np.arange(1000, dtype=np.int32))
        app.close()
        ps = con.prepare("SELECT count(*), sum(i) FROM t WHERE i >= ? "
                         "AND i < ?")
        out = [ps.n_params, ps.execute(10, 20).fetchall(),
               ps(0, 1000).fetchall()]
        with pytest.raises(Exception, match="param"):
            ps.execute(1)
        con.query("PREPARE q AS SELECT count(*) FROM t WHERE i < ?")
        out += [con.query("EXECUTE q(50)").fetchall(),
                con.query("EXECUTE q(700)").fetchall()]
        ins = con.prepare("INSERT INTO t VALUES (?)")
        ins.execute(5000)
        ins.execute(5001)
        out.append(con.query("SELECT count(*) FROM t WHERE i >= 5000"
                             ).fetchall())
        got[name] = out
        con.db.close()
    assert got["port"][0] == got["jax"][0] == 2
    for a, b in zip(got["port"][1:], got["jax"][1:]):
        _equal(a, b)
    assert _norm(got["port"][1]) == [(10, sum(range(10, 20)))]


def test_relation_api():
    """Composable Relation API (reference src/main/relation.cpp)."""
    cons = _dbs()
    got = {}
    for name, con in cons.items():
        con.query("CREATE TABLE t(g INTEGER, v INTEGER)")
        app = con.appender("t")
        app.append_columns({"g": (np.arange(1000) % 5).astype(np.int32),
                            "v": np.arange(1000, dtype=np.int32)})
        app.close()
        r = (con.table("t").filter("v >= 100")
             .aggregate("g, sum(v) AS s, count(*) AS c", "g").order("g"))
        out = [r.fetchall(), [(con.table("t").count(),)],
               [(con.table("t").filter("v < 10").project("v").limit(3)
                 .count(),)],
               [(con.table("t").join(con.table("t").project(
                   "g AS g2, v AS v2"), "g = g2").count(),)],
               con.table("t").distinct().order("v").limit(3).fetchall(),
               con.values([(1, "a"), (2, "b")]).fetchall(),
               con.query("SELECT sum(col0) FROM (VALUES (1), (2), (3)) v"
                         ).fetchall()]
        assert "Aggregate" in r.explain()
        r.create_view("vw")
        out.append(con.query("SELECT count(*) FROM vw").fetchall())
        con.table("t").filter("g = 1").to_table("t1")
        out.append(con.query("SELECT count(*), sum(v) FROM t1").fetchall())
        got[name] = out
    for a, b in zip(got["port"], got["jax"]):
        _equal(a, b)
    port = [_norm(x) for x in got["port"]]
    assert len(port[0]) == 5 and port[0][0][2] == 180
    assert port[1:4] == [[(1000,)], [(3,)], [(200_000,)]]
    assert port[5] == [(1, "a"), (2, "b")] and port[7] == [(5,)]
    _close(cons)
