"""The port's window functions against a sqlite3 oracle (sqlite >= 3.25
has the same window family): the queries of tests/test_window.py on the
same random data, plus partitions and order keys holding NULLs, on plain
and on packed segments. Floats agree to 6 decimals, everything else is
exact; rows compare as multisets."""

import sqlite3

import numpy as np
import pytest

import adacom_tpu_torch

# the queries of tests/test_window.py
QUERIES = [
    "SELECT g, x, y, row_number() OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, rank() OVER (PARTITION BY g ORDER BY x) FROM w ORDER BY g, x, y",
    "SELECT g, x, dense_rank() OVER (PARTITION BY g ORDER BY x) FROM w ORDER BY g, x, y",
    "SELECT g, x, percent_rank() OVER (PARTITION BY g ORDER BY x) FROM w ORDER BY g, x, y",
    "SELECT g, x, cume_dist() OVER (PARTITION BY g ORDER BY x) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, ntile(3) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, lag(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, lag(x, 2) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, lead(y, 1) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, first_value(y) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, last_value(y) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, nth_value(y, 3) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, sum(x) OVER (PARTITION BY g) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, count(*) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, min(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, max(y) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, avg(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN 1 PRECEDING AND 3 FOLLOWING) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, min(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN 4 PRECEDING AND 1 PRECEDING) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, max(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(f) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT x, y, row_number() OVER (ORDER BY y DESC) FROM w ORDER BY x, y",
    "SELECT g, s, x, y, rank() OVER (PARTITION BY s ORDER BY x) FROM w ORDER BY g, s, x, y",
    "SELECT g, x, y, row_number() OVER (PARTITION BY g ORDER BY x, y) + 100 FROM w ORDER BY g, x, y",
    "SELECT g, x, y, lag(x) OVER (PARTITION BY g ORDER BY x, y), lead(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    # window over aggregate output
    "SELECT g, sum(x) AS s, rank() OVER (ORDER BY sum(x) DESC) FROM w GROUP BY g ORDER BY g",
    "SELECT g, count(*) AS c, row_number() OVER (ORDER BY count(*) DESC, g) FROM w GROUP BY g ORDER BY g",
    # CTE + window
    "WITH t AS (SELECT g, x FROM w WHERE x > 0) SELECT g, x, row_number() OVER (PARTITION BY g ORDER BY x) FROM t ORDER BY g, x",
    # NULL partition keys form one partition; NULL order keys sort where
    # NULLS FIRST / LAST puts them (the defaults differ: sqlite sorts a
    # NULL first, DuckDB and the engine last)
    "SELECT gn, x, y, sum(x) OVER (PARTITION BY gn ORDER BY x, y) FROM w ORDER BY gn, x, y",
    "SELECT gn, x, y, rank() OVER (PARTITION BY g ORDER BY xn NULLS LAST, y) FROM w ORDER BY g, xn, y",
    "SELECT gn, x, y, rank() OVER (PARTITION BY g ORDER BY xn DESC NULLS FIRST, y) FROM w ORDER BY g, xn, y",
    "SELECT g, y, count(xn) OVER (PARTITION BY g), sum(xn) OVER (PARTITION BY g ORDER BY y) FROM w ORDER BY g, y",
]


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(0xA11CE)
    n = 500
    g = rng.integers(0, 7, n).astype(np.int32)
    x = rng.integers(-50, 50, n).astype(np.int32)
    y = rng.permutation(n).astype(np.int64)  # unique: deterministic ties
    f = np.round(rng.normal(0, 10, n), 3)
    s = np.array([f"s{v}" for v in rng.integers(0, 5, n)], dtype=object)
    gv, xv = rng.random(n) > 0.2, rng.random(n) > 0.2

    db = adacom_tpu_torch.Database(
        platform="cpu", config=adacom_tpu_torch.DBConfig(segment_rows=128))
    con = db.connect()
    con.query("CREATE TABLE w(g INTEGER, x INTEGER, y BIGINT, f DOUBLE, "
              "s VARCHAR, gn INTEGER, xn INTEGER)")
    app = con.appender("w")
    app.append_columns({"g": g, "x": x, "y": y, "f": f, "s": s, "gn": g,
                        "xn": x}, {"gn": gv, "xn": xv})
    app.close()

    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE w(g INTEGER, x INTEGER, y BIGINT, f DOUBLE, "
                 "s TEXT, gn INTEGER, xn INTEGER)")
    lite.executemany(
        "INSERT INTO w VALUES (?,?,?,?,?,?,?)",
        [(int(a), int(b), int(c), float(d), str(e), int(a) if va else None,
          int(b) if vb else None)
         for a, b, c, d, e, va, vb in zip(g, x, y, f, s, gv, xv)],
    )
    yield con, lite
    db.close()


def _norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None:
                nr.append(None)
            elif isinstance(v, (float, np.floating)):
                nr.append(round(float(v), 6))
            elif isinstance(v, (int, np.integer)):
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return sorted(out, key=repr)


@pytest.mark.parametrize("mode", ["plain", "packed"])
@pytest.mark.parametrize("qid", range(len(QUERIES)))
def test_window_query(engines, qid, mode):
    con, lite = engines
    con.query("PRAGMA compact_all_segments" if mode == "packed"
              else "PRAGMA uncompact_all")
    sql = QUERIES[qid]
    got, exp = _norm(con.query(sql).fetchall()), _norm(lite.execute(sql).fetchall())
    assert got == exp, f"{sql}\n got {got[:5]}\n exp {exp[:5]}"
