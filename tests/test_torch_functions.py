"""The port's scalar function families (math, strings, dates) against the JAX
package: the twins of tests/test_functions.py.

Each scenario creates its table and runs its SQL on both packages (the JAX
package on its CPU backend, the port with platform="cpu"), holds the
answers against Python's math, str and datetime as the reference test
does, and the two packages' rows must be equal. Tolerance: integers,
strings, DATEs and NULLs match exactly; floats are rounded to 6 decimals
before the comparison across packages (tests/test_sql.py's `_norm`) and
held against Python with pytest.approx's default relative 1e-6."""

import datetime
import math

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


@pytest.fixture(scope="module")
def cons():
    """One database per package for the whole file; each scenario makes
    tables of its own names."""
    dbs = {k: pkg.Database(**({"platform": "cpu"} if pkg is adacom_tpu_torch
                              else {})) for k, pkg in PKGS.items()}
    yield {k: db.connect() for k, db in dbs.items()}
    for db in dbs.values():
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


# ======================================================================
# twins: one scenario per reference test; each takes a connection and
# returns its rows
# ======================================================================


def _math_functions(con):
    con.query("CREATE TABLE m(x DOUBLE, i BIGINT)")
    con.query("INSERT INTO m VALUES (2.25, 10), (0.49, -7), (9.0, 22)")
    rows = con.query(
        "SELECT sqrt(x), exp(x), ln(x), log(100.0), log2(i*0+8), "
        "power(x, 2), sign(i), trunc(x), cbrt(8.0) FROM m").fetchall()
    for r, x, i in zip(rows, [2.25, 0.49, 9.0], [10, -7, 22]):
        assert r[0] == pytest.approx(math.sqrt(x))
        assert r[1] == pytest.approx(math.exp(x))
        assert r[2] == pytest.approx(math.log(x))
        assert r[3] == pytest.approx(2.0)
        assert r[4] == pytest.approx(3.0)
        assert r[5] == pytest.approx(x * x)
        assert int(r[6]) == (1 if i > 0 else -1)
        assert r[7] == float(int(x))
        assert r[8] == pytest.approx(2.0)
    return rows


def _trig_and_pi(con):
    con.query("CREATE TABLE tr(x DOUBLE)")
    con.query("INSERT INTO tr VALUES (0.5)")
    rows = con.query(
        "SELECT sin(x), cos(x), tan(x), atan(x), atan2(x, 1.0), "
        "degrees(pi()), radians(180.0), pi() FROM tr").fetchall()
    want = [math.sin(0.5), math.cos(0.5), math.tan(0.5), math.atan(0.5),
            math.atan2(0.5, 1.0), 180.0, math.pi, math.pi]
    assert list(rows[0]) == pytest.approx(want)
    return rows


def _mod_trunc_semantics(con):
    con.query("CREATE TABLE md(a BIGINT, b BIGINT)")
    con.query("INSERT INTO md VALUES (7, 3), (-7, 3), (7, -3), (-7, -3), "
              "(5, 0)")
    rows = con.query("SELECT mod(a, b) FROM md").fetchall()
    # SQL mod follows the dividend's sign (truncated division); x % 0 is
    # NULL
    assert [r[0] for r in rows] == [1, -1, 1, -1, None]
    return rows


def _greatest_least(con):
    con.query("CREATE TABLE gl(a BIGINT, b BIGINT, c BIGINT)")
    con.query("INSERT INTO gl VALUES (1, 5, 3), (9, NULL, 2), "
              "(NULL, NULL, 4)")
    rows = con.query("SELECT greatest(a, b, c), least(a, b, c) FROM gl"
                     ).fetchall()
    assert [tuple(r) for r in rows] == [(5, 1), (9, 2), (4, 4)]
    return rows


def _nullif_ifnull_iif(con):
    con.query("CREATE TABLE nn(a BIGINT, b BIGINT)")
    con.query("INSERT INTO nn VALUES (1, 1), (2, 3), (NULL, 5)")
    rows = con.query("SELECT nullif(a, b), ifnull(a, 0), "
                     "iif(a = b, 100, 200) FROM nn").fetchall()
    assert [tuple(r) for r in rows] == [(None, 1, 100), (2, 2, 200),
                                        (None, 0, 200)]
    return rows


def _string_functions(con):
    con.query("CREATE TABLE s(v VARCHAR)")
    con.query("INSERT INTO s VALUES ('hello world'), ('Ab'), (''), (NULL)")
    rows = con.query(
        "SELECT length(v), upper(v), reverse(v), left(v, 3), right(v, 3), "
        "lpad(v, 5, '*'), repeat(v, 2), replace(v, 'l', 'L') FROM s"
    ).fetchall()
    for r, s in zip(rows, ["hello world", "Ab", ""]):
        assert r[0] == len(s)
        assert r[1] == s.upper()
        assert r[2] == s[::-1]
        assert r[3] == s[:3]
        assert r[4] == (s[len(s) - 3:] if len(s) >= 3 else s)
        assert r[5] == ("*" * 5)[: 5 - len(s)] + s if len(s) < 5 else s[:5]
        assert r[6] == s * 2
        assert r[7] == s.replace("l", "L")
    assert rows[3][0] is None
    return rows


def _split_part_initcap_strpos_ascii(con):
    con.query("CREATE TABLE sp(v VARCHAR)")
    con.query("INSERT INTO sp VALUES ('a,b,c'), ('one two'), ('x')")
    rows = con.query("SELECT split_part(v, ',', 2), initcap(v), "
                     "strpos(v, 'b'), ascii(v) FROM sp").fetchall()
    assert [tuple(r) for r in rows] == [
        ("b", "A,B,C", 3, ord("a")), ("", "One Two", 0, ord("o")),
        ("", "X", 0, ord("x"))]
    return rows


def _string_predicates(con):
    con.query("CREATE TABLE p(v VARCHAR)")
    con.query("INSERT INTO p VALUES ('apple pie'), ('pieces'), ('grape'), "
              "(NULL)")
    out = []
    for pred, want in (("contains(v, 'pie')", ["apple pie", "pieces"]),
                       ("starts_with(v, 'pie')", ["pieces"]),
                       ("ends_with(v, 'pie')", ["apple pie"]),
                       ("regexp_matches(v, '^g.*e$')", ["grape"])):
        got = [r[0] for r in con.query(
            f"SELECT v FROM p WHERE {pred}").fetchall()]
        assert got == want, pred
        out.append(got)
    return out


def _date_extraction(con):
    con.query("CREATE TABLE d(dt DATE)")
    isos = ["1996-03-13", "2000-12-31", "1970-01-01"]
    con.query("INSERT INTO d VALUES " + ", ".join(f"('{s}')" for s in isos))
    rows = con.query("SELECT year(dt), quarter(dt), week(dt), "
                     "dayofweek(dt), dayofyear(dt), epoch(dt) FROM d"
                     ).fetchall()
    for r, iso in zip(rows, isos):
        dt = datetime.date.fromisoformat(iso)
        assert tuple(int(x) for x in r) == (
            dt.year, (dt.month + 2) // 3, dt.isocalendar()[1],
            (dt.weekday() + 1) % 7,  # Sunday = 0
            dt.timetuple().tm_yday,
            int(datetime.datetime(dt.year, dt.month, dt.day,
                                  tzinfo=datetime.timezone.utc).timestamp()))
    return rows


def _date_trunc_last_day_diff(con):
    con.query("CREATE TABLE d2(a DATE, b DATE)")
    con.query("INSERT INTO d2 VALUES ('1996-03-13', '1998-07-02')")
    r = con.query(
        "SELECT date_trunc('month', a), date_trunc('year', a), "
        "date_trunc('quarter', b), date_trunc('week', a), last_day(a), "
        "date_diff('day', a, b), date_diff('month', a, b), "
        "date_diff('year', a, b) FROM d2").fetchone()
    a, b = datetime.date(1996, 3, 13), datetime.date(1998, 7, 2)
    assert [str(x) for x in r[:5]] == [
        "1996-03-01", "1996-01-01", "1998-07-01",
        "1996-03-11",  # the Monday of that week
        "1996-03-31"]
    assert list(r[5:]) == [(b - a).days,
                           (1998 * 12 + 7) - (1996 * 12 + 3), 2]
    return [tuple(str(x) for x in r[:5]) + tuple(r[5:])]


def _monthname_dayname(con):
    con.query("CREATE TABLE d3(dt DATE)")
    con.query("INSERT INTO d3 VALUES ('1996-03-13'), ('2000-12-31')")
    rows = con.query("SELECT monthname(dt), dayname(dt) FROM d3").fetchall()
    assert [tuple(r) for r in rows] == [("March", "Wednesday"),
                                        ("December", "Sunday")]
    return rows


def _functions_in_where_and_groupby(con):
    con.query("CREATE TABLE w(v VARCHAR, x BIGINT)")
    con.query("INSERT INTO w VALUES ('aa', 1), ('bbb', 2), ('cc', 3), "
              "('dddd', 4)")
    out = [con.query("SELECT sum(x) FROM w WHERE length(v) = 2").fetchall(),
           con.query("SELECT length(v) AS l, sum(x) FROM w GROUP BY l "
                     "ORDER BY l").fetchall()]
    assert out[0][0][0] == 4
    assert [tuple(r) for r in out[1]] == [(2, 4), (3, 2), (4, 4)]
    return out[0] + out[1]


TWINS = {f.__name__.lstrip("_"): f for f in (
    _math_functions, _trig_and_pi, _mod_trunc_semantics, _greatest_least,
    _nullif_ifnull_iif, _string_functions, _split_part_initcap_strpos_ascii,
    _string_predicates, _date_extraction, _date_trunc_last_day_diff,
    _monthname_dayname, _functions_in_where_and_groupby)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_of_test_functions(cons, name):
    got = {k: TWINS[name](con) for k, con in cons.items()}
    assert _norm(got["port"]) == _norm(got["jax"])
