"""SQL NULL semantics of the port's grouped aggregates, on every route, and
the other wrong answers repaired with them, against sqlite.

A NULL key forms a group of its own, a group exists when a row reaches it
after the WHERE, and an aggregate over a group whose argument is all NULL
is NULL (count gives 0). The grouped queries run on four routes, and each
case asserts the route it took:
- host: the host hash aggregate (the keys' domain is too wide to be
  dense);
- generic: the generic device path on CPU tensors (DEVICE_ROUTE's knobs);
  a NULL-free count/sum/avg takes the fused grouped tiers B2/B3
  instead, as before, and any NULL sends it to the generic path;
- streamed: the streamed join -> aggregate pipeline;
- mesh: the distributed scan-aggregate on 4 virtual CPU shards.

Beside them: integer / and % truncate toward zero on the host tier, the
generic path and the FROM-less SELECT; DELETE FROM t inside a transaction
goes through the delete masks, so ROLLBACK keeps the rows, in memory and
across a crash, and its WAL replays in the JAX package too.

The JAX package folds NULL keys into the group of the value stored under
them, drops groups whose argument is all NULL, rounds integer / and %
down, answers NOT IN as NOT EXISTS and loses the rows of a rolled-back
DELETE FROM t (ROADMAP queue C), so sqlite is the oracle throughout.
sqlite has no stddev: a Python aggregate stands in. Integers are exact,
floats agree to 1e-9 relative."""

import math
import sqlite3

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch as att
from adacom_tpu_torch.exec import device_scan
from adacom_tpu_torch.parallel import mesh as pmesh
from adacom_tpu_torch.tools.fuzz_differential import DEVICE_ROUTE

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


N = 3000
SEG_ROWS = 1024
N_GROUPS = 12
ALL_NULL_GROUP = 3
# the host route's keys: spread past the dense domain's 1 << 22 slots
HOST_SCALE = 10_000_019

ROUTES = ["host", "generic", "streamed", "mesh"]
PLACEMENTS = ["none", "keys", "arg", "both"]
AGGS = ["count(*)", "count(v)", "sum(v)", "avg(v)", "min(v)", "max(v)",
        "stddev(v)"]
PROBE = [(1, None), (1, None), (2, 5), (2, None), (3, 7), (None, 4),
         (None, None)]


class _StdDev:
    """Sample standard deviation, NULL below two values (sqlite lacks it)."""

    def __init__(self):
        self.xs = []

    def step(self, x):
        if x is not None:
            self.xs.append(float(x))

    def finalize(self):
        if len(self.xs) < 2:
            return None
        m = sum(self.xs) / len(self.xs)
        return math.sqrt(sum((x - m) ** 2 for x in self.xs)
                         / (len(self.xs) - 1))


def _rows(placement, seed=0x2011):
    """(g, v) rows from a seed: 12 groups; 'keys' makes 5% of the keys
    NULL, 'arg' makes group 3's v all NULL and 10% of the other v NULL."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, N_GROUPS, N)
    v = rng.integers(-1000, 1000, N)
    gv = np.ones(N, bool)
    vv = np.ones(N, bool)
    if placement in ("keys", "both"):
        gv = rng.random(N) >= 0.05
    if placement in ("arg", "both"):
        vv = (rng.random(N) >= 0.1) & (g != ALL_NULL_GROUP)
    return [(int(a) if oa else None, int(b) if ob else None)
            for a, oa, b, ob in zip(g, gv, v, vv)]


def _lite(rows):
    lite = sqlite3.connect(":memory:")
    lite.create_aggregate("stddev", 1, _StdDev)
    lite.execute("CREATE TABLE t(g INTEGER, v INTEGER, k INTEGER)")
    lite.executemany("INSERT INTO t VALUES (?,?,?)",
                     [(g, v, i) for i, (g, v) in enumerate(rows)])
    return lite


def _engine(route, rows):
    """The port's database for a route, holding t(g, v, k) (k: the row
    number) and, for the streamed route, u(k) with every k."""
    cfg = att.DBConfig()
    cfg.segment_rows = SEG_ROWS
    kw = {}
    if route in ("generic", "mesh"):
        for k, v in DEVICE_ROUTE.items():
            setattr(cfg, k, v)
    if route == "mesh":
        kw["mesh"] = pmesh.make_virtual_mesh(4, "cpu")
    if route == "host":  # the host aggregate over the host copies
        cfg.host_materialize = True
    db = att.Database(config=cfg, platform="cpu", **kw)
    con = db.connect()
    scale = HOST_SCALE if route == "host" else 1
    con.query("CREATE TABLE t(g INTEGER, v INTEGER, k INTEGER)")
    g = np.asarray([0 if r[0] is None else r[0] * scale for r in rows],
                   np.int32)
    v = np.asarray([0 if r[1] is None else r[1] for r in rows], np.int32)
    app = con.appender("t")
    app.append_columns(
        {"g": g, "v": v, "k": np.arange(len(rows), dtype=np.int32)},
        {"g": np.asarray([r[0] is not None for r in rows]),
         "v": np.asarray([r[1] is not None for r in rows])})
    app.close()
    if route == "streamed":
        con.query("CREATE TABLE u(k INTEGER)")
        app = con.appender("u")
        app.append_columns({"k": np.arange(len(rows), dtype=np.int32)})
        app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    return db, con, scale


def _sql(route, select, tail="GROUP BY g"):
    """The route's spelling of `SELECT select FROM t tail`: the streamed
    route joins t to u on k, which keeps every row."""
    if route == "streamed":
        return (f"SELECT {select} FROM t JOIN u ON t.k = u.k "
                f"{tail.replace('GROUP BY g', 'GROUP BY t.g')}")
    return f"SELECT {select} FROM t {tail}"


def _norm(rows, scale=1):
    out = []
    for r in rows:
        nr = []
        for i, x in enumerate(r):
            if x is None:
                nr.append(None)
            elif isinstance(x, (float, np.floating)):
                nr.append(float(x))
            else:
                nr.append(int(x) // scale if i == 0 else int(x))
        out.append(tuple(nr))
    return out


def _same(got, want, what, ordered=False):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want), f"{what}: {got} != {want}"
    for g, w in zip(got, want):
        assert len(g) == len(w), (what, g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert a is not None and b is not None and math.isclose(
                    a, b, rel_tol=1e-9, abs_tol=1e-9), (what, g, w)
            else:
                assert a == b, f"{what}: {g} != {w}"


def _counters(db):
    return (device_scan.RUNS, dict(db.dist_stats))


def _route_taken(db, before):
    runs0, stats0 = before
    stats = {k: v - stats0.get(k, 0) for k, v in db.dist_stats.items()
             if v - stats0.get(k, 0)}
    if stats.get("streamed_join_agg"):
        return "streamed"
    if stats.get("scan_agg"):
        return "mesh"
    if stats.get("pallas_grouped_agg"):
        return "B2"
    if stats.get("pallas_multi_agg"):
        return "B3"
    return "generic" if device_scan.RUNS > runs0 else "host"


def _expected_route(route, placement, agg):
    """A NULL-free count/sum/avg takes the fused grouped tiers, as before
    this repair: B2, or B3 for a bare count(*) (B2 needs a value column).
    Both decline a column with NULLs that they read."""
    if route != "generic" or placement == "both" or \
            agg not in ("count(*)", "count(v)", "sum(v)", "avg(v)"):
        return route
    if agg == "count(*)":
        # B3 checks only the columns it reads: g
        return "B3" if placement != "keys" else route
    return "B2" if placement == "none" else route


@pytest.fixture(scope="module")
def engines():
    made = {}

    def get(route, placement):
        if (route, placement) not in made:
            rows = _rows(placement)
            made[route, placement] = (*_engine(route, rows), _lite(rows))
        return made[route, placement]

    yield get
    for db, *_rest in made.values():
        db.close()


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("route", ROUTES)
def test_grouped_aggregate_nulls_vs_sqlite(engines, route, agg, placement):
    db, con, scale, lite = engines(route, placement)
    before = _counters(db)
    got = con.query(_sql(route, f"g, {agg}")).fetchall()
    assert _route_taken(db, before) == _expected_route(route, placement,
                                                       agg)
    want = lite.execute(f"SELECT g, {agg} FROM t GROUP BY g").fetchall()
    _same(_norm(got, scale), _norm(want), f"{route} {placement} {agg}")
    n_groups = N_GROUPS + (placement in ("keys", "both"))
    assert len(got) == n_groups


@pytest.mark.parametrize("route", ROUTES)
def test_having_and_order_by_over_a_null_aggregate(engines, route):
    db, con, scale, lite = engines(route, "both")
    tail = ("GROUP BY g HAVING sum(v) IS NULL OR count(v) > 200 "
            "ORDER BY s NULLS FIRST, g NULLS FIRST")
    for select in ("g, sum(v) AS s", "g, max(v) AS s"):
        before = _counters(db)
        got = con.query(_sql(route, select, tail)).fetchall()
        assert _route_taken(db, before) == route
        want = lite.execute(f"SELECT {select} FROM t {tail}").fetchall()
        _same(_norm(got, scale), _norm(want), f"{route} {select}",
              ordered=True)
        assert any(r[1] is None for r in got)


@pytest.mark.parametrize("route", ROUTES)
def test_probe_table_on_every_route(route):
    """The probe of ROADMAP queue C items 1 and 4: NULL keys, an all-NULL
    argument group and a NULL-key group with a value."""
    db, con, scale = _engine(route, PROBE)
    lite = _lite(PROBE)
    try:
        for select in ("g, count(*), sum(v), min(v), max(v), avg(v)",
                       "g, sum(v)", "g, count(v), stddev(v)"):
            before = _counters(db)
            got = con.query(_sql(route, select)).fetchall()
            assert _route_taken(db, before) == route
            want = lite.execute(
                f"SELECT {select} FROM t GROUP BY g").fetchall()
            _same(_norm(got, scale), _norm(want), f"{route} {select}")
    finally:
        db.close()


@pytest.mark.parametrize("route", ["host", "generic", "mesh"])
def test_empty_table_has_no_groups(route):
    """No row, no group: a GROUP BY over an empty table, and over a table
    whose rows the WHERE removes, answers no row, whatever the key's
    NULLs."""
    db, con, _scale = _engine(route, [])
    try:
        assert con.query(_sql(route, "g, sum(v)")).fetchall() == []
    finally:
        db.close()
    db, con, scale = _engine(route, PROBE)
    try:
        sql = _sql(route, "g, max(v)", "WHERE k > 100 GROUP BY g")
        assert con.query(sql).fetchall() == []
    finally:
        db.close()


def test_probe_table_other_answers():
    """The probe's NOT IN, DELETE inside a rolled-back transaction and
    integer / and %, each against sqlite."""
    db, con, _scale = _engine("generic", PROBE)
    lite = _lite(PROBE)
    lite.isolation_level = None
    try:
        for sql in ("SELECT count(*) FROM t WHERE g NOT IN (SELECT v FROM t)",
                    "SELECT -7 / 2, -7 % 5"):
            assert _norm(con.query(sql).fetchall()) == \
                _norm(lite.execute(sql).fetchall()), sql
        for c in (con, lite):
            run = c.query if c is con else c.execute
            run("BEGIN")
            run("DELETE FROM t")
            run("ROLLBACK")
        sql = "SELECT count(*) FROM t"
        assert _norm(con.query(sql).fetchall()) == \
            _norm(lite.execute(sql).fetchall()) == [(len(PROBE),)]
    finally:
        db.close()


def test_null_free_grouped_query_keeps_the_fused_tier(engines):
    """A NULL-free grouped count/sum launches B2 as before; the same query
    over NULLs falls to the generic path with sqlite's answer."""
    for placement, route in (("none", "B2"), ("keys", "generic"),
                             ("arg", "generic")):
        db, con, _scale, lite = engines("generic", placement)
        before = _counters(db)
        sql = "SELECT g, count(*), sum(v) FROM t GROUP BY g"
        got = con.query(sql).fetchall()
        assert _route_taken(db, before) == route, placement
        _same(_norm(got), _norm(lite.execute(sql).fetchall()), placement)


# ======================================================================
# integer / and %: truncated toward zero, as sqlite
# ======================================================================

PAIRS = [(7, 2), (-7, 2), (7, -2), (-7, -2), (7, 5), (-7, 5), (7, -5),
         (-7, -5), (0, 3), (-1, 7), (6, 3), (-6, -3)]


@pytest.fixture(scope="module")
def divisions():
    """x(i, a, b) with one row per pair, on the host tier's default config
    and on DEVICE_ROUTE's, and sqlite."""
    a = np.asarray([p[0] for p in PAIRS] + [5], np.int32)
    b = np.asarray([p[1] for p in PAIRS] + [0], np.int32)
    dbs = {}
    for tier, cfg_kw in (("host", {}), ("generic", DEVICE_ROUTE)):
        cfg = att.DBConfig()
        for k, v in cfg_kw.items():
            setattr(cfg, k, v)
        db = att.Database(config=cfg, platform="cpu")
        con = db.connect()
        con.query("CREATE TABLE x(i INTEGER, a INTEGER, b INTEGER)")
        app = con.appender("x")
        app.append_columns({"i": np.arange(len(a), dtype=np.int32),
                            "a": a, "b": b})
        app.close()
        dbs[tier] = (db, con)
    yield dbs
    for db, _con in dbs.values():
        db.close()


@pytest.mark.parametrize("tier", ["host", "generic", "from-less"])
@pytest.mark.parametrize("a,b", PAIRS)
def test_integer_division_truncates_vs_sqlite(divisions, tier, a, b):
    want = sqlite3.connect(":memory:").execute(
        f"SELECT {a} / {b}, {a} % {b}").fetchall()
    i = PAIRS.index((a, b))
    if tier == "from-less":
        got = divisions["host"][1].query(
            f"SELECT {a} / {b}, {a} % {b}").fetchall()
    elif tier == "host":
        got = divisions["host"][1].query(
            f"SELECT a / b, a % b FROM x WHERE i = {i}").fetchall()
    else:
        runs = device_scan.RUNS
        got = divisions["generic"][1].query(
            f"SELECT sum(a / b), sum(a % b) FROM x WHERE i = {i}").fetchall()
        assert device_scan.RUNS > runs  # the generic path's tensors
    assert _norm(got) == _norm(want)


def test_integer_division_by_zero_gives_zero(divisions):
    """The engine's rule, kept: a zero divisor gives 0 (sqlite: NULL)."""
    i = len(PAIRS)
    con = divisions["host"][1]
    assert _norm(con.query(f"SELECT a / b, a % b FROM x WHERE i = {i}")
                 .fetchall()) == [(0, 0)]
    assert _norm(con.query("SELECT 5 / 0, -5 % 0").fetchall()) == [(0, 0)]
    runs = device_scan.RUNS
    assert _norm(divisions["generic"][1].query(
        f"SELECT sum(a / b), sum(a % b) FROM x WHERE i = {i}").fetchall()) \
        == [(0, 0)]
    assert device_scan.RUNS > runs


# ======================================================================
# DELETE FROM t inside a transaction
# ======================================================================


def _run(con, sql):
    """A statement's rows on the port or sqlite (None when it has none)."""
    if isinstance(con, sqlite3.Connection):
        return con.execute(sql).fetchall()
    res = con.query(sql)
    return None if res is None else _norm(res.fetchall())


def test_delete_all_in_a_transaction_vs_sqlite():
    """ROLLBACK keeps the rows, COMMIT removes them, and the PRIMARY KEY's
    UNIQUE index enforces after both; outside a transaction DELETE FROM t
    still truncates."""
    db = att.Database(platform="cpu")
    lite = sqlite3.connect(":memory:", isolation_level=None)
    seen = []
    for con in (db.connect(), lite):
        log = []

        def q(sql, con=con, log=log):
            rows = _run(con, sql)
            if sql.startswith("SELECT"):
                log.append(rows)

        def raises(sql, con=con, log=log):
            with pytest.raises(Exception):
                con.query(sql) if con is not lite else con.execute(sql)
            log.append("raised")

        q("CREATE TABLE t(k INTEGER PRIMARY KEY, v INTEGER)")
        q("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
        q("BEGIN")
        q("DELETE FROM t")
        q("SELECT count(*) FROM t")
        q("ROLLBACK")
        q("SELECT k, v FROM t ORDER BY k")
        raises("INSERT INTO t VALUES (2, 99)")
        q("BEGIN")
        q("DELETE FROM t")
        q("INSERT INTO t VALUES (1, 11)")
        q("COMMIT")
        q("SELECT k, v FROM t ORDER BY k")
        raises("INSERT INTO t VALUES (1, 12)")
        q("INSERT INTO t VALUES (4, 40)")
        q("DELETE FROM t")
        q("INSERT INTO t VALUES (3, 33)")
        q("SELECT k, v FROM t ORDER BY k")
        seen.append(log)
    db.close()
    assert seen[0] == seen[1] == [
        [(0,)], [(1, 10), (2, 20), (3, 30)], "raised", [(1, 11)], "raised",
        [(3, 33)]]


def _durable(pkg, path):
    kw = {"platform": "cpu"} if pkg is att else {}
    db = pkg.Database(path=str(path), **kw)
    return db, db.connect()


def _crash(db):
    """Drop the handle without a checkpoint."""
    if db.wal is not None:
        db.wal.close()
    db.catalog.shutdown()
    db._closed = True


@pytest.mark.parametrize("end", ["ROLLBACK", "COMMIT"])
def test_delete_all_in_a_transaction_survives_a_crash(tmp_path, end):
    """BEGIN; DELETE FROM t; ROLLBACK or COMMIT; a crash; the reopened
    database (the port's, then the JAX package's on the same WAL) has the
    rows back after ROLLBACK and none after COMMIT."""
    db, con = _durable(att, tmp_path)
    con.query("CREATE TABLE t(k INTEGER, v INTEGER)")
    con.query("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
    con.query("CREATE UNIQUE INDEX tk ON t(k)")
    con.query("BEGIN")
    con.query("DELETE FROM t")
    con.query(end)
    want = [(3, 60)] if end == "ROLLBACK" else [(0, None)]
    assert _norm(con.query("SELECT count(*), sum(v) FROM t").fetchall()) \
        == want
    _crash(db)
    for pkg in (att, adacom_tpu):
        db, con = _durable(pkg, tmp_path)
        assert _norm(con.query("SELECT count(*), sum(v) FROM t")
                     .fetchall()) == want, pkg.__name__
        if pkg is att:
            with pytest.raises(Exception):
                con.query("INSERT INTO t VALUES (7, 1), (7, 2)")
        _crash(db)


@pytest.mark.parametrize("stmts", [
    ("BEGIN", "DELETE FROM t", "INSERT INTO t VALUES (1, 11), (2, 22)",
     "COMMIT"),
    ("DELETE FROM t WHERE k = 1", "INSERT INTO t VALUES (1, 11)"),
], ids=["delete-all-in-a-transaction", "delete-where"])
def test_reinserted_keys_survive_a_crash(tmp_path, stmts):
    """A deleted key holds its UNIQUE slot no more: the keys go back in,
    and after a crash the port's reopen has sqlite's rows and its UNIQUE
    index still enforces. The JAX package cannot open this WAL: its
    replay's UNIQUE check counts the deleted rows, so it raises (ROADMAP
    queue C, a fault of the reference)."""
    from adacom_tpu.storage.index import ConstraintViolation

    setup = ("CREATE TABLE t(k INTEGER, v INTEGER)",
             "INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)",
             "CREATE UNIQUE INDEX tk ON t(k)")
    lite = sqlite3.connect(":memory:", isolation_level=None)
    for sql in setup + stmts:
        lite.execute(sql)
    sel = "SELECT k, v FROM t ORDER BY k"
    want = lite.execute(sel).fetchall()
    db, con = _durable(att, tmp_path)
    for sql in setup + stmts:
        con.query(sql)
    assert _run(con, sel) == want
    _crash(db)
    db, con = _durable(att, tmp_path)
    assert _run(con, sel) == want
    with pytest.raises(Exception):
        con.query("INSERT INTO t VALUES (1, 99)")
    _crash(db)
    with pytest.raises(ConstraintViolation):
        adacom_tpu.Database(path=str(tmp_path))


# ======================================================================
# the NULL-bearing fuzzer (fuzz_differential --nulls)
# ======================================================================


def test_null_fuzzer_keeps_the_seed_stream():
    """--nulls keeps the seed's values and SQL, spelling each ORDER BY item
    NULLS FIRST, and draws its masks from a generator of their own."""
    from adacom_tpu_torch.tools import fuzz_differential as fd

    data, queries = fd.stream(200, 3)
    ndata, nqueries = fd.stream(200, 3, 0.1)
    for k in data:
        assert np.array_equal(data[k], ndata[k]), k
    assert [q.replace(" NULLS FIRST", "") for q in nqueries] == queries
    assert all(q.count("ORDER BY") <= q.count("NULLS FIRST")
               for q in nqueries)
    assert fd.make_nulls(3, fd.N_ROWS, 0.0) is None
    masks = fd.make_nulls(3, fd.N_ROWS, 0.1)
    again = fd.make_nulls(3, fd.N_ROWS, 0.1)
    for c, m in masks.items():
        assert np.array_equal(m, again[c])
        assert 0.08 < 1 - m.mean() < 0.12, c


@pytest.fixture(scope="module")
def null_oracle():
    from adacom_tpu_torch.tools import fuzz_differential as fd

    oracle = fd.SqliteOracle(fd.stream(0, 5)[0],
                             fd.make_nulls(5, fd.N_ROWS, 0.1))
    yield oracle
    oracle.lite.close()


@pytest.mark.parametrize("route", ["default", "device"])
def test_null_fuzzer_no_divergence(null_oracle, route):
    from adacom_tpu_torch.tools import fuzz_differential as fd

    res = fd.run(60, 5, "cpu", fd.DEVICE_ROUTE if route == "device"
                 else None, null_oracle, nulls=0.1)
    assert res["queries"] == 60 and not res["divergences"], \
        res["divergences"][:2]
    assert res["routes"]["device_scan"] > 0
