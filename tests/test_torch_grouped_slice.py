"""The port's grouped compressed scan -> aggregate path end to end, against
the JAX package: the same tables and SQL on adacom_tpu.Database() and
adacom_tpu_torch.Database(platform="cpu") must give identical fetchall(),
values and Python types. The shapes are tests/test_multi_agg.py's (the
multi-aggregate tier, kernel B3), tests/test_pallas.py's grouped engine
test (kernel B2), and TPC-H Q1 and Q6 at scale factor 0.01."""

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu.bench import tpch as jtpch
from adacom_tpu.exec import executor as jexecutor
from adacom_tpu_torch.bench import tpch as ttpch
from adacom_tpu_torch.exec import executor as texecutor
from adacom_tpu_torch.ops import grouped_scan


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


Q1ISH = """
SELECT rf, ls, sum(qty), sum(price), sum(price * (1 - disc)),
       sum(price * (1 - disc) * (1 + tax)), avg(qty), avg(disc), count(*)
FROM li WHERE ship <= 10800 GROUP BY rf, ls ORDER BY rf, ls
"""
# test_multi_agg.py's Q6 shape compares DECIMAL columns with integer
# literals (scaled: no segment survives the zonemaps); Q6ISH uses the
# TPC-H literals, so rows reach the kernel
Q6_INT = ("SELECT sum(price * disc), count(*) FROM li "
          "WHERE ship >= 10100 AND ship < 10400 AND disc >= 2 "
          "AND disc <= 6 AND qty < 2400")
Q6ISH = ("SELECT sum(price * disc), count(*) FROM li "
         "WHERE ship >= 10100 AND ship < 10400 AND disc >= 0.02 "
         "AND disc <= 0.06 AND qty < 24")
EMPTY = "SELECT rf, sum(price) FROM li WHERE ship > 99999 GROUP BY rf"
TWELVE = ("SELECT g, sum(v * w), sum(v), count(*) FROM t12 "
          "WHERE v >= 10 GROUP BY g ORDER BY g")
GROUPED = "SELECT g, sum(v), count(*), avg(v) FROM tg GROUP BY g ORDER BY g"
GROUPED_FILTERED = ("SELECT g, count(*), sum(v) FROM tg "
                    "WHERE v >= 10000 AND v < 50000 GROUP BY g ORDER BY g")


def _fill_li(con, n=7000, seed=3):
    """tests/test_multi_agg.py's lineitem-like table."""
    rng = np.random.default_rng(seed)
    con.query("CREATE TABLE li(qty DECIMAL(12,2), price DECIMAL(12,2), "
              "disc DECIMAL(12,2), tax DECIMAL(12,2), rf VARCHAR, "
              "ls VARCHAR, ship DATE)")
    app = con.appender("li")
    app.append_columns({
        "qty": rng.integers(100, 5001, n),
        "price": rng.integers(90000, 14_000_000, n),
        "disc": rng.integers(0, 11, n),
        "tax": rng.integers(0, 9, n),
        "rf": rng.choice(["A", "N", "R"], n).astype(object),
        "ls": rng.choice(["F", "O"], n).astype(object),
        "ship": rng.integers(10000, 11000, n),
    })
    app.close()


def _fill_small_domains(con):
    """The 12-group domain (test_multi_agg.py) and the grouped engine
    table of test_pallas.py (5 groups, INTEGER values)."""
    rng = np.random.default_rng(6)
    n = 30_000
    con.query("CREATE TABLE t12(g INTEGER, v DECIMAL(12,2), w DECIMAL(12,2))")
    app = con.appender("t12")
    app.append_columns({"g": rng.integers(0, 12, n).astype(np.int32),
                        "v": rng.integers(0, 10_000, n),
                        "w": rng.integers(0, 50, n)})
    app.close()
    rng = np.random.default_rng(31)
    con.query("CREATE TABLE tg(g INTEGER, v INTEGER)")
    app = con.appender("tg")
    app.append_columns({"g": rng.integers(0, 5, 20_000).astype(np.int32),
                        "v": rng.integers(100, 90_000, 20_000).astype(np.int32)})
    app.close()


def _db(mod, segment_rows, **db_kw):
    cfg = mod.DBConfig()
    cfg.segment_rows = segment_rows
    db = mod.Database(config=cfg, **db_kw)
    return db, db.connect()


def _compact(db):
    db.catalog.get_column_segment_catalog().compact_all_segments()


@pytest.fixture(scope="module")
def engines():
    """(JAX, port) connection pairs per table set: compacted li, an
    uncompacted li, the small-domain tables, TPC-H SF 0.01 lineitem."""
    made, pairs = [], {}
    data = jtpch.generate(sf=0.01)["lineitem"]
    for mod, kw in ((adacom_tpu, {}), (adacom_tpu_torch, {"platform": "cpu"})):
        db, con = _db(mod, 2048, **kw)
        _fill_li(con)
        _compact(db)
        raw_db, raw_con = _db(mod, 2048, **kw)
        _fill_li(raw_con, n=3000)
        sd_db, sd_con = _db(mod, 4096, **kw)
        _fill_small_domains(sd_con)
        _compact(sd_db)
        tp_db, tp_con = _db(mod, 1 << 16, **kw)
        jtpch.load_into_engine(tp_con, {"lineitem": data})
        _compact(tp_db)
        made += [db, raw_db, sd_db, tp_db]
        for name, c in (("li", con), ("raw", raw_con), ("sd", sd_con),
                        ("tpch", tp_con)):
            pairs.setdefault(name, []).append(c)
    yield pairs
    for db in made:
        db.close()


CASES = [
    ("li", Q1ISH), ("li", Q6ISH), ("li", Q6_INT), ("li", EMPTY),
    ("raw", Q1ISH),
    ("sd", TWELVE), ("sd", GROUPED), ("sd", GROUPED_FILTERED),
    ("tpch", jtpch.QUERIES[1]), ("tpch", jtpch.QUERIES[6]),
]
CASE_IDS = ["q1ish", "q6ish", "q6_int_literals", "empty_pred_absent_groups",
            "uncompacted",
            "twelve_groups", "grouped", "grouped_filtered", "tpch_q1",
            "tpch_q6"]


@pytest.mark.parametrize("table,sql", CASES, ids=CASE_IDS)
def test_same_answers_as_reference(engines, table, sql):
    jcon, tcon = engines[table]
    ref = jcon.query(sql).fetchall()
    got = tcon.query(sql).fetchall()
    assert got == ref
    assert [tuple(type(x) for x in r) for r in got] == \
        [tuple(type(x) for x in r) for r in ref]
    if sql == EMPTY:
        assert got == []
    elif sql != Q6_INT:
        assert got and got[0][-1] > 0


# (table, sql, the entry point that must answer it)
ROUTES = [
    ("li", Q1ISH, "multi_grouped_scan_table"),
    ("li", Q6ISH, "multi_grouped_scan_table"),
    ("sd", TWELVE, "multi_grouped_scan_table"),
    ("sd", GROUPED, "grouped_scan_table"),
    ("sd", GROUPED_FILTERED, "grouped_scan_table"),
    ("tpch", ttpch.QUERIES[1], "multi_grouped_scan_table"),
    ("tpch", ttpch.QUERIES[6], "multi_grouped_scan_table"),
]


@pytest.mark.parametrize("table,sql,entry", ROUTES,
                         ids=[c for c in CASE_IDS if c not in
                              ("q6_int_literals", "empty_pred_absent_groups",
                               "uncompacted")])
def test_routed_through_the_grouped_kernels(engines, monkeypatch, table, sql,
                                            entry):
    """The port answers these through B2 or B3 (the entry points that
    launch the kernel on a card), never through the host aggregate."""
    _jcon, tcon = engines[table]
    calls = {"grouped_scan_table": 0, "multi_grouped_scan_table": 0}
    for name in calls:
        real = getattr(grouped_scan, name)

        def counting(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(grouped_scan, name, counting)

    def no_host(*_a, **_kw):
        raise AssertionError("answered by the host aggregate")

    monkeypatch.setattr(texecutor.Executor, "_aggregate_host", no_host)
    tcon.query(sql).fetchall()
    assert calls[entry] >= 1
    assert sum(calls.values()) == calls[entry]


def test_uncompacted_and_holistic_stay_on_the_host(engines, monkeypatch):
    calls = []
    real = grouped_scan.multi_grouped_scan_table
    monkeypatch.setattr(grouped_scan, "multi_grouped_scan_table",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    engines["raw"][1].query(Q1ISH).fetchall()
    engines["li"][1].query("SELECT rf, count(DISTINCT ls) FROM li "
                           "GROUP BY rf ORDER BY rf").fetchall()
    assert calls == []


def test_tpch_generator_matches_reference():
    ref = jtpch.generate(sf=0.01)
    got = ttpch.generate(sf=0.01)
    assert got.keys() == ref.keys()
    for tname, cols in ref.items():
        assert got[tname].keys() == cols.keys()
        for c, arr in cols.items():
            assert got[tname][c].dtype == arr.dtype, (tname, c)
            np.testing.assert_array_equal(got[tname][c], arr)
    li = ttpch.generate_lineitem(sf=0.01)
    for c, arr in ref["lineitem"].items():
        np.testing.assert_array_equal(li[c], arr)
    assert ttpch.QUERIES == jtpch.QUERIES and ttpch.DDL == jtpch.DDL


def _poly_cases(bmod, ttmod):
    dec2 = ttmod.DECIMAL(12, 2)
    price = bmod.BColumn(dec2, 1, "price")
    disc = bmod.BColumn(dec2, 2, "disc")
    tax = bmod.BColumn(dec2, 3, "tax")
    one = bmod.BLiteral(ttmod.BIGINT, 1)
    disc_price = bmod.BBinary(ttmod.DECIMAL(38, 4), "*", price,
                              bmod.BBinary(ttmod.DECIMAL(38, 2), "-", one, disc))
    return [
        # price * (1 - disc): scale 4, {(1,): 100, (1,2): -1}
        disc_price,
        # price * (1 - disc) * (1 + tax): the Q1 charge, degree 3
        bmod.BBinary(ttmod.DECIMAL(38, 6), "*", disc_price,
                     bmod.BBinary(ttmod.DECIMAL(38, 2), "+", one, tax)),
        # non-decomposable: division
        bmod.BBinary(ttmod.DOUBLE, "/", price, disc),
    ]


def test_poly_decompose_matches_reference():
    from adacom_tpu import types as jtt
    from adacom_tpu.sql import bound as jb
    from adacom_tpu_torch import types as ttt
    from adacom_tpu_torch.sql import bound as tb

    for je, te in zip(_poly_cases(jb, jtt), _poly_cases(tb, ttt)):
        assert texecutor._poly_decompose(te, ()) == \
            jexecutor._poly_decompose(je, ())
    terms, scale = texecutor._poly_decompose(_poly_cases(tb, ttt)[0], ())
    assert (terms, scale) == ({(1,): 100, (1, 2): -1}, 4)
    assert texecutor._poly_decompose(_poly_cases(tb, ttt)[2], ()) is None
