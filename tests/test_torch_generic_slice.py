"""The port's generic device path end to end, against the JAX package: the
same tables and SQL on adacom_tpu.Database() and
adacom_tpu_torch.Database(platform="cpu") must answer alike. On the CPU
the JAX package takes its generic device path for these queries too (its
accelerator gate is off there), so both sides decode, filter and reduce
segment pools: every forced codec and `auto`, mixed plain and packed
segments after an adaptive policy step, dense GROUP BY over 200 groups and
over two columns, float aggregates, NULLs, DELETE/UPDATE ... WHERE, device
scans (host_materialize=false) and filters through the torch expression
tier. Integers, strings and dates are exact; floats agree to 1e-12
relative (the summation order differs)."""

import math

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu_torch.exec import device_scan
from adacom_tpu_torch.exec import executor as texecutor


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


SEG_ROWS = 4096
N = 40_000  # nine full segments and a ragged tail
D_VALUES = np.random.default_rng(11).integers(-10**9, 10**9, 16)
V = int(D_VALUES[3])


def _data(n=N, seed=5):
    rng = np.random.default_rng(seed)
    row = np.arange(n)
    return {
        "k": row.astype(np.int64),
        "r": ((row // 128) % 200).astype(np.int32),
        "d": rng.choice(D_VALUES, n).astype(np.int32),
        "f": np.round(rng.random(n) * 1000, 2),
        "c": np.full(n, 42, np.int32),
        "a": (row % 7).astype(np.int32),
        "b": ((row // 3) % 5).astype(np.int32),
        "s": rng.choice(["apple", "banana", "blueberry", "cherry"],
                        n).astype(object),
        "dt": (18000 + row // 200).astype(np.int32),
        "n": rng.integers(-5000, 5000, n).astype(np.int32),
    }, {"n": rng.random(n) > 0.2}


DDL = ("CREATE TABLE g(k BIGINT, r INTEGER, d INTEGER, f DOUBLE, c INTEGER, "
       "a INTEGER, b INTEGER, s VARCHAR, dt DATE, n INTEGER)")


def _engine(mod, codec=None, n=N, **kw):
    cfg = mod.DBConfig()
    cfg.segment_rows = SEG_ROWS
    db = mod.Database(config=cfg, **kw)
    con = db.connect()
    con.query(DDL)
    data, valid = _data(n)
    app = con.appender("g")
    app.append_columns(data, valid)
    app.close()
    if codec is not None:
        con.query(f"SET compression_codec='{codec}'")
    return db, con


def _both(codec=None, n=N):
    return (_engine(adacom_tpu, codec, n),
            _engine(adacom_tpu_torch, codec, n, platform="cpu"))


def _compact(db):
    db.catalog.get_column_segment_catalog().compact_all_segments()


def _same(got, ref):
    """Rows equal, Python types equal; floats to 1e-12 relative."""
    assert len(got) == len(ref), (len(got), len(ref))
    for g_row, r_row in zip(got, ref):
        assert len(g_row) == len(r_row)
        for g, r in zip(g_row, r_row):
            assert type(g) is type(r), (g_row, r_row)
            if isinstance(r, (float, np.floating)) and not (
                    r is None or (math.isnan(r) and math.isnan(g))):
                assert math.isclose(g, r, rel_tol=1e-12, abs_tol=0), \
                    (g_row, r_row)
            elif isinstance(r, (float, np.floating)):
                assert math.isnan(g)
            else:
                assert g == r, (g_row, r_row)


@pytest.fixture(scope="module")
def engines():
    """(JAX, port) connection pairs: 'auto' (every column under its best
    codec) and 'mixed' (succinct, then one policy step that leaves the
    hottest segments plain)."""
    made, pairs = [], {}
    (jdb, jcon), (tdb, tcon) = _both("auto")
    for db in (jdb, tdb):
        _compact(db)
    pairs["auto"] = (jcon, tcon)
    (jdb2, jcon2), (tdb2, tcon2) = _both()
    for db in (jdb2, tdb2):
        _compact(db)
        segs = db.catalog.get_column_segment_catalog().segments_snapshot()
        for i, s in enumerate(segs):
            s.num_reads = (i * 7) % 11
        db.catalog.get_column_segment_catalog().compress_lowest_k_segments(0.6)
    pairs["mixed"] = (jcon2, tcon2)
    made += [jdb, tdb, jdb2, tdb2]
    yield pairs
    for db in made:
        db.close()


UNGROUPED = ("SELECT count(*), sum(k), min(k), max(k), sum(r), min(d), "
             "max(d), sum(f), min(f), max(f), avg(f), sum(c), count(n), "
             "sum(n), min(n), max(n) FROM g")
GROUP_200 = ("SELECT r, count(*), sum(k), min(d), max(f), avg(f), "
             "stddev(f), sum(n), count(n) FROM g GROUP BY r ORDER BY r")
GROUP_TWO = ("SELECT a, b, count(*), sum(k), min(f), max(d), avg(k), "
             "stddev(k) FROM g GROUP BY a, b ORDER BY a, b")
QUERIES = [
    ("ungrouped", UNGROUPED),
    ("group_200", GROUP_200),
    ("group_two_columns", GROUP_TWO),
    ("filtered", f"SELECT count(*), sum(f) FROM g WHERE d = {V} "
                 "AND k BETWEEN 1000 AND 30000"),
    ("float_aggregates", "SELECT sum(f * 2.5), avg(f / 3), min(f - 1), "
                         "max(f + k) FROM g WHERE f > 10.5"),
    ("arithmetic_filter", "SELECT count(*), sum(k) FROM g "
                          "WHERE (k * 3 + r) % 7 = 2"),
    ("in_list", f"SELECT count(*), sum(k) FROM g WHERE d IN "
                f"({int(D_VALUES[0])}, {V}, {int(D_VALUES[9])})"),
    ("like_dictionary", "SELECT count(*), sum(r) FROM g WHERE s LIKE 'b%'"),
    ("case", "SELECT sum(CASE WHEN f > 500 THEN k ELSE -k END), count(*) "
             "FROM g WHERE a < 5"),
    ("extract", "SELECT count(*), min(k) FROM g "
                "WHERE extract(month FROM dt) = 3"),
    ("grouped_filtered", "SELECT r, count(*), sum(f) FROM g "
                         "WHERE b = 2 AND f < 700 GROUP BY r ORDER BY r"),
]


# the mixed table repeats the queries whose routing it changes
MIXED = ("ungrouped", "group_200", "group_two_columns", "filtered",
         "like_dictionary")
CASES = [("auto", q) for _n, q in QUERIES] + [
    ("mixed", q) for n, q in QUERIES if n in MIXED]
CASE_IDS = [f"auto-{n}" for n, _q in QUERIES] + [f"mixed-{n}" for n in MIXED]


@pytest.mark.parametrize("table,sql", CASES, ids=CASE_IDS)
def test_same_answers_as_reference(engines, table, sql):
    jcon, tcon = engines[table]
    ref = jcon.query(sql).fetchall()
    before = device_scan.RUNS
    got = tcon.query(sql).fetchall()
    _same(got, ref)
    assert got and got[0][0] is not None
    assert device_scan.RUNS > before  # answered by the generic path


def test_auto_codecs_and_mixed_states(engines):
    """`auto` picks delta, rle, dictionary, alp and succinct as the JAX
    package does; the policy step leaves plain and packed segments."""
    for table in ("auto", "mixed"):
        jcon, tcon = engines[table]
        sql = "PRAGMA compression_info('g')"
        ref = [r[:7] for r in jcon.query(sql).fetchall()]
        got = [r[:7] for r in tcon.query(sql).fetchall()]
        assert got == ref
    info = {(r[1], r[3]) for r in got}
    states = {r[4] for r in got}
    assert states == {"plain", "packed"}
    auto = engines["auto"][1].query(sql).fetchall()
    codecs_of = {}
    for r in auto:
        codecs_of.setdefault(r[1], set()).add(r[3])
    assert codecs_of["k"] == {"delta"} and codecs_of["f"] == {"alp"}
    assert codecs_of["d"] == {"dictionary"} and codecs_of["c"] == {"succinct"}
    assert "rle" in codecs_of["r"]
    assert info


def test_generic_path_answers_without_the_host(engines, monkeypatch):
    def no_host(*_a, **_kw):
        raise AssertionError("answered by the host aggregate")

    monkeypatch.setattr(texecutor.Executor, "_aggregate_host", no_host)
    for table in ("auto", "mixed"):
        for sql in (UNGROUPED, GROUP_200, GROUP_TWO):
            engines[table][1].query(sql).fetchall()


def test_device_scan_matches_reference_and_host_tier(engines):
    sql = (f"SELECT k, f, s, n FROM g WHERE a = 3 AND d = {V} "
           "ORDER BY k")
    jcon, tcon = engines["auto"]
    tcon.query("SET host_materialize=true")
    before = device_scan.RUNS
    host = tcon.query(sql).fetchall()
    assert device_scan.RUNS == before
    try:
        for con in (jcon, tcon):
            con.query("SET host_materialize=false")
        before = device_scan.RUNS
        got = tcon.query(sql).fetchall()
        assert device_scan.RUNS > before
        ref = jcon.query(sql).fetchall()
    finally:
        jcon.query("SET host_materialize=true")
        tcon.query(f"SET host_materialize="
                   f"{adacom_tpu_torch.DBConfig().host_materialize}")
    assert got == ref == host and len(got) > 0


@pytest.mark.parametrize("codec", ["rle", "delta", "dictionary", "constant",
                                   "alp", "auto"])
def test_each_codec_end_to_end(codec):
    """SET force_compression (or compression_codec='auto') compacts with
    the codec wherever it applies; answers match the reference."""
    pairs = []
    for mod, kw in ((adacom_tpu, {}), (adacom_tpu_torch, {"platform": "cpu"})):
        cfg = mod.DBConfig()
        cfg.segment_rows = SEG_ROWS
        db = mod.Database(config=cfg, **kw)
        con = db.connect()
        con.query("CREATE TABLE t(k BIGINT, r INTEGER, d INTEGER, "
                  "c INTEGER, f DOUBLE)")
        data, _valid = _data(n=3 * SEG_ROWS, seed=9)
        app = con.appender("t")
        app.append_columns({c: data[c] for c in ("k", "r", "d", "c", "f")})
        app.close()
        if codec == "auto":
            con.query("SET compression_codec='auto'")
        else:
            con.query(f"SET force_compression='{codec}'")
        _compact(db)
        pairs.append((db, con))
    (jdb, jcon), (tdb, tcon) = pairs
    info = "PRAGMA compression_info('t')"
    got = [r[:7] for r in tcon.query(info).fetchall()]
    assert got == [r[:7] for r in jcon.query(info).fetchall()]
    if codec != "auto":
        assert codec in {r[3] for r in got}
    for sql in ("SELECT count(*), sum(k), sum(r), min(d), max(d), sum(c), "
                "sum(f), min(f) FROM t",
                "SELECT r, count(*), sum(f), max(k) FROM t GROUP BY r "
                "ORDER BY r"):
        _same(tcon.query(sql).fetchall(), jcon.query(sql).fetchall())
    jdb.close()
    tdb.close()


def test_delete_and_update_where():
    n = 5 * SEG_ROWS - 100
    (jdb, jcon), (tdb, tcon) = _both("auto", n)
    for db in (jdb, tdb):
        _compact(db)
    steps = [
        "DELETE FROM g WHERE k % 97 = 0",
        UNGROUPED,
        "SELECT * FROM g WHERE k < 300 ORDER BY k",
        f"UPDATE g SET f = f + 1, n = 7 WHERE d = {V} AND k > 15000",
        GROUP_200,
        "DELETE FROM g WHERE s = 'cherry' OR r > 150",
        "SELECT count(*), sum(k), sum(f), count(n) FROM g",
        "SELECT * FROM g WHERE k > 19500 ORDER BY k",
    ]
    for sql in steps:
        if sql.startswith(("DELETE", "UPDATE")):
            before = device_scan.RUNS
            jcon.query(sql)
            tcon.query(sql)
            assert device_scan.RUNS > before
            continue
        _same(tcon.query(sql).fetchall(), jcon.query(sql).fetchall())
    n_left = tcon.query("SELECT count(*) FROM g").fetchall()[0][0]
    assert 0 < n_left < n
    jdb.close()
    tdb.close()


def test_codec_settings():
    db = adacom_tpu_torch.Database(platform="cpu")
    con = db.connect()
    for name in ("constant", "rle", "delta", "dictionary", "alp", "auto",
                 "succinct", "uncompressed"):
        con.query(f"SET compression_codec='{name}'")
        assert db.config.compression_codec == name
    with pytest.raises(ValueError, match="unknown compression codec"):
        con.query("SET compression_codec='zstd'")
    db.close()


def test_empty_two_column_dense_group_by():
    """No segment survives the zonemaps: the partials start empty over the
    dense domain (dense[3]; the JAX package reads the sizes list)."""
    (jdb, jcon), (tdb, tcon) = _both()
    sql = "SELECT a, b, count(*), sum(k) FROM g WHERE k > 99999 GROUP BY a, b"
    assert tcon.query(sql).fetchall() == jcon.query(sql).fetchall() == []
    parts = device_scan._init_empty_partials(
        [("count", None, np.int64), ("sum", None, np.float64),
         ("min", None, np.int64)], ([0, 0], [5, 1], [7, 5], 35))
    assert [p.shape for p in parts] == [(35,)] * 3
    jdb.close()
    tdb.close()


# a UBIGINT operand: the comparison is unsigned
BIG_FIVE = "CAST(5 AS UBIGINT)"


def test_ubigint_stays_on_the_host():
    """UBIGINT has no exact device dtype: its SELECTs, and the WHERE of its
    DELETE/UPDATE, run on the host tier and compare as uint64 (rows from
    8,192 on hold values >= 2^63, negative as int64)."""
    pairs = []
    for mod, kw in ((adacom_tpu, {}), (adacom_tpu_torch, {"platform": "cpu"})):
        cfg = mod.DBConfig()
        cfg.segment_rows = SEG_ROWS
        db = mod.Database(config=cfg, **kw)
        con = db.connect()
        con.query("CREATE TABLE u(x UBIGINT, y INTEGER)")
        app = con.appender("u")
        app.append_columns({
            "x": (np.arange(10_000, dtype=np.uint64) << np.uint64(50)),
            "y": (np.arange(10_000) % 30).astype(np.int32)})
        app.close()
        _compact(db)
        pairs.append((db, con))
    before = device_scan.RUNS
    for sql in ("SELECT count(*), sum(y), max(x) FROM u WHERE y > 3",
                "SELECT y, count(*), max(x) FROM u GROUP BY y ORDER BY y",
                f"SELECT count(*), min(x) FROM u WHERE x > {BIG_FIVE}",
                # no UBIGINT column read, but a UBIGINT filter / argument
                f"SELECT count(*) FROM u WHERE CAST(y AS UBIGINT) > {BIG_FIVE}",
                "SELECT sum(CAST(y AS UBIGINT)), count(*) FROM u",
                f"UPDATE u SET y = y + 100 WHERE x > {BIG_FIVE} AND y = 7",
                f"DELETE FROM u WHERE x > {BIG_FIVE} AND y = 3",
                "SELECT count(*), sum(y), min(x), max(x) FROM u",
                "SELECT * FROM u ORDER BY x"):
        if sql.startswith(("DELETE", "UPDATE")):
            for _db, con in pairs:
                con.query(sql)
            continue
        _same(pairs[1][1].query(sql).fetchall(),
              pairs[0][1].query(sql).fetchall())
    assert device_scan.RUNS == before
    y = np.arange(10_000) % 30
    got = pairs[1][1].query("SELECT count(*), sum(CASE WHEN y = 107 THEN 1 "
                            "ELSE 0 END) FROM u").fetchall()
    assert got == [(10_000 - np.sum(y == 3), np.sum(y == 7))]
    for db, _con in pairs:
        db.close()


def test_grouped_min_max_over_nulls_against_numpy(engines):
    """A known fault of the reference: its generic path raises on min/max
    of a NULL-able INTEGER column per group (an int64 sentinel cast to
    int32). The port fills NULLs in the accumulator dtype; held against
    numpy instead."""
    data, valid = _data()
    r, n, ok = data["r"], data["n"], valid["n"]
    sql = "SELECT r, min(n), max(n), count(n) FROM g GROUP BY r ORDER BY r"
    for table in ("auto", "mixed"):
        got = engines[table][1].query(sql).fetchall()
        assert len(got) == 200
        for g_, mn, mx, cnt in got:
            sel = n[(r == g_) & ok]
            assert (mn, mx, cnt) == (sel.min(), sel.max(), len(sel))


@pytest.mark.parametrize("codec", ["succinct", "rle", "delta", "dictionary",
                                   "alp", "uncompressed"])
def test_segment_decode_and_fetch_rows_match_reference(codec):
    """ColumnSegment.decoded / fetch_rows in every representation."""
    rng = np.random.default_rng(2)
    vals = {"alp": np.round(rng.random(5000) * 100, 2),
            "rle": np.repeat(np.arange(10, dtype=np.int64), 500),
            "delta": np.cumsum(rng.integers(-100, 100, 5000))}.get(
        codec, rng.choice(np.asarray([-3, 7, 10**12]), 5000).astype(np.int64))
    idx = rng.integers(0, len(vals), 50)
    out = []
    for mod, kw in ((adacom_tpu, {}), (adacom_tpu_torch, {"platform": "cpu"})):
        cfg = mod.DBConfig()
        cfg.segment_rows = 8192
        db = mod.Database(config=cfg, **kw)
        con = db.connect()
        con.query("CREATE TABLE t(x DOUBLE)" if codec == "alp"
                  else "CREATE TABLE t(x BIGINT)")
        app = con.appender("t")
        app.append_column("x", vals)
        app.close()
        seg = db.catalog.get_table("t").columns["x"].segments[0]
        seg.compact(codec)
        assert seg.codec == (None if codec == "uncompressed" else codec)
        out.append((np.asarray(seg.decoded()) if mod is adacom_tpu
                    else seg.decoded().numpy(), seg.fetch_rows(idx)))
        db.close()
    (jdec, jrows), (tdec, trows) = out
    np.testing.assert_array_equal(tdec, vals)
    np.testing.assert_array_equal(tdec, jdec)
    np.testing.assert_array_equal(trows, jrows)
    assert trows.dtype == jrows.dtype


def test_boolean_unsigned_and_narrow_types():
    """BOOLEAN filters and groups, UINTEGER (int64 on the device),
    SMALLINT and FLOAT columns, and scalar functions in the arguments."""
    pairs = []
    for mod, kw in ((adacom_tpu, {}), (adacom_tpu_torch, {"platform": "cpu"})):
        cfg = mod.DBConfig()
        cfg.segment_rows = SEG_ROWS
        db = mod.Database(config=cfg, **kw)
        con = db.connect()
        con.query("CREATE TABLE t(b BOOLEAN, x INTEGER, u UINTEGER, "
                  "y SMALLINT, z FLOAT)")
        n = 5 * SEG_ROWS
        rng = np.random.default_rng(0)
        app = con.appender("t")
        data = {
            "b": (rng.random(n) > 0.5).astype(np.uint8),
            "x": rng.integers(-100, 100, n).astype(np.int32),
            "u": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            "y": rng.integers(-300, 300, n).astype(np.int16),
            "z": rng.random(n).astype(np.float32)}
        app.append_columns(data)
        app.close()
        _compact(db)
        pairs.append((db, con))
    for sql in (
            "SELECT count(*), sum(x) FROM t WHERE b",
            "SELECT b, count(*), sum(x), min(u), max(u), sum(z) FROM t "
            "WHERE NOT b OR u > 3000000000 GROUP BY b ORDER BY b",
            "SELECT sum(u * 2), sum(x / 3), sum(x % 7), max(z * 2), "
            "sum(y) FROM t WHERE x <> 0",
            "SELECT sum(abs(x)), sum(round(z * 10)), min(sqrt(u)), "
            "sum(CAST(x AS DOUBLE) / 7) FROM t"):
        got = pairs[1][1].query(sql).fetchall()
        if "x / 3" not in sql:
            _same(got, pairs[0][1].query(sql).fetchall())
            continue
        # integer / and % truncate toward zero in SQL; the JAX package
        # rounds down (ROADMAP queue C), so numpy holds this one
        k = data["x"] != 0
        x = data["x"][k].astype(np.int64)
        want = (2 * int(data["u"][k].astype(np.int64).sum()),
                int(((x - np.fmod(x, 3)) // 3).sum()),
                int(np.fmod(x, 7).sum()), 2 * float(data["z"][k].max()),
                int(data["y"][k].astype(np.int64).sum()))
        assert len(got) == 1 and len(got[0]) == len(want)
        for g, w in zip(got[0], want):
            assert g == w, (got, want)
    for db, _con in pairs:
        db.close()
