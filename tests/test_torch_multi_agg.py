"""The multi-aggregate device tier's fallbacks and neighbours in the port,
against the JAX package: the twins of the tests/test_multi_agg.py cases
that tests/test_torch_grouped_slice.py does not hold (that file runs the
Q1 shape, the twelve-group domain and the polynomial decomposition).

Each scenario runs on both packages (the JAX package on its CPU backend
with its Pallas kernels in interpret mode, the port with platform="cpu",
where B1-B3 run their plain versions) on the same seeded data: the
ungrouped Q6-shaped sum under filters on three columns, an empty
predicate with absent groups, the Q1 shape over uncompacted segments and
after deletes, the auto-index, count(*) over wide plain segments and a
LEFT JOIN pipeline's NULL counts. Each holds its answer against the same
database with the device tier (or the streamed sink) switched off, as the
reference test does, and returns the answers, which must be equal across
the packages. Tolerance: integers and DECIMAL exactly; floats (avg)
within 1e-9 relative, the reference's `_cmp`."""

import math

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch

PKGS = {"jax": adacom_tpu, "port": adacom_tpu_torch}

Q1ISH = """
SELECT rf, ls, sum(qty), sum(price), sum(price * (1 - disc)),
       sum(price * (1 - disc) * (1 + tax)), avg(qty), avg(disc), count(*)
FROM li WHERE ship <= 10800 GROUP BY rf, ls ORDER BY rf, ls
"""


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


def _mkdb(pkg, **cfg_kw):
    cfg = pkg.DBConfig()
    cfg.segment_rows = 2048
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    kw = {"platform": "cpu"} if pkg is adacom_tpu_torch else {}
    db = pkg.Database(config=cfg, **kw)
    return db, db.connect()


def _fill(con, n=7000, seed=3):
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


def _compact(db):
    db.catalog.get_column_segment_catalog().compact_all_segments()


def _cmp(r1, r2):
    assert len(r1) == len(r2)
    for a, c in zip(r1, r2):
        assert len(a) == len(c)
        for x, y in zip(a, c):
            if isinstance(x, float) or isinstance(y, float):
                assert math.isclose(x, y, rel_tol=1e-9, abs_tol=1e-9), (a, c)
            else:
                assert x == y, (a, c)


def _with_host_tier(db, sql):
    """The same query with the fused device tiers switched off."""
    db.config.pallas_scan_enabled = False
    try:
        return db.connect().query(sql).fetchall()
    finally:
        db.config.pallas_scan_enabled = True


# ======================================================================
# twins: one scenario per reference test, run on each package
# ======================================================================


def _ungrouped_multi_filter_sum_matches_host(pkg):
    """Q6 shape: sum(price * disc) under range filters on three columns
    (the reference's integer literals against DECIMAL columns, and the
    TPC-H literals, under which rows reach the tier)."""
    db, con = _mkdb(pkg)
    _fill(con)
    _compact(db)
    out = []
    for lits in (("2", "6", "2400"), ("0.02", "0.06", "24")):
        q = (f"SELECT sum(price * disc), count(*) FROM li "
             f"WHERE ship >= 10100 AND ship < 10400 AND disc >= {lits[0]} "
             f"AND disc <= {lits[1]} AND qty < {lits[2]}")
        before = db.dist_stats.get("pallas_multi_agg", 0)
        r1 = con.query(q).fetchall()
        assert db.dist_stats.get("pallas_multi_agg", 0) > before
        _cmp(r1, _with_host_tier(db, q))
        out.append(r1)
    assert out[1][0][1] > 0
    db.close()
    return out


def _empty_predicate_and_absent_groups(pkg):
    db, con = _mkdb(pkg)
    _fill(con, n=3000)
    _compact(db)
    out = [con.query("SELECT rf, sum(price) FROM li WHERE ship > 99999 "
                     "GROUP BY rf").fetchall(),
           con.query("SELECT sum(price), count(*) FROM li "
                     "WHERE ship > 99999").fetchall()]
    assert out[0] == []
    _cmp(out[1], _with_host_tier(db, "SELECT sum(price), count(*) FROM li "
                                     "WHERE ship > 99999"))
    db.close()
    return out


def _uncompacted_falls_back_to_host(pkg):
    db, con = _mkdb(pkg)
    _fill(con, n=3000)
    # no compaction: the tier declines, the answers stay right
    r1 = con.query(Q1ISH).fetchall()
    assert db.dist_stats.get("pallas_multi_agg", 0) == 0
    _cmp(r1, _with_host_tier(db, Q1ISH))
    db.close()
    return [r1]


def _deletes_fall_back_and_stay_correct(pkg):
    db, con = _mkdb(pkg)
    _fill(con, n=4000)
    _compact(db)
    con.query("DELETE FROM li WHERE qty < 1000")
    r1 = con.query(Q1ISH).fetchall()
    _cmp(r1, _with_host_tier(db, Q1ISH))
    assert sum(r[-1] for r in r1) == int(con.query(
        "SELECT count(*) FROM li WHERE ship <= 10800").scalar())
    db.close()
    return [r1]


def _auto_index_builds_and_serves(pkg):
    db, con = _mkdb(pkg, auto_index_threshold=8)
    rng = np.random.default_rng(11)
    n = 20_000
    # interleaved keys: no zonemap prunes, every segment scans
    keys = rng.permutation(n).astype(np.uint64) * np.uint64(1 << 40) \
        | rng.integers(0, 1 << 20, n).astype(np.uint64)
    con.query("CREATE TABLE t(i UBIGINT)")
    app = con.appender("t")
    app.append_column("i", keys)
    app.close()
    _compact(db)
    out = []
    for v in keys[:20]:
        r = con.query(f"SELECT i FROM t WHERE i == {v}").fetchall()
        assert len(r) == 1 and int(r[0][0]) == int(v)
        out.append(int(r[0][0]))
    assert db.dist_stats.get("auto_index_built", 0) == 1
    t = db.catalog.get_table("t")
    assert any(ix.name.startswith("__auto_") for ix in t.indexes)
    # after the build: a miss, and an append that the index finds
    out.append(con.query("SELECT i FROM t WHERE i == 12345").row_count)
    con.query("INSERT INTO t VALUES (777)")
    out.append(con.query("SELECT i FROM t WHERE i == 777").row_count)
    assert out[-2:] == [0, 1]
    db.close()
    return [[(x,) for x in out]]


def _count_star_plain_wide_segments(pkg):
    """A bare count(*) over plain full-width segments (65,536 rows, no
    succinct packing) counts every row."""
    cfg = pkg.DBConfig()
    cfg.succinct_enabled = False
    db = pkg.Database(config=cfg, **({"platform": "cpu"}
                                     if pkg is adacom_tpu_torch else {}))
    try:
        con = db.connect()
        con.query("CREATE TABLE t(i UINTEGER)")
        n = 200_000
        app = con.appender("t")
        app.append_column("i", np.arange(n, dtype=np.uint32))
        app.close()
        out = [int(con.query("SELECT count(*) FROM t").scalar()),
               tuple(int(x) for x in con.query(
                   "SELECT count(*), sum(i) FROM t").fetchone())]
        assert out == [n, (n, n * (n - 1) // 2)]
        return [[(out[0],), out[1]]]
    finally:
        db.close()


def _left_join_pipeline_null_counts(pkg):
    """An aggregate over a LEFT JOIN rides the streamed pipeline; unmatched
    rows carry NULL right columns, which count(right column) skips."""
    db, con = _mkdb(pkg)
    try:
        rng = np.random.default_rng(19)
        con.query("CREATE TABLE c(ck INTEGER)")
        app = con.appender("c")
        app.append_column("ck", np.arange(6000, dtype=np.int32))
        app.close()
        con.query("CREATE TABLE o(ck INTEGER, ok INTEGER)")
        # only even customers have orders, 0-3 each
        cks, oks, k = [], [], 0
        for ck in range(0, 6000, 2):
            for _ in range(int(rng.integers(0, 4))):
                cks.append(ck)
                oks.append(k)
                k += 1
        app = con.appender("o")
        app.append_columns({"ck": np.asarray(cks, np.int32),
                            "ok": np.asarray(oks, np.int32)})
        app.close()
        _compact(db)
        q = ("SELECT c.ck, count(o.ok) FROM c LEFT JOIN o ON c.ck = o.ck "
             "GROUP BY c.ck ORDER BY c.ck")
        r1 = con.query(q).fetchall()
        assert len(r1) == 6000
        assert db.dist_stats.get("streamed_join_agg", 0) >= 1
        want = np.bincount(np.asarray(cks), minlength=6000)
        assert [int(r[1]) for r in r1] == want.tolist()
        db.config.streaming_agg_sink_enabled = False
        assert db.connect().query(q).fetchall() == r1
        return [r1]
    finally:
        db.close()


TWINS = {f.__name__.lstrip("_"): f for f in (
    _ungrouped_multi_filter_sum_matches_host,
    _empty_predicate_and_absent_groups, _uncompacted_falls_back_to_host,
    _deletes_fall_back_and_stay_correct, _auto_index_builds_and_serves,
    _count_star_plain_wide_segments, _left_join_pipeline_null_counts)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_of_test_multi_agg(name):
    got = {k: TWINS[name](pkg) for k, pkg in PKGS.items()}
    assert len(got["port"]) == len(got["jax"])
    for port_rows, jax_rows in zip(got["port"], got["jax"]):
        _cmp(port_rows, jax_rows)
