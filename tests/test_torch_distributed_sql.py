"""Distributed SQL on the port (Database(mesh=make_virtual_mesh(8, "cpu")))
against the JAX package on its 8-device virtual CPU mesh: the same tables,
from a seed, and the same SQL on both. Every case of
tests/test_distributed_sql.py runs on both engines, and so do
compression_codec='auto' tables, DECIMAL / DATE / VARCHAR / DOUBLE
aggregates, a DELETE before the aggregate, set operations and the
fallbacks to the host join. Integers, DECIMALs, dates and strings are
exact; DOUBLE sums agree to 1e-12 relative (the shards' partials merge in
another order). The dist_stats counters equal the JAX package's on the
same plans. Where the JAX package is not SQL, the port is held against
sqlite (NULL join keys) or numpy (a join key of int64 max)."""

import math
import sqlite3

import jax
import numpy as np
import pytest

import adacom_tpu as at
import adacom_tpu_torch as att
from adacom_tpu.parallel import mesh as jmesh
from adacom_tpu_torch.parallel import mesh as pmesh

pytestmark = pytest.mark.mesh

N_DEV = 8


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
def meshes():
    if len(jax.devices()) < N_DEV:
        pytest.skip("needs 8 devices")
    return jmesh.make_mesh(N_DEV), pmesh.make_virtual_mesh(N_DEV, "cpu")


def _mk_db(mod, mesh, **cfg_kw):
    cfg = mod.DBConfig()
    cfg.segment_rows = 1024
    cfg.host_scan_segment_limit = 0
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    kw = {"platform": "cpu"} if mod is att else {}
    db = mod.Database(config=cfg, mesh=mesh, **kw)
    return db, db.connect()


def _load(con, table, cols, valid=None):
    app = con.appender(table)
    app.append_columns(cols, valid) if valid else app.append_columns(cols)
    app.close()


def _val(v):
    if isinstance(v, (np.integer, bool)):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def _same(got, ref, what):
    assert len(got) == len(ref), (what, len(got), len(ref))
    for g_row, r_row in zip(got, ref):
        assert len(g_row) == len(r_row), what
        for g, r in zip(g_row, r_row):
            g, r = _val(g), _val(r)
            if isinstance(r, float):
                assert isinstance(g, float), (what, g_row, r_row)
                assert math.isclose(g, r, rel_tol=1e-12, abs_tol=0), \
                    (what, g_row, r_row)
            else:
                assert g == r and type(g) is type(r), (what, g_row, r_row)


def _twins(meshes, setup, queries, compact=True, **cfg_kw):
    """Run setup(con) on both engines, then each query: the port's rows and
    dist_stats increments equal the JAX package's (a DELETE runs on both,
    unanswered). Returns the port's database, connection and answers."""
    jm, tm = meshes
    (jdb, jcon), (tdb, tcon) = (_mk_db(at, jm, **cfg_kw),
                                _mk_db(att, tm, **cfg_kw))
    for db, con in ((jdb, jcon), (tdb, tcon)):
        setup(con)
        if compact:
            db.catalog.get_column_segment_catalog().compact_all_segments()
    answers = []
    for sql in queries:
        if sql.startswith("DELETE"):
            jcon.query(sql)
            tcon.query(sql)
            continue
        jb, tb = dict(jdb.dist_stats), dict(tdb.dist_stats)
        ref = jcon.query(sql).fetchall()
        got = tcon.query(sql).fetchall()
        _same(got, ref, sql)
        jd = {k: jdb.dist_stats[k] - jb.get(k, 0) for k in ("scan_agg", "join")}
        td = {k: tdb.dist_stats[k] - tb.get(k, 0) for k in ("scan_agg", "join")}
        assert td == jd, (sql, td, jd)
        answers.append((got, td))
    jdb.close()
    return tdb, tcon, answers


# ----------------------------------------------------------------------
# the cases of tests/test_distributed_sql.py
# ----------------------------------------------------------------------

def test_distributed_ungrouped_aggregate(meshes, rng):
    vals = rng.integers(0, 100_000, 20_000).astype(np.uint32)
    sql = "SELECT count(*), sum(i), min(i), max(i) FROM t WHERE i < 50000"
    db, _con, [(got, d)] = _twins(meshes, lambda c: (
        c.query("CREATE TABLE t(i UINTEGER)"), _load(c, "t", {"i": vals})),
        [sql])
    m = vals < 50000
    assert tuple(int(x) for x in got[0]) == (
        int(m.sum()), int(vals[m].astype(np.int64).sum()),
        int(vals[m].min()), int(vals[m].max()))
    assert d["scan_agg"] > 0
    db.close()


def test_distributed_grouped_aggregate(meshes, rng):
    k = rng.integers(0, 16, 30_000).astype(np.int32)
    v = rng.integers(-1000, 1000, 30_000).astype(np.int64)
    sql = "SELECT k, sum(v), count(*) FROM t GROUP BY k ORDER BY k"
    db, _con, [(res, d)] = _twins(meshes, lambda c: (
        c.query("CREATE TABLE t(k INTEGER, v BIGINT)"),
        _load(c, "t", {"k": k, "v": v})), [sql])
    assert d["scan_agg"] > 0
    exp_sum = np.zeros(16, np.int64)
    np.add.at(exp_sum, k, v)
    exp_cnt = np.bincount(k, minlength=16)
    assert len(res) == 16
    for row in res:
        assert int(row[1]) == exp_sum[int(row[0])]
        assert int(row[2]) == exp_cnt[int(row[0])]
    db.close()


@pytest.mark.parametrize("ty", ["UBIGINT", "BIGINT"])
def test_distributed_64bit_two_plane(meshes, rng, ty):
    """Two-plane 64-bit packed columns. A UBIGINT plan runs on the port's
    host tier (torch has no exact uint64 arithmetic), so only its answers
    are held against the JAX package's; a BIGINT column of the same values
    takes the distributed path on both."""
    vals = (rng.integers(0, 1 << 40, 8_000).astype(np.uint64)
            + np.uint64(1 << 41))
    col = vals if ty == "UBIGINT" else vals.astype(np.int64)
    sql = "SELECT count(*), min(i), max(i), sum(i) FROM t"
    jm, tm = meshes
    (jdb, jcon), (tdb, tcon) = _mk_db(at, jm), _mk_db(att, tm)
    for db, con in ((jdb, jcon), (tdb, tcon)):
        con.query(f"CREATE TABLE t(i {ty})")
        _load(con, "t", {"i": col})
        db.catalog.get_column_segment_catalog().compact_all_segments()
    ref, got = jcon.query(sql).fetchall(), tcon.query(sql).fetchall()
    _same(got, ref, sql)
    assert (int(got[0][0]), int(got[0][1]), int(got[0][2])) == (
        len(vals), int(vals.min()), int(vals.max()))
    assert jdb.dist_stats["scan_agg"] > 0
    assert tdb.dist_stats["scan_agg"] == (0 if ty == "UBIGINT" else
                                          jdb.dist_stats["scan_agg"])
    jdb.close()
    tdb.close()


def test_distributed_join(meshes, rng):
    nb, npr = 2_000, 6_000
    bk = np.arange(nb, dtype=np.int32)
    pk = rng.integers(0, nb * 2, npr).astype(np.int32)
    pv = np.arange(npr, dtype=np.int32)

    def setup(c):
        c.query("CREATE TABLE build(k INTEGER, w INTEGER)")
        c.query("CREATE TABLE probe(k INTEGER, v INTEGER)")
        _load(c, "build", {"k": bk, "w": bk * 7})
        _load(c, "probe", {"k": pk, "v": pv})

    sql = "SELECT count(*), sum(b.w) FROM probe p JOIN build b ON p.k = b.k"
    db, _con, [(res, d)] = _twins(meshes, setup, [sql], compact=False,
                                  distributed_join_rows=1)
    m = pk < nb
    assert int(res[0][0]) == int(m.sum())
    assert int(res[0][1]) == int((pk[m].astype(np.int64) * 7).sum())
    assert d["join"] > 0
    db.close()


def test_distributed_join_falls_back_on_duplicates(meshes):
    bk = np.asarray([1, 1, 2, 3] * 100, np.int32)
    pk = np.asarray([1, 2, 9] * 200, np.int32)

    def setup(c):
        c.query("CREATE TABLE b2(k INTEGER)")
        c.query("CREATE TABLE p2(k INTEGER)")
        _load(c, "b2", {"k": bk})
        _load(c, "p2", {"k": pk})

    sql = "SELECT count(*) FROM p2 JOIN b2 ON p2.k = b2.k"
    db, _con, [(res, d)] = _twins(meshes, setup, [sql], compact=False,
                                  distributed_join_rows=1)
    assert int(res[0][0]) == sum(int((bk == x).sum()) for x in pk)
    assert d["join"] == 0
    db.close()


# ----------------------------------------------------------------------
# beyond them
# ----------------------------------------------------------------------

def _typed(rng, n=24_000):
    return {
        "k": np.arange(n, dtype=np.int64),
        "g": ((np.arange(n) // 64) % 40).astype(np.int32),
        "p": rng.integers(100, 10_000_000, n).astype(np.int64),  # cents
        "f": np.round(rng.random(n) * 1000, 3),
        "dt": (9000 + rng.integers(0, 2500, n)).astype(np.int32),
        "s": rng.choice(["AIR", "MAIL", "SHIP", "TRUCK"], n).astype(object),
    }


TYPED_DDL = ("CREATE TABLE ty(k BIGINT, g INTEGER, p DECIMAL(12,2), "
             "f DOUBLE, dt DATE, s VARCHAR)")
TYPED_QUERIES = [
    "SELECT count(*), sum(p), min(p), max(p), sum(f), min(dt), max(dt) "
    "FROM ty",
    "SELECT g, count(*), sum(p), sum(f), min(dt), max(f) FROM ty "
    "GROUP BY g ORDER BY g",
    "SELECT count(*), sum(k), sum(p) FROM ty WHERE dt < DATE '1995-01-01' "
    "AND f > 250.5",
    "SELECT s, count(*), sum(k) FROM ty GROUP BY s ORDER BY s",
    "SELECT min(s), max(s), count(*) FROM ty WHERE g < 10",
]


@pytest.mark.parametrize("codec", [None, "auto"])
def test_typed_aggregates_on_the_mesh(meshes, rng, codec):
    data = _typed(rng)

    def setup(c):
        c.query(TYPED_DDL)
        _load(c, "ty", data)
        if codec is not None:
            c.query(f"SET compression_codec='{codec}'")

    db, _con, answers = _twins(meshes, setup, TYPED_QUERIES)
    assert answers[0][1]["scan_agg"] > 0 and answers[1][1]["scan_agg"] > 0
    got = answers[0][0][0]
    assert int(got[0]) == len(data["k"])
    assert math.isclose(float(got[4]), float(data["f"].sum()), rel_tol=1e-12)
    db.close()


def test_delete_before_the_aggregate(meshes, rng):
    """Segments with a delete mask stay on the single-device path (in both
    packages); the rest of the table still runs distributed."""
    data = _typed(rng)
    queries = ["DELETE FROM ty WHERE k % 13 = 0 AND k < 9000",
               TYPED_QUERIES[0], TYPED_QUERIES[1],
               "SELECT count(*), sum(p) FROM ty WHERE g = 7"]

    def setup(c):
        c.query(TYPED_DDL)
        _load(c, "ty", data)

    db, _con, answers = _twins(meshes, setup, queries)
    keep = ~((data["k"] % 13 == 0) & (data["k"] < 9000))
    assert int(answers[0][0][0][0]) == int(keep.sum())
    assert answers[0][1]["scan_agg"] > 0
    db.close()


def test_joins_and_set_operations_on_the_mesh(meshes, rng):
    n_o, n_l = 3_000, 12_000
    okey = np.arange(n_o, dtype=np.int64) * 4
    ocust = rng.integers(0, 300, n_o).astype(np.int32)
    lkey = rng.choice(okey, n_l) + np.where(rng.random(n_l) < 0.1, 1, 0)
    lqty = rng.integers(1, 50, n_l).astype(np.int64)

    def setup(c):
        c.query("CREATE TABLE o(okey BIGINT, cust INTEGER)")
        c.query("CREATE TABLE l(okey BIGINT, qty BIGINT)")
        _load(c, "o", {"okey": okey, "cust": ocust})
        _load(c, "l", {"okey": lkey.astype(np.int64), "qty": lqty})

    queries = [
        "SELECT count(*), sum(l.qty), sum(o.cust) FROM l JOIN o "
        "ON l.okey = o.okey",
        "SELECT o.cust, sum(l.qty) FROM l JOIN o ON l.okey = o.okey "
        "WHERE o.cust < 20 GROUP BY o.cust ORDER BY o.cust",
        # two key columns: hashed keys, verified pairs
        "SELECT count(*) FROM l JOIN o ON l.okey = o.okey "
        "AND l.qty = o.cust % 50",
        "SELECT count(*) FROM (SELECT okey FROM l EXCEPT SELECT okey FROM o)",
        "SELECT count(*) FROM (SELECT okey FROM l INTERSECT "
        "SELECT okey FROM o)",
    ]
    db, _con, answers = _twins(meshes, setup, queries,
                               distributed_join_rows=1)
    live = set(okey.tolist())
    m = np.asarray([k in live for k in lkey.tolist()])
    assert int(answers[0][0][0][0]) == int(m.sum())
    assert answers[0][1]["join"] > 0
    db.close()


def test_join_below_the_threshold_stays_on_the_host(meshes, rng):
    keys = np.arange(500, dtype=np.int32)

    def setup(c):
        c.query("CREATE TABLE a(k INTEGER)")
        c.query("CREATE TABLE b(k INTEGER)")
        _load(c, "a", {"k": keys})
        _load(c, "b", {"k": keys[::2]})

    db, _con, [(res, d)] = _twins(
        meshes, setup, ["SELECT count(*) FROM a JOIN b ON a.k = b.k"],
        compact=False, distributed_join_rows=10_000)
    assert int(res[0][0]) == 250 and d["join"] == 0
    db.close()


def test_null_join_keys_vs_sqlite(meshes, rng):
    """A NULL key matches nothing on the mesh's shuffle join too (the JAX
    package matches NULL to NULL there, ROADMAP queue C)."""
    _jm, tm = meshes
    n = 4_000
    lk = rng.integers(0, 1_000, n).astype(np.int64)
    lok = rng.random(n) > 0.2
    rk = np.arange(1_000, dtype=np.int64)
    rok = rng.random(1_000) > 0.2
    db, con = _mk_db(att, tm, distributed_join_rows=1)
    lite = sqlite3.connect(":memory:")
    for name, keys, ok in (("l", lk, lok), ("r", rk, rok)):
        con.query(f"CREATE TABLE {name}(k BIGINT, v BIGINT)")
        _load(con, name, {"k": keys, "v": np.arange(len(keys))},
              {"k": ok})
        lite.execute(f"CREATE TABLE {name}(k INTEGER, v INTEGER)")
        lite.executemany(f"INSERT INTO {name} VALUES (?, ?)", [
            (int(k) if o else None, i)
            for i, (k, o) in enumerate(zip(keys, ok))])
    for sql in (
            "SELECT count(*), sum(l.v), sum(r.v) FROM l JOIN r ON l.k = r.k",
            "SELECT count(*) FROM l LEFT JOIN r ON l.k = r.k "
            "WHERE r.v IS NULL"):
        before = db.dist_stats["join"]
        got = con.query(sql).fetchall()
        _same(got, lite.execute(sql).fetchall(), sql)
        assert db.dist_stats["join"] > before
    db.close()


def test_int64_max_join_key_vs_numpy(meshes):
    """A build key of int64 max in the build table's last rows (the last
    shard's) joins its probe row."""
    _jm, tm = meshes
    nb = 64
    bk = np.arange(nb, dtype=np.int64) * 5
    bk[60] = np.iinfo(np.int64).max
    pk = np.arange(128, dtype=np.int64) * 3
    pk[0] = np.iinfo(np.int64).max
    db, con = _mk_db(att, tm, distributed_join_rows=1)
    con.query("CREATE TABLE b(k BIGINT, w BIGINT)")
    con.query("CREATE TABLE p(k BIGINT, v BIGINT)")
    _load(con, "b", {"k": bk, "w": np.arange(nb, dtype=np.int64)})
    _load(con, "p", {"k": pk, "v": np.arange(128, dtype=np.int64)})
    got = con.query("SELECT p.v, b.w FROM p JOIN b ON p.k = b.k "
                    "ORDER BY p.v").fetchall()
    want = sorted((i, j) for i in range(128) for j in range(nb)
                  if pk[i] == bk[j])
    assert [(int(a), int(b)) for a, b in got] == want and (0, 60) in want
    assert db.dist_stats["join"] > 0
    db.close()


def test_pools_smaller_than_the_mesh_and_empty_answers(meshes, rng):
    """Pools of two and of one segment (two full, one ragged) pad to the
    8 shards with zero-count dummies; shards holding only dummies
    contribute the identities, and aggregates over no row give the empty
    answers."""
    n_rows = 3_000
    v = rng.integers(-50, 50, n_rows).astype(np.int32)
    f = rng.random(n_rows)

    def setup(c):
        c.query("CREATE TABLE e(v INTEGER, f DOUBLE)")
        _load(c, "e", {"v": v, "f": f})

    queries = [
        "SELECT count(*), sum(v), min(v), max(v), min(f), max(f) FROM e",
        "SELECT count(*), sum(v), min(v), max(v), avg(f) FROM e "
        "WHERE v > 40 AND v < 41",
        "SELECT count(*), min(v), max(f) FROM e WHERE v > 1000",
        "SELECT v, count(*), min(f) FROM e WHERE v < -45 GROUP BY v "
        "ORDER BY v",
    ]
    db, _con, answers = _twins(meshes, setup, queries)
    assert answers[0][1]["scan_agg"] == 2
    assert int(answers[0][0][0][0]) == n_rows
    assert answers[1][0][0][0] == 0 and answers[1][0][0][2] is None
    db.close()


def test_mesh_of_another_device_type_raises():
    with pytest.raises(ValueError, match="mesh of cuda devices"):
        att.Database(platform="cpu",
                     mesh=pmesh.make_virtual_mesh(2, "cuda"))
