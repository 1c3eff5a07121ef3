"""The port's three cost-routing knobs on the CPU: each route a knob can
force gives the JAX package's answer (the JAX package at its own routing
defaults), or sqlite's where the JAX package folds NULL keys into the
group of the value stored under them; the route taken is asserted. The
card's gate for a wide dense GROUP BY (`executor.dense_agg_on_host`) is
checked on both sides of `device_agg_min_rows`, with and without a mesh,
and `tools/route_sweep.py` runs at a tiny size on the CPU. On the CPU the
gate never sends an aggregate to the host, so the device_agg_min_rows
cases call it as a card would (the `as_card` fixture). Answers are
exact: integer keys, sums and counts."""

import sqlite3

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu_torch.config import DBConfig
from adacom_tpu_torch.exec import device_scan
from adacom_tpu_torch.exec import executor as texecutor
from adacom_tpu_torch.parallel.mesh import make_virtual_mesh
from adacom_tpu_torch.tools import route_sweep


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


SEG_ROWS = 2048
N = 20_000  # nine full segments and a ragged tail
T1_SEGMENTS = 20
NEVER = route_sweep.NEVER
DDL = {"g": "CREATE TABLE g(k INTEGER, m INTEGER, kn INTEGER, v INTEGER)",
       "o": "CREATE TABLE o(k INTEGER, w INTEGER)",
       "t1": "CREATE TABLE t1(i UINTEGER)"}
GROUP_BYS = {
    # 35 slots: past the fused tiers' 16 groups
    "d35": "SELECT k, sum(v), count(*), min(v), max(v) FROM g GROUP BY k "
           "ORDER BY k",
    "d1024": "SELECT m, sum(v), count(*) FROM g WHERE v > 100 GROUP BY m "
             "ORDER BY m",
    # 35 slots and a NULL key: held against sqlite
    "d35_nulls": "SELECT kn, count(*), sum(v) FROM g GROUP BY kn "
                 "ORDER BY kn NULLS LAST",
}
JOIN = ("SELECT g.k, g.v, o.w FROM g JOIN o ON g.k = o.k WHERE g.v < 200 "
        "ORDER BY g.v, g.k")


def _range_sql(k):
    """A scan of t1 over k whole segments (of SEG_ROWS rows)."""
    lo = 5 * SEG_ROWS
    return f"SELECT i FROM t1 WHERE i BETWEEN {lo} AND " \
           f"{lo + k * SEG_ROWS - 1} ORDER BY i"


def _data():
    rng = np.random.default_rng(15)
    k = rng.integers(0, 35, N).astype(np.int32)
    g = {"k": k, "m": rng.integers(0, 1024, N).astype(np.int32),
         "kn": k.copy(), "v": rng.integers(0, 10_000, N).astype(np.int32)}
    valid = {"kn": rng.random(N) > 0.1}
    o = {"k": np.arange(35, dtype=np.int32),
         "w": (np.arange(35) * 10).astype(np.int32)}
    t1 = {"i": np.arange(T1_SEGMENTS * SEG_ROWS, dtype=np.uint32)}
    return {"g": (g, valid), "o": (o, None), "t1": (t1, None)}


def _engine(mod, data, **kw):
    cfg = mod.DBConfig()
    cfg.segment_rows = SEG_ROWS
    db = mod.Database(config=cfg, **kw)
    con = db.connect()
    for name, (cols, valid) in data.items():
        con.query(DDL[name])
        app = con.appender(name)
        if valid is None:
            app.append_columns(cols)
        else:
            app.append_columns(cols, valid)
        app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    return db, con


@pytest.fixture(scope="module")
def engines():
    """(JAX connection, port connection, data), the same seeded tables in
    both; the port's knobs are set by each test."""
    data = _data()
    jdb, jcon = _engine(adacom_tpu, data)
    tdb, tcon = _engine(adacom_tpu_torch, data, platform="cpu")
    yield jcon, tcon, data
    tdb.close()
    jdb.close()


@pytest.fixture(scope="module")
def reference(engines):
    """The JAX package's answer to a query, computed once."""
    jcon = engines[0]
    cache = {}

    def answer(sql):
        if sql not in cache:
            cache[sql] = jcon.query(sql).fetchall()
        return cache[sql]
    return answer


def _sqlite_answer(data, sql):
    lite = sqlite3.connect(":memory:")
    try:
        lite.execute(DDL["g"])
        g, valid = data["g"]
        kn = [int(x) if ok else None for x, ok in zip(g["kn"], valid["kn"])]
        lite.executemany("INSERT INTO g VALUES (?, ?, ?, ?)", zip(
            g["k"].tolist(), g["m"].tolist(), kn, g["v"].tolist()))
        return lite.execute(sql).fetchall()
    finally:
        lite.close()


@pytest.fixture
def as_card(monkeypatch):
    """The gate decides as on a CUDA database; counts the generic path's
    aggregates."""
    real_gate, real_generic = texecutor.dense_agg_on_host, \
        texecutor.Executor._aggregate_generic
    calls = {"generic": 0}

    def generic(self, *a, **k):
        calls["generic"] += 1
        return real_generic(self, *a, **k)

    monkeypatch.setattr(texecutor, "dense_agg_on_host",
                        lambda rows, domain, _dev, mesh, cfg:
                        real_gate(rows, domain, "cuda", mesh, cfg))
    monkeypatch.setattr(texecutor.Executor, "_aggregate_generic", generic)
    return calls


def _rows(res):
    return [tuple(None if x is None else int(x) for x in r) for r in res]


@pytest.mark.parametrize("route", ["host", "generic"])
@pytest.mark.parametrize("query", sorted(GROUP_BYS))
def test_device_agg_min_rows_routes_answer_alike(engines, reference,
                                                 as_card, query, route):
    _jcon, tcon, data = engines
    sql = GROUP_BYS[query]
    tcon.query(f"SET device_agg_min_rows = "
               f"{NEVER if route == 'host' else 0}")
    got = _rows(tcon.query(sql).fetchall())
    assert as_card["generic"] == (route == "generic")
    if query == "d35_nulls":
        want = _rows(_sqlite_answer(data, sql))
        assert want[-1][0] is None  # the NULL key is a group of its own
    else:
        want = _rows(reference(sql))
    assert got == want


@pytest.mark.parametrize("setting", [True, False])
@pytest.mark.parametrize("query", ["join", "range"])
def test_host_materialize_routes_answer_alike(engines, reference, query,
                                              setting):
    _jcon, tcon, _data = engines
    sql = JOIN if query == "join" else _range_sql(3)
    route_sweep.set_config(tcon, {"host_materialize": setting,
                                  "host_scan_segment_limit": 0,
                                  "streaming_join_enabled": False})
    try:
        runs = device_scan.RUNS
        got = tcon.query(sql).fetchall()
        # the join's two inputs, or the range scan, on the device scan
        assert device_scan.RUNS - runs == (0 if setting else
                                           2 if query == "join" else 1)
    finally:
        tcon.query("SET streaming_join_enabled = true")
    assert got == reference(sql) and len(got) > 0


@pytest.mark.parametrize("limit", [0, 1_000_000])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_host_scan_segment_limit_routes_answer_alike(engines, reference, k,
                                                     limit):
    _jcon, tcon, _data = engines
    route_sweep.set_config(tcon, {"host_materialize": False,
                                  "host_scan_segment_limit": limit})
    runs = device_scan.RUNS
    got = tcon.query(_range_sql(k)).fetchall()
    assert device_scan.RUNS - runs == (1 if limit == 0 else 0)
    assert len(got) == k * SEG_ROWS
    assert got == reference(_range_sql(k))


@pytest.mark.parametrize("rows_at, mesh, on_host", [
    ("below", False, True), ("at", False, False), ("above", False, False),
    ("below", True, False), ("at", True, False)])
def test_cuda_gate_decides_at_the_threshold(rows_at, mesh, on_host):
    """The card's gate at DBConfig's threshold (524,288 rows) and at 1M
    rows: the host aggregate below it and without a mesh only; a domain
    the fused tiers take and a CPU database never go there."""
    m = make_virtual_mesh(2, "cpu") if mesh else None
    for cfg in (DBConfig(), DBConfig(device_agg_min_rows=1 << 20)):
        t = cfg.device_agg_min_rows
        rows = {"below": t - 1, "at": t, "above": t + 1}[rows_at]
        if rows < 0:
            continue
        assert texecutor.dense_agg_on_host(rows, 1024, "cuda", m, cfg) \
            is on_host
        assert texecutor.dense_agg_on_host(rows, 16, "cuda", m, cfg) \
            is False
        assert texecutor.dense_agg_on_host(rows, 1024, "cpu", m, cfg) \
            is False


@pytest.mark.parametrize("index", ["create", "auto"])
def test_default_routes_an_unprunable_equality_probe_to_an_index(
        index, monkeypatch):
    """An equality probe on an INTEGER column whose zonemaps prune none of
    its 8 segments (more than host_scan_segment_limit) takes, under
    DBConfig's defaults, the host tier and an index: the CREATE INDEX one
    from the first probe, or the auto-index from the
    auto_index_threshold-th; the device scan runs no time. Every answer
    equals the JAX package's (at its own defaults)."""
    from adacom_tpu_torch.storage.index import SortedIndex

    threshold = DBConfig().auto_index_threshold
    rng = np.random.default_rng(17)
    n = 8 * SEG_ROWS
    data = {"k": rng.integers(0, n, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32)}
    keys = rng.integers(n // 4, 3 * n // 4, threshold + 4)
    pairs = []
    for mod, kw in ((adacom_tpu, {}), (adacom_tpu_torch, {"platform": "cpu"})):
        cfg = mod.DBConfig()
        cfg.segment_rows = SEG_ROWS
        db = mod.Database(config=cfg, **kw)
        con = db.connect()
        con.query("CREATE TABLE t(k INTEGER, v INTEGER)")
        app = con.appender("t")
        app.append_columns(data)
        app.close()
        if index == "create":
            con.query("CREATE INDEX t_k ON t(k)")
        db.catalog.get_column_segment_catalog().compact_all_segments()
        pairs.append((db, con))
    (jdb, jcon), (tdb, tcon) = pairs
    lookups = []
    real = SortedIndex.lookup_eq
    monkeypatch.setattr(SortedIndex, "lookup_eq", lambda self, *a, **k: (
        lookups.append(1), real(self, *a, **k))[1])
    try:
        assert len(tdb.catalog.get_table("t").columns["k"].segments) == 8
        runs = device_scan.RUNS
        for key in keys:
            sql = f"SELECT k, v FROM t WHERE k = {int(key)}"
            assert sorted(tcon.query(sql).fetchall()) == \
                sorted(jcon.query(sql).fetchall())
        assert device_scan.RUNS == runs
        if index == "create":
            assert len(lookups) == len(keys)
        else:
            assert tdb.dist_stats.get("auto_index_built") == 1
            assert len(lookups) == len(keys) - threshold + 1
    finally:
        tdb.close()
        jdb.close()


def test_route_sweep_on_the_cpu_routes_agree():
    """The sweep at a tiny size: every route's answer equals numpy's (it
    raises otherwise), each forced route is the one taken, and derive()
    gives one value per knob swept."""
    res = route_sweep.run(["agg", "segments"], platform="cpu",
                          rows=(4096, 9000), domains=(64, 1024),
                          queries=("all", "half"), ks=(1, 2), hot=1,
                          seg_hot=1, t1_rows=3 * 65536,
                          headline_scale=0.0002, log=None)
    assert len(res["agg"]) == 8 and len(res["segments"]) == 2
    for p in res["segments"]:
        assert p["routes"]["host"]["route"] == "host_tier"
        assert p["routes"]["device"]["route"] == "device_scan"
    for p in res["agg"]:  # on the CPU both routes take the generic path
        assert p["routes"]["generic"]["route"] == "generic_device_path"
    assert set(res["segment_headline"]) == {"limit 4", "limit 1", "limit 2"}
    assert set(res["derived"]) == {"device_agg_min_rows",
                                   "host_scan_segment_limit"}
