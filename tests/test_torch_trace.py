"""The port's statement spans and counters (adacom_tpu_torch/utils/trace.py)
under PRAGMA enable_profiling: the recorder's nesting, ids, threads and
clocks; that a statement run with profiling off reads no clock and makes
no span; the spans and counts of a revenue-shaped GROUP BY on the generic
path, of the fused tiers and of the host route; the pool cache's miss
turning into a hit; lock waits; last_profile's phases and rendered
operators as before."""

import re
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest

import adacom_tpu_torch
from adacom_tpu_torch.utils import trace as qtrace

SEG_ROWS = 4096
N = SEG_ROWS * 12  # twelve full segments: one pool on the generic path
REVENUE = ("SELECT k, sum(p * (1 - d)) AS r FROM l WHERE s >= '1994-01-01' "
           "AND s < '1994-04-01' GROUP BY k ORDER BY r DESC, k LIMIT 10")
OPERATORS = re.compile(r"\[rows=\d+ time=\d+\.\d{3}ms self=-?\d+\.\d{3}ms\]")


@pytest.fixture
def con():
    cfg = adacom_tpu_torch.DBConfig()
    cfg.segment_rows = SEG_ROWS
    db = adacom_tpu_torch.Database(config=cfg, platform="cpu")
    c = db.connect()
    c.query("CREATE TABLE l(k BIGINT, p DECIMAL(12,2), d DECIMAL(12,2), s DATE, "
            "i INTEGER, g INTEGER, name VARCHAR)")
    rng = np.random.default_rng(7)
    app = c.appender("l")
    app.append_columns({
        "k": rng.integers(1, 3000, N), "p": rng.integers(100, 10_000, N) / 100,
        "d": rng.integers(0, 10, N) / 100,
        "s": (np.datetime64("1993-01-01") + rng.integers(0, 2000, N)).astype("datetime64[D]"),
        "i": rng.integers(0, 1000, N).astype(np.int32),
        "g": rng.integers(0, 5, N).astype(np.int32),
        "name": np.array(["a", "b", "c"])[rng.integers(0, 3, N)]})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    yield c
    db.close()


def _names(profile):
    return [sp["name"] for sp in profile["spans"]]


def _one(profile, name):
    found = [sp for sp in profile["spans"] if sp["name"] == name]
    assert len(found) == 1, (name, _names(profile))
    return found[0]


def test_recorder_nests_spans_under_one_query_id():
    tr = qtrace.StatementTrace("3.9")
    a = tr.begin("query")
    b = tr.begin("plan")
    tr.end(b, plan_cache_hit=1)
    c = tr.begin("execute")
    d = tr.begin("op.Aggregate", node=1234)
    tr.set(route="generic")
    busy = time.perf_counter() + 0.01
    while time.perf_counter() < busy:
        pass
    time.sleep(0.01)
    tr.end(d, rows=5)
    tr.end(c)
    tr.end(a)
    assert [(sp["id"], sp["parent"]) for sp in tr.spans] == \
        [(0, None), (1, 0), (2, 0), (3, 2)]
    assert {sp["query_id"] for sp in tr.spans} == {"3.9"}
    assert {sp["thread"] for sp in tr.spans} == {threading.get_native_id()}
    assert d["node"] == 1234 and d["counts"] == {"route": "generic", "rows": 5}
    assert b["counts"] == {"plan_cache_hit": 1}
    for sp in tr.spans:
        wall = sp["end_ns"] - sp["start_ns"]
        cpu = sp["cpu_end_ns"] - sp["cpu_start_ns"]
        assert 0 <= cpu <= wall
    # the sleep is off the CPU, the loop on it
    assert d["end_ns"] - d["start_ns"] - (d["cpu_end_ns"] - d["cpu_start_ns"]) >= 5_000_000
    assert qtrace.operator_profile(tr.spans) == {1234: (qtrace.seconds(d), 5)}


def test_recorder_closes_spans_an_exception_left_open():
    tr = qtrace.StatementTrace("1.1")
    a = tr.begin("op.Get")
    b = tr.begin("scan.host")
    tr.end(a)
    assert b["end_ns"] == a["end_ns"] and b["cpu_end_ns"] == a["cpu_end_ns"]
    c = tr.begin("op.Filter")
    assert c["parent"] is None
    tr.end(b, segments=3)  # already closed: only its counts change
    assert b["end_ns"] == a["end_ns"] and b["counts"] == {"segments": 3}


def test_recorder_ignores_other_threads():
    tr = qtrace.StatementTrace("1.1")
    got = []
    t = threading.Thread(target=lambda: got.append(tr.begin("scan.host")))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and got == [None] and tr.spans == []


def test_profiling_off_reads_no_clock_and_makes_no_span(con, monkeypatch):
    want = con.query(REVENUE).fetchall()

    def no_clock():
        raise RuntimeError("a clock was read")

    def no_trace(*_a, **_k):
        raise RuntimeError("a trace was made")

    monkeypatch.setattr(qtrace, "clock", no_clock)
    monkeypatch.setattr(qtrace, "cpu_clock", no_clock)
    monkeypatch.setattr(qtrace.StatementTrace, "__init__", no_trace)
    tracemalloc.start()
    try:
        for sql in (REVENUE, "SELECT sum(i) FROM l", "SELECT g, sum(i) FROM l GROUP BY g",
                    "SELECT name, count(*) FROM l GROUP BY name", "EXPLAIN " + REVENUE):
            con.query(sql).fetchall()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert con.query(REVENUE).fetchall() == want
    assert con.last_profile is None and con.executor.trace is None
    assert not snap.filter_traces([tracemalloc.Filter(True, qtrace.__file__)]).traces
    # the patches bite once profiling is on
    con.query("PRAGMA enable_profiling")
    with pytest.raises(RuntimeError, match="a trace was made"):
        con.query(REVENUE)


def test_revenue_group_by_spans_and_counters(con):
    con.query("PRAGMA enable_profiling")
    want = con.query(REVENUE).fetchall()
    first = con.last_profile
    assert con.query(REVENUE).fetchall() == want
    second = con.last_profile
    for p in (first, second):
        names = set(_names(p))
        assert names >= {"query", "plan", "execute", "op.TopN", "op.Aggregate",
                         "scan.snapshot", "scan.pools", "scan.stack", "scan.decode",
                         "scan.filter", "agg.partials", "agg.pull", "agg.finish"}, names
        ids = {sp["id"]: sp for sp in p["spans"]}
        assert p["spans"][0]["name"] == "query" and p["spans"][0]["parent"] is None
        assert ids[_one(p, "scan.snapshot")["parent"]]["name"] == "scan.pools"
        agg = _one(p, "op.Aggregate")
        for name in ("scan.pools", "scan.stack", "scan.decode", "agg.partials",
                     "agg.pull", "agg.finish"):
            assert all(sp["parent"] == agg["id"] for sp in p["spans"] if sp["name"] == name)
        assert agg["counts"]["route"] == "generic" and agg["counts"]["launches"] == 0
        pools = _one(p, "scan.pools")["counts"]
        assert pools == {"segments": 12, "segments_kept": 12, "pools": 1, "chunks": 1}
        assert _one(p, "agg.pull")["counts"]["bytes_pulled"] > 0
        assert _one(p, "agg.finish")["counts"]["groups"] == agg["counts"]["rows"]
        assert _one(p, "op.TopN")["counts"]["rows"] == 10
        assert p["counters"]["lock_wait_ns"] >= 0
        assert len({sp["query_id"] for sp in p["spans"]}) == 1
        assert p["phases"] == {"plan_s": qtrace.seconds(_one(p, "plan")),
                               "execute_s": qtrace.seconds(_one(p, "execute"))}
        assert p["total_s"] == qtrace.seconds(p["spans"][0])
        assert OPERATORS.search(p["operators"]) and "Aggregate" in p["operators"]
    assert first["query_id"] != second["query_id"]
    assert first["query_id"].split(".")[0] == second["query_id"].split(".")[0]
    # the stack of the first run is the pool cache's hit in the second
    assert _one(first, "scan.stack")["counts"]["hit"] == 0
    assert _one(first, "scan.stack")["counts"]["bytes_stacked"] > 0
    assert _one(second, "scan.stack")["counts"] == {"hit": 1, "bytes_stacked": 0}
    assert _one(first, "plan")["counts"]["plan_cache_hit"] == 0
    assert _one(second, "plan")["counts"]["plan_cache_hit"] == 1
    assert qtrace.recent()[-1] is second


@pytest.mark.parametrize("sql, route, tier", [
    ("SELECT sum(i), count(*) FROM l WHERE i < 500", "b1", "b1"),
    ("SELECT g, sum(i) FROM l GROUP BY g ORDER BY g", "b2", "b2"),
    ("SELECT sum(i * g) FROM l", "b3", "b3"),
    ("SELECT g, count(DISTINCT i) FROM l GROUP BY g ORDER BY g", "host", None),
])
def test_routes_on_the_aggregate_span(con, sql, route, tier):
    want = con.query(sql).fetchall()
    con.query("PRAGMA enable_profiling")
    assert con.query(sql).fetchall() == want
    p = con.last_profile
    agg = _one(p, "op.Aggregate")
    assert agg["counts"]["route"] == route
    if tier is None:
        assert "agg.fused" not in _names(p) and agg["counts"]["launches"] == 0
        assert "scan.host" in _names(p)
    else:
        fused = _one(p, "agg.fused")
        assert fused["counts"]["tier"] == tier
        assert fused["counts"]["launches"] == agg["counts"]["launches"] >= 1
        assert fused["parent"] == agg["id"]
        assert [sp["counts"]["hit"] for sp in p["spans"] if sp["name"] == "scan.stack"]
        assert all(sp["parent"] == fused["id"] for sp in p["spans"]
                   if sp["name"] == "scan.stack")


def test_explain_analyze_renders_from_operator_spans(con):
    for profiling in (False, True):
        if profiling:
            con.query("PRAGMA enable_profiling")
        text = con.query("EXPLAIN ANALYZE " + REVENUE).fetchall()[0][0]
        lines = text.splitlines()
        assert lines[0].startswith("TopN") and OPERATORS.search(lines[0])
        assert "rows=10 " in lines[0] and lines[-1].startswith("Total Time: ")
        assert con.executor.trace is None
    assert con.last_profile["statement"] == "ExplainStmt"
    assert "op.Aggregate" in _names(con.last_profile)


@pytest.mark.parametrize("sql, where", [
    ("SELECT sum(p * (1 - d)) FROM l WHERE s >= '1994-01-01'", "scan.snapshot"),
    (REVENUE, "op.Aggregate"),  # the dense domain's flush takes the lock first
])
def test_append_lock_wait_is_timed(con, sql, where):
    """A reader waits on the table's append lock while another thread
    holds it (as a checkpoint does throughout): the span that waited and
    the statement's counters carry the wait."""
    con.query("PRAGMA enable_profiling")
    con.query(sql).fetchall()
    table = con.db.catalog.get_table("l")
    held = threading.Event()

    def hold():
        with table._append_lock:
            held.set()
            time.sleep(0.2)

    t = threading.Thread(target=hold)
    t.start()
    assert held.wait(10)
    con.query(sql).fetchall()
    t.join(timeout=10)
    assert not t.is_alive()
    p = con.last_profile
    waited = _one(p, where)["counts"]["lock_wait_ns"]
    assert waited >= 100_000_000
    assert p["counters"]["lock_wait_ns"] >= waited


def test_execute_of_a_prepared_statement_nests_its_query(con):
    con.query("PRAGMA enable_profiling")
    con.query("PREPARE p AS SELECT count(*) FROM l WHERE i < ?")
    assert con.query("EXECUTE p(500)").fetchall() == \
        con.query("SELECT count(*) FROM l WHERE i < 500").fetchall()
    con.query("EXECUTE p(500)")
    p = con.last_profile
    assert p["statement"] == "ExecuteStmt" and "phases" not in p
    roots = [sp for sp in p["spans"] if sp["name"] == "query"]
    assert len(roots) == 2 and roots[1]["parent"] == roots[0]["id"]
    assert con.executor.trace is None


def test_concurrent_connections_keep_their_own_spans(con):
    """Four connections on threads, each a stream of profiled queries with
    a short switch interval: every profile holds only its own statement's
    spans, on its own thread, and every statement's profile is kept."""
    con.query("PRAGMA enable_profiling")
    cons = [con.db.connect() for _ in range(4)]
    out = [[] for _ in cons]
    before = len(qtrace.recent())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(i):
        for _ in range(6):
            cons[i].query("SELECT g, count(*) FROM l WHERE i < 700 GROUP BY g").fetchall()
            out[i].append((cons[i].last_profile, threading.get_native_id()))

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    seen = set()
    for per in out:
        assert len(per) == 6
        for prof, tid in per:
            assert {sp["thread"] for sp in prof["spans"]} == {tid}
            assert {sp["query_id"] for sp in prof["spans"]} == {prof["query_id"]}
            assert all(sp["end_ns"] is not None for sp in prof["spans"])
            seen.add(prof["query_id"])
    assert len(seen) == 24
    assert len(qtrace.recent()) - before == 24 or len(qtrace.recent()) == qtrace.RECENT_LIMIT


def test_dist_stats_hold_no_dead_counter(con):
    assert "topk" not in con.db.dist_stats
