"""The cell tpch_sf10.q15 at a tiny size on the CPU: TPC-H Q15 from the
plain reference against sqlite3 on several quarters and on a forced tie;
the float32 control fails the cell's limits; a rehearsal of the q15 mix
through the harness, untraced and traced; the readers of subquery_ms and
join_ms on a synthetic profile, and on a program that records no such
span."""

import sqlite3
import time
from fractions import Fraction

import numpy as np
import pytest

from benchmark import control, harness, program_spans, registry, traffic
from conftest import small_desc

CELL = "tpch_sf10.q15"
CONFIG = "tpch_sf10_q15"
MS = 1_000_000
Q15 = """
WITH revenue AS (SELECT supp AS supplier_no, sum(p * (100 - d)) AS total_revenue
                 FROM lineitem WHERE ship >= ? AND ship < ? GROUP BY supp)
SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier, revenue
WHERE s_suppkey = supplier_no
  AND total_revenue = (SELECT max(total_revenue) FROM revenue)
ORDER BY s_suppkey"""


def _sqlite(data):
    """The generated tables in sqlite3, decimals as scaled integers so that
    its sums are exact."""
    lite = sqlite3.connect(":memory:")
    li, su = data["lineitem"], data["supplier"]
    lite.execute("CREATE TABLE lineitem(p INTEGER, d INTEGER, ship TEXT, supp INTEGER)")
    ship = np.datetime_as_string(np.asarray(li["l_shipdate"]).astype("datetime64[D]"))
    lite.executemany("INSERT INTO lineitem VALUES (?,?,?,?)", zip(
        np.asarray(li["l_extendedprice"]).tolist(), np.asarray(li["l_discount"]).tolist(),
        ship.tolist(), np.asarray(li["l_suppkey"]).tolist()))
    lite.execute("CREATE TABLE supplier(s_suppkey INTEGER, s_name TEXT, s_address TEXT, "
                 "s_phone TEXT)")
    lite.executemany("INSERT INTO supplier VALUES (?,?,?,?)", zip(
        np.asarray(su["s_suppkey"]).tolist(), list(su["s_name"]), list(su["s_address"]),
        list(su["s_phone"])))
    return lite


def _want(lite, p):
    return [(k, n, a, ph, Fraction(r, 10**4))
            for k, n, a, ph, r in lite.execute(Q15, (p["date"], p["date_end"]))]


def _params(n=10, seed=4):
    tpl = traffic.Mix(registry.load_json("traffic", "q15"), {}).templates["q15"]
    drawn = tpl.draw(traffic.rng_for(seed, 4), n)
    return [tpl.params_at(drawn, k) for k in range(n)]


@pytest.fixture(scope="module")
def tables(spec):
    desc = small_desc(spec, CONFIG)
    return registry.load_module("configs", CONFIG).generate(desc, 2**31 + 17)


def test_generator_is_the_revenue_cells(spec, tables):
    other = registry.load_module("configs", "tpch_lineitem_sf10").generate(
        small_desc(spec, "tpch_lineitem_sf10"), 2**31 + 17)
    for col in registry.config_desc(spec, CONFIG)["tables"]["lineitem"]:
        assert np.array_equal(tables["lineitem"][col], other["lineitem"][col])


def test_q15_against_sqlite(tables):
    lite = _sqlite(tables)
    ref = registry.load_module("reference", CONFIG).Reference(tables)
    params = _params() + [{"date": "1992-01-01", "date_end": "1992-04-01"}]
    for p in params:
        want = _want(lite, p)
        assert len(want) >= 1
        assert ref.answer("tpch_q15", p) == want


def test_q15_a_tie_returns_every_top_supplier(tables):
    """The quarter's top supplier's rows copied to the next supplier key:
    two suppliers share the largest revenue and both are answered."""
    li = {c: np.asarray(v) for c, v in tables["lineitem"].items()}
    data = {"lineitem": li, "supplier": tables["supplier"]}
    p = _params(1)[0]
    top = registry.load_module("reference", CONFIG).Reference(data).tpch_q15(p)[0][0]
    twin = top % len(tables["supplier"]["s_suppkey"]) + 1
    lo, hi = (np.datetime64(p[k], "D").astype(np.int64) for k in ("date", "date_end"))
    keep = li["l_suppkey"] != twin
    copy = (li["l_suppkey"] == top) & (li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
    tied = {c: np.concatenate([v[keep], v[copy]]) for c, v in li.items()}
    tied["l_suppkey"][keep.sum():] = twin
    data = {"lineitem": tied, "supplier": tables["supplier"]}
    got = registry.load_module("reference", CONFIG).Reference(data).tpch_q15(p)
    assert [r[0] for r in got] == sorted([top, twin])
    assert got[0][-1] == got[1][-1]
    assert got == _want(_sqlite(data), p)


def test_float32_control_fails_the_limits(spec):
    cell = registry.cell(spec, CELL)
    out = control.readings(spec, cell, 2**31 + 5, 20, desc=small_desc(spec, CONFIG))
    assert out["answers"] > 0 and not out["correct"], out


def _run(spec, traced):
    cell = registry.cell(spec, CELL)
    return harness.run_cell(spec, cell, 2**33 + 7, 1.0, traced, "cpu", time.perf_counter(),
                            desc=small_desc(spec, CONFIG))


def test_rehearsal(spec):
    r = _run(spec, False)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    # the end-to-end metrics without a list of cells, less the device's
    assert set(r["metrics"]) == {"queries_per_s", "setup_s"}


def test_traced_rehearsal_reads_subquery_and_join(spec):
    r = _run(spec, True)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"subquery_ms", "join_ms"}
    assert r["metrics"]["subquery_ms"]["value"] > r["metrics"]["join_ms"]["value"] > 0


def _span(sid, name, parent, t0, t1, **counts):
    return {"name": name, "id": sid, "parent": parent, "query_id": "x", "thread": 7,
            "start_ns": t0, "end_ns": t1, "cpu_start_ns": 0, "cpu_end_ns": t1 - t0,
            "counts": counts}


def _profile(token, t0, sub_ms, build_ms, probe_ms):
    """A Q15-shaped SELECT: a subquery (with a nested one inside it, which
    counts once), then a join's build and probe."""
    ex0 = t0 + MS
    spans = [_span(0, "query", None, t0, t0 + 100 * MS),
             _span(1, "execute", 0, ex0, ex0 + 90 * MS),
             _span(2, "subquery", 1, ex0, ex0 + sub_ms * MS, kind="scalar", rows=1),
             _span(3, "subquery", 2, ex0, ex0 + MS, kind="scalar", rows=1),
             _span(4, "op.Join", 1, ex0 + 50 * MS, ex0 + 80 * MS, rows=100),
             _span(5, "join.build", 4, ex0 + 60 * MS, ex0 + (60 + build_ms) * MS,
                   route="hash", build_rows=100),
             _span(6, "join.probe", 4, ex0 + 70 * MS, ex0 + (70 + probe_ms) * MS,
                   route="hash", probe_rows=100, matched=100)]
    for sp in spans:
        sp["query_id"] = f"{token}.1"
    return {"statement": "SelectStmt", "query_id": f"{token}.1", "spans": spans}


def _query(client, t0):
    q = harness.Query(client, None, {}, (t0 - MS) / 1e9)
    q.t_query = q.t1 = (t0 + 101 * MS) / 1e9
    return q


@pytest.mark.parametrize("name, want", [("subquery_ms", (40 + 20) / 2),
                                        ("join_ms", (2 + 3 + 4 + 6) / 2)])
def test_readers_on_a_synthetic_profile(monkeypatch, name, want):
    base = 10**12
    profs = [_profile(11, base, 40, 2, 3), _profile(12, base + 10 * MS, 20, 4, 6)]
    monkeypatch.setattr(program_spans, "program_profiles", lambda: profs)
    ctx = {"done": [_query(0, base), _query(1, base + 10 * MS)]}
    got = registry.load_module("metrics", name).read(ctx)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["subquery_ms", "join_ms"])
def test_readers_read_nothing_without_the_spans(monkeypatch, name):
    """A program older than these spans records profiles without them: the
    metric is left out of the line, not read as 0."""
    base = 10**12
    prof = _profile(11, base, 40, 2, 3)
    prof["spans"] = prof["spans"][:2]
    monkeypatch.setattr(program_spans, "program_profiles", lambda: [prof])
    assert registry.load_module("metrics", name).read({"done": [_query(0, base)]}) is None
