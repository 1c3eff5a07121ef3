"""The program's spans as the benchmark reads them (benchmark/program_spans.py):
matching profiles to completed queries, each new per-layer metric's read
on a synthetic ctx, idle-gap labels and kernel attribution from program
spans, and, on a card, launch records in a CUDA-only trace."""

import threading
import time

import pytest

from benchmark import harness, program_spans, registry, trace

MS = 1_000_000


def span(sid, name, parent, t0, t1, cpu=None, thread=7, **counts):
    cpu = t1 - t0 if cpu is None else cpu
    return {"name": name, "id": sid, "parent": parent, "query_id": "x", "thread": thread,
            "start_ns": t0, "end_ns": t1, "cpu_start_ns": 0, "cpu_end_ns": cpu,
            "counts": counts}


def profile(token, n, t0, thread=7, pull_ms=5, walk_ms=3, hit=1):
    """A revenue-shaped SELECT's profile starting at t0 (ns): 100 ms of
    execute, 40 of them on the CPU; a pull of pull_ms, all waiting."""
    ex0 = t0 + 1 * MS
    spans = [
        span(0, "query", None, t0, t0 + 102 * MS, thread=thread),
        span(1, "plan", 0, t0, ex0, thread=thread),
        span(2, "execute", 0, ex0, ex0 + 100 * MS, cpu=40 * MS, thread=thread),
        span(3, "op.Aggregate", 2, ex0, ex0 + 100 * MS, thread=thread, rows=10),
        span(4, "scan.pools", 3, ex0, ex0 + walk_ms * MS, thread=thread,
             segments=10, segments_kept=8),
        span(5, "scan.snapshot", 4, ex0, ex0 + 1 * MS, thread=thread),
        span(6, "scan.stack", 3, ex0 + walk_ms * MS, ex0 + (walk_ms + 1) * MS,
             thread=thread, hit=hit),
        span(7, "agg.partials", 3, ex0 + 10 * MS, ex0 + 20 * MS, thread=thread),
        span(8, "agg.pull", 3, ex0 + 20 * MS, ex0 + (20 + pull_ms) * MS, cpu=0,
             thread=thread),
    ]
    for sp in spans:
        sp["query_id"] = f"{token}.{n}"
    return {"statement": "SelectStmt", "query_id": f"{token}.{n}", "spans": spans}


def query(client, t0_ns, t1_ns):
    q = harness.Query(client, None, {}, (t0_ns - MS) / 1e9)
    q.t_query = (t1_ns + MS) / 1e9
    q.t1 = q.t_query
    return q


@pytest.fixture
def two_clients(monkeypatch):
    """Two clients, two queries each, with the program's profiles; a
    profile of a query that did not complete, and a DDL statement's."""
    base = 10**12
    profs = [profile(11, 1, base), profile(11, 2, base + 200 * MS, hit=0),
             profile(12, 1, base + 50 * MS, pull_ms=15, walk_ms=5),
             profile(12, 2, base + 250 * MS, pull_ms=15, walk_ms=5),
             profile(12, 3, base + 450 * MS)]
    profs.append({"statement": "CreateTableStmt", "query_id": "11.0",
                  "spans": [span(0, "query", None, base - 5 * MS, base - 4 * MS)]})
    done = [query(0, base, base + 102 * MS), query(0, base + 200 * MS, base + 302 * MS),
            query(1, base + 50 * MS, base + 152 * MS),
            query(1, base + 250 * MS, base + 352 * MS)]
    monkeypatch.setattr(program_spans, "program_profiles", lambda: profs)
    return {"done": done}


def test_statements_match_each_completed_query(two_clients):
    found = program_spans.statements(two_clients["done"])
    assert sorted(p["query_id"] for p in found) == ["11.1", "11.2", "12.1", "12.2"]


@pytest.mark.parametrize("name, want", [
    ("walk_ms", (3 + 1 + 3 + 1 + 5 + 1 + 5 + 1) / 4),  # scan.pools holds the snapshot
    ("host_wait_ms", 60 - (5 + 5 + 15 + 15) / 4),
    ("pull_wait_ms", (5 + 5 + 15 + 15) / 4),
    ("zonemap_kept_pct", 80.0),
    ("pool_cache_hit_pct", 75.0),
])
def test_new_metric_reads_a_synthetic_ctx(spec, two_clients, name, want):
    assert name in {m["name"] for m in spec["per_layer"]}
    got = registry.load_module("metrics", name).read(two_clients)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["walk_ms", "host_wait_ms", "pull_wait_ms",
                                  "zonemap_kept_pct", "pool_cache_hit_pct"])
def test_new_metric_reads_nothing_without_program_spans(monkeypatch, name):
    """An older program keeps no profiles: the metric is left out, and a
    query without a profile is never counted as 0."""
    monkeypatch.setattr(program_spans, "program_profiles", lambda: [])
    done = [query(0, 10**12, 10**12 + 5 * MS)]
    assert registry.load_module("metrics", name).read({"done": done}) is None


def test_program_profiles_of_the_port_are_its_recent_statements():
    from adacom_tpu_torch.utils import trace as program_trace

    assert program_spans.program_profiles() == program_trace.recent()


def test_idle_gaps_are_labelled_by_program_spans():
    spans = program_spans.ProgramSpans(2)
    spans.add(0, "query revenue", 0.0, 1.0)
    spans.add(1, "query revenue", 0.0, 1.0)
    me = threading.get_native_id()
    spans.threads = [(1, me), (2, me + 1)]
    profs = [{"statement": "SelectStmt", "query_id": "1.1", "spans": [
        span(0, "query", None, 0, 1000 * MS, thread=me),
        span(1, "scan.pools", 0, 100 * MS, 400 * MS, thread=me),
        span(2, "agg.pull", 0, 600 * MS, 900 * MS, thread=me)]},
        {"statement": "SelectStmt", "query_id": "2.1", "spans": [
            span(0, "agg.finish", None, 0, 1000 * MS, thread=me + 1)]}]
    spans.freeze(profs)
    events = [("k", 0.0, 0.1), ("k", 0.4, 0.6), ("k", 0.9, 1.0)]
    s = trace.reduce_events(events, 0.0, 1.0, spans)
    assert sorted(label for label, _length in s["idle_gaps"]) == \
        ["agg.finish+agg.pull", "agg.finish+scan.pools"]


def test_kernels_are_attributed_by_correlation_id_and_thread():
    spans = program_spans.ProgramSpans(2)
    me = threading.get_native_id()
    ident_a, ident_b = (1 << 40) + 5, (1 << 41) + 6
    spans.threads = [(ident_a, me), (ident_b, me + 1)]
    profs = [{"statement": "SelectStmt", "query_id": "1.1", "spans": [
        span(0, "query", None, 0, 1000 * MS, thread=me),
        span(1, "scan.decode", 0, 100 * MS, 200 * MS, thread=me),
        span(2, "agg.partials", 0, 300 * MS, 500 * MS, thread=me)]},
        {"statement": "SelectStmt", "query_id": "2.1", "spans": [
            span(0, "agg.pull", None, 0, 1000 * MS, thread=me + 1)]}]
    cupti = program_spans._cupti_thread
    kernels = [("decode", 0.20, 0.25, 1), ("scatter", 0.50, 0.80, 2),
               ("scatter", 0.80, 0.90, 3), ("other", 0.90, 0.95, 4),
               ("early", -1.0, -0.5, 5)]
    launches = {1: (0.15, cupti(ident_a), 1e-5), 2: (0.35, cupti(ident_a), 0.02),
                3: (0.40, cupti(ident_b), 1e-5), 5: (0.35, cupti(ident_a), 1e-5)}
    got = program_spans.attribute(kernels, launches, spans, profs, 0.0, 1.0)
    assert {k: v["device_s"] for k, v in got.items()} == pytest.approx(
        {"scan.decode": 0.05, "agg.partials": 0.30, "agg.pull": 0.10,
         "(no launch record)": 0.05})
    assert {k: v["kernels"] for k, v in got.items()} == \
        {"scan.decode": 1, "agg.partials": 1, "agg.pull": 1, "(no launch record)": 1}
    assert got["agg.partials"]["launch_s"] == pytest.approx(0.02)
    assert cupti(139683999810304) == -1221557504  # as a card's trace gave it


def test_traced_rehearsal_reads_the_program_metrics(spec):
    """The revenue cell on a tiny CPU database, traced: the program's
    spans are found for its queries and every new metric is read."""
    from test_mix_rehearsal import run

    r = run(spec, "lineitem_sf10.revenue", traced=True)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert got["zonemap_kept_pct"] == 100.0 and got["pool_cache_hit_pct"] == 100.0
    for name in ("walk_ms", "host_wait_ms", "pull_wait_ms"):
        assert 0 <= got[name] < got["execute_ms"], name


@pytest.mark.card
def test_launch_records_name_the_span_of_the_launch(card):
    """On a card: the CUDA-only trace holds launch records, whose thread
    id maps to the launching thread, and the warmed marker's launch lies
    within 50 us of the host mark."""
    import torch

    spans = program_spans.ProgramSpans(1)
    dt = program_spans.LaunchTrace(card)
    dt.start()
    t0 = dt.mark()
    x = torch.ones(1 << 22, device=card)
    spans.add(0, "query", t0, t0)
    a = time.perf_counter_ns()
    for _ in range(20):
        x = x * 1.0001
    b = time.perf_counter_ns()
    torch.cuda.synchronize(card)
    t1 = time.perf_counter()
    dt.stop()
    profs = [{"statement": "SelectStmt", "query_id": "1.1",
              "spans": [span(0, "agg.partials", None, a, b, thread=threading.get_native_id())]}]
    got = program_spans.attribute(dt.kernels, dt.launches, spans, profs, t0, t1)
    assert len(dt.launches) >= 20, len(dt.launches)
    assert got.get("agg.partials", {}).get("kernels") == 20, got
    # the harness's mark: the marker's host dispatch lies between the mark
    # and its launch record (89 us in a traced run of the revenue cell on
    # an H100); its compile, which warming saves, is 8-490 ms
    assert 0 <= dt.alignment["marker_launch_after_mark_us"] < 1000, dt.alignment
