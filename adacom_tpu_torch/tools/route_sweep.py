"""Sweep the executor's three cost-routing knobs: force each route through
SET, hold every answer against numpy or sqlite and the routes against each
other, and print the hot median of each route at each point.

    python3 -m adacom_tpu_torch.tools.route_sweep [SECTION ...] \\
        [--config NAME:KNOB=VALUE,... ...] [--platform cuda|cpu] \\
        [--rows N,...] [--domains D,...] [--sf SF,...] [--probe-rows N] \\
        [--probe-keys K] [--ks K,...] [--tpch-sf SF] [--cb-scale SCALE] \\
        [--shards S] [--hot N] [--seg-hot N] [--t1-rows N] \\
        [--headline-scale S] [--out PATH]

Sections (default: agg q15 probes materialize segments, what derive()
reads):
- agg (`device_agg_min_rows`): per row count N a table t(g<D> INTEGER for
  each domain D, v INTEGER), compacted (the default codec), each key
  uniform over its dense domain, v uniform over [0, 100,000) (seed 15);
  `SELECT g<D>, sum(v), count(*) FROM t [WHERE v < 50000] GROUP BY g<D>`
  on the host aggregate over a host scan (`device_agg_min_rows` 2^62,
  `host_materialize` true) and the generic device path (0). Once the
  generic route has won for a (D, query) at some N, the host route is
  skipped for it at larger N (said so).
- q15: TPC-H Q15's revenue aggregate (`l_suppkey` over the four lineitem
  columns it reads) at each --sf, on the same two routes.
- probes: equality probes `SELECT * FROM p WHERE c = key` over
  p(ix INTEGER, ak INTEGER, v INTEGER), --probe-rows rows, ix and ak
  uniform over [0, rows) so that no zonemap prunes a segment; ix has a
  CREATE INDEX, ak earns the auto-index (its first auto_index_threshold
  probes under each config are that config's cold runs); then --probe-keys
  keys in turns under each config.
- materialize: TPC-H at --tpch-sf (22 queries) and ClickBench at
  --cb-scale (43 queries) under each config, each answer against sqlite
  (computed in a subprocess).
- mesh: the 22 TPC-H queries on --shards virtual shards of one device
  under each config, against sqlite.
- segments (`host_scan_segment_limit`): t1, N UINTEGER rows 0..N-1
  (--t1-rows), `host_materialize=false`; `SELECT * FROM t1 WHERE i
  BETWEEN a AND b` spanning k whole segments for each k, on the host tier
  (limit 1,000,000) and the device scan (limit 0); then the headline's
  10,000 Zipf(k=1) lookups over 100M * --headline-scale rows
  (`bench/succinct_benchmarks.py` SuccinctZipfDistribution) under limit 4
  and each k.
- headline: the headline's lookups under each config.

The configs of probes, materialize, mesh and headline are
`host_materialize=true` and `host_materialize=false` unless --config
names others (each knob it leaves out at DBConfig's default), e.g. the
routing before the H100 sweep against today's defaults:
`--config old:device_agg_min_rows=32000000,host_materialize=true --config
new:`. Each point runs one cold run per route, then --hot hot runs
(--seg-hot for segments) in turns (A B, B A, ...). The timings cover
`Connection.query` (the result's numpy columns), the suites' also
`fetchall()`. `derive(result)` applies the rules PERF.md's Findings set
for the routing defaults. A wrong answer raises. Nothing is written unless
--out is given (JSON)."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np

from adacom_tpu_torch.tools import device_name

KNOBS = ("device_agg_min_rows", "host_materialize", "host_scan_segment_limit")
NEVER = 1 << 62  # device_agg_min_rows that keeps every dense GROUP BY on host
# the host route reads the host copies, as the host aggregate's scan does
# under host_materialize
AGG_ROUTES = (("host", {"device_agg_min_rows": NEVER,
                        "host_materialize": True}),
              ("generic", {"device_agg_min_rows": 0}))
SEGMENT_ROUTES = (("host", {"host_materialize": False,
                            "host_scan_segment_limit": 1_000_000}),
                  ("device", {"host_materialize": False,
                              "host_scan_segment_limit": 0}))
MATERIALIZE_CONFIGS = (("host_materialize=true", {"host_materialize": True}),
                       ("host_materialize=false",
                        {"host_materialize": False}))
ROWS = (16_384, 65_536, 262_144, 1_000_000, 4_000_000, 16_000_000,
        64_000_000)
DOMAINS = (64, 1024, 10_000, 100_000, 1_000_000)
KS = (1, 2, 4, 8, 16, 32, 64, 128)
PROBE_ROWS = 16_000_000
PROBE_KEYS = 20
PROBES_PER_RUN = 10_000  # the headline's run of lookups
V_MAX = 100_000
SEED = 15
CHUNK = 8 << 20
AGG_QUERIES = {
    "all": "SELECT g{d}, sum(v), count(*) FROM t GROUP BY g{d}",
    "half": "SELECT g{d}, sum(v), count(*) FROM t WHERE v < 50000 "
            "GROUP BY g{d}",
}
Q15_REVENUE = ("SELECT l_suppkey, sum(l_extendedprice * (1 - l_discount)) "
               "FROM lineitem WHERE l_shipdate >= '1996-01-01' AND "
               "l_shipdate < '1996-04-01' GROUP BY l_suppkey")
Q15_COLUMNS = ("l_suppkey", "l_extendedprice", "l_discount", "l_shipdate")
SECTIONS = ("agg", "q15", "probes", "materialize", "mesh", "segments",
            "headline")
DERIVED = ("agg", "q15", "probes", "materialize", "segments")


def defaults() -> dict:
    """The routing knobs' values in a fresh DBConfig."""
    from adacom_tpu_torch.config import DBConfig

    cfg = DBConfig()
    return {k: getattr(cfg, k) for k in KNOBS}


def parse_config(text: str):
    """(name, knobs) from `NAME:KNOB=VALUE,...`; a knob left out takes
    DBConfig's default."""
    name, _, spec = text.partition(":")
    cfg = defaults()
    for item in filter(None, spec.split(",")):
        k, _, v = item.partition("=")
        if k not in KNOBS:
            raise ValueError(f"{k} is not a routing knob ({KNOBS})")
        cfg[k] = v.lower() == "true" if k == "host_materialize" else int(v)
    return name, cfg


def set_config(con, cfg: dict) -> None:
    """SET each knob of `cfg` on the connection's database."""
    for k, v in cfg.items():
        val = str(v).lower() if isinstance(v, bool) else int(v)
        con.query(f"SET {k} = {val}")


def _runs() -> int:
    from adacom_tpu_torch.exec import device_scan

    return device_scan.RUNS


def _timed(con, sql, fetch=False):
    """(ms, result, device path ran) of one run of sql."""
    runs = _runs()
    t = time.perf_counter()
    res = con.query(sql)
    if fetch:
        res = res.fetchall()
    return (time.perf_counter() - t) * 1e3, res, _runs() > runs


def _turns(routes, hot):
    """The hot runs' order: all routes, then all reversed, and so on."""
    for r in range(hot):
        yield from (routes if r % 2 == 0 else routes[::-1])


def _hot(rec):
    rec["hot_ms"] = statistics.median(rec["runs_ms"]) if rec["runs_ms"] \
        else rec["cold_ms"]


def _measure(con, sql, routes, hot, check, fetch=False):
    """One cold run per route, then `hot` runs of each in turns; `check`
    (route name, result) raises on a wrong answer. Returns {route:
    {"cold_ms", "hot_ms" (median), "runs_ms", "device_path"}}."""
    out = {}
    for name, cfg in routes:
        set_config(con, cfg)
        ms, res, dev = _timed(con, sql, fetch)
        check(name, res)
        out[name] = {"cold_ms": ms, "runs_ms": [], "device_path": dev}
    for name, cfg in _turns(list(routes), hot):
        set_config(con, cfg)
        ms, res, dev = _timed(con, sql, fetch)
        check(name, res)
        out[name]["runs_ms"].append(ms)
        out[name]["device_path"] &= dev
    for rec in out.values():
        _hot(rec)
    return out


def _load(con, table, ddl, cols):
    con.query(ddl)
    n = len(next(iter(cols.values())))
    app = con.appender(table)
    for start in range(0, n, CHUNK):
        app.append_columns({c: a[start:start + CHUNK]
                            for c, a in cols.items()})
    app.close()


def _grouped_check(want, what):
    """A check of (key, sum, count) results against numpy's `want`
    (keys, sums, counts), exact: a DECIMAL sum's raw column holds its
    scaled integers."""
    keys, sums, counts = want

    def check(route, res):
        g = np.asarray(res.column(0), np.int64)
        order = np.argsort(g, kind="stable")
        s = res.column(1)[order]
        if not np.array_equal(g[order], keys):
            raise AssertionError(f"{what} ({route}): {len(g)} groups != "
                                 f"numpy's {len(keys)}")
        if not np.array_equal(np.asarray(s, np.int64), sums):
            raise AssertionError(f"{what} ({route}): sums differ from numpy")
        if counts is not None and not np.array_equal(
                np.asarray(res.column(2), np.int64)[order], counts):
            raise AssertionError(f"{what} ({route}): counts differ from numpy")
    return check


def _bincount_want(keys, weights, keep, domain):
    k = keys[keep]
    counts = np.bincount(k, minlength=domain)
    # float64 sums of integers stay exact below 2^53 (at most 64M * 1e5)
    sums = np.bincount(k, weights=weights[keep], minlength=domain)
    present = np.nonzero(counts)[0]
    return present, sums[present].astype(np.int64), counts[present]


def _route_label(rec):
    return "generic_device_path" if rec["device_path"] else "host_aggregate"


def _scan_label(rec):
    return "device_scan" if rec["device_path"] else "host_tier"


def agg_sweep(platform, rows=ROWS, domains=DOMAINS, queries=("all", "half"),
              hot=3, log=sys.stdout) -> list:
    """The `agg` section: a list of points {"rows", "domain", "query",
    "host_skipped", "routes": _measure's record, each route labelled}."""
    import adacom_tpu_torch as att

    points, won = [], {}
    for n in sorted(rows):
        rng = np.random.default_rng([SEED, n])
        cols = {f"g{d}": rng.integers(0, d, n, dtype=np.int32)
                for d in domains}
        cols["v"] = rng.integers(0, V_MAX, n, dtype=np.int32)
        db = att.Database(platform=platform)
        try:
            con = db.connect()
            t0 = time.perf_counter()
            _load(con, "t", "CREATE TABLE t(" + ", ".join(
                f"g{d} INTEGER" for d in domains) + ", v INTEGER)", cols)
            db.catalog.get_column_segment_catalog().compact_all_segments()
            print(f"[route agg] t: {n} rows, {len(domains)} key columns, "
                  f"loaded and compacted in {time.perf_counter() - t0:.2f} s",
                  file=log, flush=True)
            for d in domains:
                for q in queries:
                    keep = cols["v"] < V_MAX // 2 if q == "half" else \
                        slice(None)
                    want = _bincount_want(cols[f"g{d}"], cols["v"], keep, d)
                    skipped = won.get((d, q))
                    routes = AGG_ROUTES[1:] if skipped else AGG_ROUTES
                    what = f"GROUP BY over {n} rows, D {d}, {q}"
                    rec = _measure(con, AGG_QUERIES[q].format(d=d), routes,
                                   hot, _grouped_check(want, what))
                    for r in rec.values():
                        r["route"] = _route_label(r)
                    if not skipped and rec["generic"]["hot_ms"] <= \
                            rec["host"]["hot_ms"]:
                        won[(d, q)] = n
                    points.append({"rows": n, "domain": d, "query": q,
                                   "host_skipped": skipped, "routes": rec})
                    print(_point_line("agg", points[-1]), file=log,
                          flush=True)
        finally:
            db.close()
        del cols
    return points


def q15_sweep(platform, sfs=(1.0, 10.0), hot=3, log=sys.stdout) -> list:
    """The `q15` section: a list of points {"sf", "rows", "domain",
    "routes"}."""
    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import tpch

    points = []
    for sf in sfs:
        t0 = time.perf_counter()
        li = tpch.generate_lineitem(sf)
        cols = {c: li[c] for c in Q15_COLUMNS}
        del li
        d0, d1 = (int(np.datetime64(s, "D").astype(np.int64))
                  for s in ("1996-01-01", "1996-04-01"))
        ship = cols["l_shipdate"]
        keep = (ship >= d0) & (ship < d1)
        supp = cols["l_suppkey"]
        domain = int(supp.max()) + 1
        revenue = cols["l_extendedprice"] * (100 - cols["l_discount"])
        keys, sums, _c = _bincount_want(supp, revenue, keep, domain)
        db = att.Database(platform=platform)
        try:
            con = db.connect()
            ddl = tpch.DDL["lineitem"]
            _load(con, "lineitem", "CREATE TABLE lineitem(" + ", ".join(
                part for part in ddl[ddl.index("(") + 1:-1].split(", ")
                if part.split()[0] in Q15_COLUMNS) + ")", cols)
            db.catalog.get_column_segment_catalog().compact_all_segments()
            n = len(supp)
            print(f"[route q15] lineitem SF {sf}: {n} rows, generated, "
                  f"loaded and compacted in {time.perf_counter() - t0:.2f} s",
                  file=log, flush=True)
            rec = _measure(con, Q15_REVENUE, AGG_ROUTES, hot, _grouped_check(
                (keys, sums, None), f"Q15 revenue SF {sf}"))
            for r in rec.values():
                r["route"] = _route_label(r)
            points.append({"sf": sf, "rows": n, "domain": len(keys),
                           "routes": rec})
            print(_point_line("q15", points[-1]), file=log, flush=True)
        finally:
            db.close()
        del cols
    return points


def probe_sweep(platform, configs, n_rows=PROBE_ROWS, n_keys=PROBE_KEYS,
                log=sys.stdout) -> dict:
    """The `probes` section: {"rows", "segments", "ix" / "ak": {"index",
    "routes": {config: {"cold_ms" (its first probe), "earn_ms" (its
    auto_index_threshold cold probes), "runs_ms", "hot_ms" (median),
    "run_s" (PROBES_PER_RUN probes at the median), "device_path",
    "route"}}}}."""
    import adacom_tpu_torch as att

    rng = np.random.default_rng([SEED, 2])
    cols = {c: rng.integers(0, n_rows, n_rows, dtype=np.int32)
            for c in ("ix", "ak")}
    cols["v"] = rng.integers(0, V_MAX, n_rows, dtype=np.int32)
    db = att.Database(platform=platform)
    try:
        con = db.connect()
        t0 = time.perf_counter()
        _load(con, "p", "CREATE TABLE p(ix INTEGER, ak INTEGER, v INTEGER)",
              cols)
        con.query("CREATE INDEX p_ix ON p(ix)")
        db.catalog.get_column_segment_catalog().compact_all_segments()
        n_seg = -(-n_rows // db.config.segment_rows)
        threshold = db.config.auto_index_threshold
        out = {"rows": n_rows, "segments": n_seg}
        print(f"[route probes] p: {n_rows} rows in {n_seg} segments, loaded, "
              f"indexed on ix and compacted in "
              f"{time.perf_counter() - t0:.2f} s", file=log, flush=True)
        for column, index in (("ix", "CREATE INDEX"), ("ak", "auto-index")):
            keys = rng.integers(0, n_rows, threshold + n_keys)

            def probe(name, key, rec, column=column):
                sql = f"SELECT * FROM p WHERE {column} = {int(key)}"
                ms, res, dev = _timed(con, sql)
                rows = np.flatnonzero(cols[column] == key)
                want = sorted(zip(*(cols[c][rows].tolist()
                                    for c in ("ix", "ak", "v"))))
                got = sorted(zip(*(np.asarray(res.column(i)).tolist()
                                   for i in range(3))))
                if got != want:
                    raise AssertionError(f"probe {column} = {key} ({name}): "
                                         f"{len(got)} rows != numpy's "
                                         f"{len(want)}")
                rec["device_path"] &= dev
                return ms

            recs = {}
            for name, cfg in configs:
                set_config(con, cfg)
                rec = recs[name] = {"runs_ms": [], "device_path": True}
                earn = [probe(name, key, rec) for key in keys[:threshold]]
                rec["cold_ms"], rec["earn_ms"] = earn[0], sum(earn)
            for i, key in enumerate(keys[threshold:]):
                for name, cfg in (configs if i % 2 == 0 else configs[::-1]):
                    set_config(con, cfg)
                    recs[name]["runs_ms"].append(probe(name, key,
                                                       recs[name]))
            for rec in recs.values():
                _hot(rec)
                rec["run_s"] = rec["hot_ms"] * PROBES_PER_RUN / 1e3
                rec["route"] = _scan_label(rec)
            out[column] = {"index": index, "routes": recs,
                           "auto_index_built":
                               db.dist_stats.get("auto_index_built", 0)}
            print(f"[route probes] {column} ({index}), {n_keys} keys: " +
                  "; ".join(f"{name} ({r['route']}) first {r['cold_ms']:.3f}"
                            f" ms, hot median {r['hot_ms']:.3f} ms, "
                            f"{PROBES_PER_RUN} probes {r['run_s']:.3f} s"
                            for name, r in recs.items()) +
                  f"; auto-indexes built {out[column]['auto_index_built']}"
                  "; == numpy",
                  file=log, flush=True)
    finally:
        db.close()
    return out


def _start_oracle(kind, scale):
    """sqlite's answers to a suite, computed in a child process."""
    import adacom_tpu_torch

    root = os.path.dirname(os.path.dirname(
        os.path.abspath(adacom_tpu_torch.__file__)))
    return subprocess.Popen(
        [sys.executable, "-m", "adacom_tpu_torch.tools.route_sweep",
         "--oracle", kind, str(scale)], stdout=subprocess.PIPE, text=True,
        cwd=root)


def _oracle_answers(oracles: dict, kind: str) -> dict:
    """The answers of oracles[kind], a child process from _start_oracle
    (waited for, then replaced by its answers) or the answers."""
    proc = oracles[kind]
    if isinstance(proc, subprocess.Popen):
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the sqlite oracle exited {proc.returncode}")
        oracles[kind] = {int(k): v for k, v in
                         json.loads(out.splitlines()[-1]).items()}
    return oracles[kind]


def oracle_main(kind, scale) -> dict:
    """{qid: sqlite's rows} for the TPC-H or ClickBench suite."""
    if kind == "clickbench":
        from adacom_tpu_torch.bench import clickbench as cb

        return cb.sqlite_answers(scale)["answers"]
    from adacom_tpu_torch.tools import verify_sf1

    return verify_sf1.sqlite_answers(scale)


def _suite_check(kind, qid, sql, exp):
    from adacom_tpu_torch.bench import clickbench as cb
    from adacom_tpu_torch.tools.verify_sf1 import _norm, _rows_equal

    exp = [tuple(r) for r in exp]

    def check(route, rows):
        if kind == "clickbench":
            ok = cb.answers_equal(qid, rows, exp)
        else:
            got, want = _norm(rows), exp
            if "ORDER BY" not in sql:
                got, want = sorted(got, key=repr), sorted(want, key=repr)
            ok = _rows_equal(got, want)
        if not ok:
            raise AssertionError(f"{kind} Q{qid} ({route}): {rows[:3]} != "
                                 f"sqlite's {exp[:3]}")
    return check


def suite_sweep(platform, configs, tpch_sf=1.0, cb_scale=0.1, hot=3,
                oracles=None, log=sys.stdout, suites=("tpch", "clickbench"),
                shards=0) -> dict:
    """The TPC-H (22) and ClickBench (43) queries of `suites` under each
    named config, on `shards` virtual shards of the device if non-zero,
    each answer equal to sqlite's (`oracles`: {"tpch", "clickbench"} as
    _oracle_answers takes them; started here if None). Returns {suite:
    {qid: _measure's record}, "sums": {config: sum of the hot medians},
    "slower": the queries the last config makes slower than the first
    (`slower`)}."""
    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import clickbench as cb
    from adacom_tpu_torch.bench import tpch
    from adacom_tpu_torch.parallel.mesh import make_virtual_mesh

    oracles = oracles or {"tpch": _start_oracle("tpch", tpch_sf),
                          "clickbench": _start_oracle("clickbench", cb_scale)}
    where = f" on {shards} virtual shards" if shards else ""
    out = {}
    for kind, mod, scale in (("tpch", tpch, tpch_sf),
                             ("clickbench", cb, cb_scale)):
        if kind not in suites:
            continue
        t0 = time.perf_counter()
        data = tpch.generate(sf=scale) if kind == "tpch" else \
            cb.generate(scale)
        db = att.Database(platform=platform, mesh=make_virtual_mesh(
            shards, platform) if shards else None)
        try:
            con = db.connect()
            mod.load_into_engine(con, data)
            del data
            db.catalog.get_column_segment_catalog().compact_all_segments()
            print(f"[route {kind}] scale {scale}{where} loaded and "
                  f"compacted in {time.perf_counter() - t0:.2f} s", file=log,
                  flush=True)
            exp = _oracle_answers(oracles, kind)
            recs = out[kind] = {}
            for qid in sorted(mod.QUERIES):
                sql = mod.QUERIES[qid]
                recs[qid] = _measure(con, sql, configs, hot, _suite_check(
                    kind, qid, sql, exp[qid]), fetch=True)
                print(f"[route {kind} Q{qid:02d}]{where} " + "; ".join(
                    f"{name} cold {r['cold_ms']:.3f} ms, hot median "
                    f"{r['hot_ms']:.3f} ms" for name, r in recs[qid].items())
                    + "; == sqlite", file=log, flush=True)
        finally:
            db.close()
    out["sums"] = {name: sum(rec[name]["hot_ms"] for kind in suites
                             for rec in out[kind].values())
                   for name, _cfg in configs}
    first, last = configs[0][0], configs[-1][0]
    out["slower"] = slower(out, last, first)
    print(f"[route suites]{where} sums of the {'+'.join(suites)} hot "
          f"medians: " + "; ".join(
              f"{k} {v:.3f} ms" for k, v in out["sums"].items()) + f"; {last} "
          f"more than 25% and 5 ms slower than {first}: " + (", ".join(
              f"{kind} Q{qid} {a:.3f} against {b:.3f} ms"
              for kind, qid, a, b in out["slower"]) or "none"), file=log,
          flush=True)
    return out


def segment_sweep(platform, ks=KS, n_rows=100_000_000, hot=20,
                  log=sys.stdout, routes=SEGMENT_ROUTES) -> list:
    """The range queries of the `segments` section under `routes`: a list
    of points {"k", "rows" (returned), "routes"}."""
    import adacom_tpu_torch as att

    db = att.Database(platform=platform)
    points = []
    try:
        con = db.connect()
        t0 = time.perf_counter()
        _load(con, "t1", "CREATE TABLE t1(i UINTEGER)",
              {"i": np.arange(n_rows, dtype=np.uint32)})
        db.catalog.get_column_segment_catalog().compact_all_segments()
        seg = db.config.segment_rows
        n_seg = -(-n_rows // seg)
        print(f"[route segments] t1: {n_rows} rows in {n_seg} segments, "
              f"loaded and compacted in {time.perf_counter() - t0:.2f} s",
              file=log, flush=True)
        for k in ks:
            if k > n_seg:
                continue
            s0 = (n_seg - k) // 2
            lo, hi = s0 * seg, min((s0 + k) * seg, n_rows) - 1

            def check(route, res, lo=lo, hi=hi, k=k):
                got, want = np.asarray(res.column(0), np.int64), \
                    np.arange(lo, hi + 1)
                if not np.array_equal(got, want) and not np.array_equal(
                        np.sort(got), want):
                    raise AssertionError(f"t1 BETWEEN {lo} AND {hi} ({k} "
                                         f"segments, {route}): "
                                         f"{len(got)} rows != numpy's")
            rec = _measure(con, f"SELECT * FROM t1 WHERE i BETWEEN {lo} AND "
                                f"{hi}", routes, hot, check)
            for r in rec.values():
                r["route"] = _scan_label(r)
            points.append({"k": k, "rows": hi - lo + 1, "routes": rec})
            print(_point_line("segments", points[-1]), file=log, flush=True)
    finally:
        db.close()
    return points


def headline_sweep(platform, configs, hot=3, scale=1.0,
                   log=sys.stdout) -> dict:
    """The headline's 10,000 Zipf(k=1) lookups over 100M * scale rows
    under each named config, every run verified. Returns {config:
    {"cold_s", "hot_s" (median), "runs_s"}}."""
    from adacom_tpu_torch.bench.succinct_benchmarks import (
        SuccinctZipfDistribution)

    b = SuccinctZipfDistribution(scale, platform)
    state: dict = {}
    b.load(state)
    out = {}
    try:
        def one(name, cfg):
            set_config(state["con"], cfg)
            t = time.perf_counter()
            b.run(state)
            s = time.perf_counter() - t
            err = b.verify(state)
            if err:
                raise AssertionError(f"headline lookups ({name}): {err}")
            return s

        for name, cfg in configs:
            out[name] = {"cold_s": one(name, cfg), "runs_s": []}
        for name, cfg in _turns(list(configs), hot):
            out[name]["runs_s"].append(one(name, cfg))
    finally:
        b.cleanup(state)
    for name, rec in out.items():
        rec["hot_s"] = statistics.median(rec["runs_s"]) if rec["runs_s"] \
            else rec["cold_s"]
    print("[route headline] 10,000 lookups, hot median: " + "; ".join(
        f"{k} {v['hot_s']:.4f} s" for k, v in out.items()) + "; all "
        "verified", file=log, flush=True)
    return out


def _point_line(section, p) -> str:
    r = p["routes"]
    where = {"agg": lambda: f"N {p['rows']}, D {p['domain']}, {p['query']}",
             "q15": lambda: f"SF {p['sf']} ({p['rows']} rows, "
                            f"{p['domain']} suppliers)",
             "segments": lambda: f"k {p['k']} ({p['rows']} rows)"}[section]()
    parts = [f"{name} ({rec['route']}) cold {rec['cold_ms']:.3f} ms, hot "
             f"median {rec['hot_ms']:.3f} ms" for name, rec in r.items()]
    if p.get("host_skipped"):
        parts.insert(0, f"host skipped (generic won at N "
                        f"{p['host_skipped']})")
    return f"[route {section}] {where}: " + "; ".join(parts) + "; == numpy"


def derive(res: dict) -> dict:
    """The routing values that the rules in PERF.md's Findings give for a
    result of run(); a knob whose sections did not run is left out, as is
    host_materialize where the configs were not MATERIALIZE_CONFIGS."""
    out = {}
    points = (res.get("agg") or []) + (res.get("q15") or [])
    if points:
        lost = {}  # N -> the generic route lost some point at N
        for p in points:
            r = p["routes"]
            lost[p["rows"]] = lost.get(p["rows"], False) or (
                "host" in r and r["generic"]["hot_ms"] > r["host"]["hot_ms"])
        rows = sorted(lost)
        wins = [n for i, n in enumerate(rows)
                if not any(lost[m] for m in rows[i:])]
        if not wins:
            out["device_agg_min_rows"] = NEVER
        elif wins[0] == rows[0]:
            out["device_agg_min_rows"] = 0
        else:
            out["device_agg_min_rows"] = 1 << (wins[0].bit_length() - 1)
    names = [name for name, _c in MATERIALIZE_CONFIGS]
    sw = res.get("materialize")
    if sw and list(sw["sums"]) == names:
        total = dict(sw["sums"])
        pr = res.get("probes")
        if pr and list(pr["ix"]["routes"]) == names:
            for column in ("ix", "ak"):
                for name in names:
                    total[name] += pr[column]["routes"][name]["run_s"] * 1e3
        t, f = (total[name] for name in names)
        out["host_materialize"] = True if abs(t - f) <= 0.05 * max(t, f) \
            else t < f
    if res.get("segments"):
        ok = [p["k"] for p in res["segments"]
              if p["routes"]["host"]["hot_ms"] <=
              p["routes"]["device"]["hot_ms"]]
        out["host_scan_segment_limit"] = max(ok) if ok else 0
    return out


def slower(sweep: dict, chosen: str, other: str, rel=0.25, abs_ms=5.0):
    """[(suite, qid, chosen ms, other ms)] of the queries that `chosen`
    makes more than rel and more than abs_ms slower than `other`."""
    out = []
    for kind in ("tpch", "clickbench"):
        for qid, rec in sweep.get(kind, {}).items():
            a, b = rec[chosen]["hot_ms"], rec[other]["hot_ms"]
            if a > b * (1 + rel) and a - b > abs_ms:
                out.append((kind, qid, a, b))
    return out


def run(sections: Sequence[str] = DERIVED, platform: str = "cuda",
        configs=None, rows=ROWS, domains=DOMAINS, queries=("all", "half"),
        sfs=(1.0, 10.0), probe_rows=PROBE_ROWS, probe_keys=PROBE_KEYS,
        ks=KS, tpch_sf=1.0, cb_scale=0.1, shards=4, hot=3, seg_hot=20,
        t1_rows=100_000_000, headline_scale=1.0, out: Optional[str] = None,
        log=sys.stdout) -> dict:
    """Run the named sections (see the module's docstring) on `platform`;
    `configs` [(name, knobs)] defaults to MATERIALIZE_CONFIGS. Returns
    {"device", "sections", "defaults", "configs", section: its points or
    records, "derived": derive()}; writes it as JSON to `out` if given."""
    from adacom_tpu_torch.main.database import resolve_device

    bad = set(sections) - set(SECTIONS)
    if bad:
        raise ValueError(f"unknown sections {sorted(bad)}")
    resolve_device(platform)  # "cuda" without a card raises here
    configs = list(configs or MATERIALIZE_CONFIGS)
    res = {"device": device_name(platform), "sections": list(sections),
           "defaults": defaults(), "configs": configs}
    # sqlite computes the suites' answers while the other sections run
    kinds = ({"tpch", "clickbench"} if "materialize" in sections else set()) \
        | ({"tpch"} if "mesh" in sections else set())
    oracles = {k: _start_oracle(k, tpch_sf if k == "tpch" else cb_scale)
               for k in sorted(kinds)}
    try:
        if "agg" in sections:
            res["agg"] = agg_sweep(platform, rows, domains, queries, hot, log)
        if "q15" in sections:
            res["q15"] = q15_sweep(platform, sfs, hot, log)
        if "probes" in sections:
            res["probes"] = probe_sweep(platform, configs, probe_rows,
                                        probe_keys, log)
        if "segments" in sections:
            res["segments"] = segment_sweep(platform, ks, t1_rows, seg_hot,
                                            log)
            res["segment_headline"] = headline_sweep(platform, [
                (f"limit {k}", {"host_materialize": False,
                                "host_scan_segment_limit": k})
                for k in dict.fromkeys((4, *ks))], hot, headline_scale, log)
        if "headline" in sections:
            res["headline"] = headline_sweep(platform, configs, hot,
                                             headline_scale, log)
        if "materialize" in sections:
            res["materialize"] = suite_sweep(
                platform, configs, tpch_sf, cb_scale, hot, oracles, log)
        if "mesh" in sections:
            res["mesh"] = suite_sweep(platform, configs, tpch_sf, cb_scale,
                                      hot, oracles, log, ("tpch",), shards)
    finally:
        for p in oracles.values():
            if isinstance(p, subprocess.Popen):
                p.kill()
                p.wait()
    res["derived"] = derive(res)
    print(f"[route derived] {res['derived']}", file=log, flush=True)
    if out is not None:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    return res


def _csv(kind):
    return lambda s: tuple(kind(float(x)) for x in s.split(","))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--oracle"]:
        print(json.dumps(oracle_main(argv[1], float(argv[2]))))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sections", nargs="*", default=list(DERIVED))
    ap.add_argument("--config", action="append", type=parse_config,
                    default=None, help="NAME:KNOB=VALUE,... (repeatable)")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rows", type=_csv(int), default=ROWS)
    ap.add_argument("--domains", type=_csv(int), default=DOMAINS)
    ap.add_argument("--sf", type=_csv(float), default=(1.0, 10.0))
    ap.add_argument("--probe-rows", type=float, default=PROBE_ROWS)
    ap.add_argument("--probe-keys", type=int, default=PROBE_KEYS)
    ap.add_argument("--ks", type=_csv(int), default=KS)
    ap.add_argument("--tpch-sf", type=float, default=1.0)
    ap.add_argument("--cb-scale", type=float, default=0.1)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--hot", type=int, default=3)
    ap.add_argument("--seg-hot", type=int, default=20)
    ap.add_argument("--t1-rows", type=float, default=100_000_000)
    ap.add_argument("--headline-scale", type=float, default=1.0)
    ap.add_argument("--out", default=None, help="JSON path (default: none)")
    a = ap.parse_args(argv)
    run(a.sections, a.platform, a.config, a.rows, a.domains,
        ("all", "half"), a.sf, int(a.probe_rows), a.probe_keys, a.ks,
        a.tpch_sf, a.cb_scale, a.shards, a.hot, a.seg_hot, int(a.t1_rows),
        a.headline_scale, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
