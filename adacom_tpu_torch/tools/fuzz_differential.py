"""Differential query fuzzer against sqlite: random SELECTs over a random
table, each answer compared with sqlite's as a row multiset.

Port of tools/fuzz_differential.py as a function, ``run``. The generator
(`make_data`, `gen_pred`, `gen_query`) and the comparison (`norm`,
`rows_equal`) are the reference's, so a seed gives the same table and the
same SQL in both packages. ``run`` also reports the routes the queries
took: the generic device path's runs, the B1/B2/B3 launches and the
database's event counters.

    python3 -m adacom_tpu_torch.tools.fuzz_differential [N_QUERIES] [SEED] \\
        [--platform cuda|cpu] [--route default|device|host|both] \\
        [--nulls FRACTION]

`--route device` sets `DEVICE_ROUTE`: every aggregate and scan the device
tiers accept runs on them. `--route host` sets `HOST_ROUTE`: host
materialization and the host tier for every filtered scan, and the host
aggregate for every dense GROUP BY wider than the fused tiers' 16 groups
(a narrower one that B2/B3 decline takes the generic device path on
every route, as on a card). `--route both` runs the host and device
configs on one sqlite oracle, so neither route depends on where the
defaults send a 20,000-row table. On every platform a run routes each
dense GROUP BY as a card does: on the CPU the gate
(`executor.dense_agg_on_host`) is asked with the device type "cuda" for
the length of the run (`card_gate`), so the CPU holds the host aggregate
that a card's defaults take, and `routes` counts the gate's answers. `--nulls
FRACTION` (default 0, the reference's stream) makes that
fraction of each column's values NULL, in both engines, with masks drawn
from a generator of their own (the values and the SQL stay the seed's),
and spells every ORDER BY item NULLS FIRST, as sqlite sorts them. Exits 1
on a divergence, printing the SQL."""

from __future__ import annotations

import argparse
import contextlib
import math
import sqlite3
import sys
from typing import Callable, Optional

import numpy as np

from adacom_tpu_torch.tools import launch_counts, launches_since

N_ROWS = 20_000
SEGMENT_ROWS = 2048
# the config that sends a small table through the device tiers
DEVICE_ROUTE = {"device_agg_min_rows": 0, "host_materialize": False,
                "host_scan_segment_limit": 0}
# the config that keeps what the routing knobs decide on the host
HOST_ROUTE = {"device_agg_min_rows": 1 << 62, "host_materialize": True,
              "host_scan_segment_limit": 1_000_000}
ROUTES = {"default": None, "device": DEVICE_ROUTE, "host": HOST_ROUTE}
MAX_MISMATCHES = 5
# the NULL masks' generator: seeded from the seed and this tag, apart from
# the values' generator
NULLS_STREAM = 0x4E554C4C


def make_data(rng, n):
    return {
        "a": rng.integers(-100, 100, n).astype(np.int32),
        "b": rng.integers(0, 10, n).astype(np.int32),
        "c": rng.integers(0, 1 << 40, n),
        "s": np.asarray([f"k{v}" for v in rng.integers(0, 20, n)],
                        dtype=object),
        "f": np.round(rng.normal(0, 50, n), 2),
    }


def make_nulls(seed, n, fraction):
    """Validity masks {column: valid} with `fraction` of each column of
    make_data NULL, or None when fraction is 0."""
    if not fraction:
        return None
    rng = np.random.default_rng([seed, NULLS_STREAM])
    return {c: rng.random(n) >= fraction for c in ("a", "b", "c", "s", "f")}


INT_COLS = ["a", "b", "c"]
AGGS = ["count(*)", "count({c})", "sum({c})", "min({c})", "max({c})",
        "avg({c})"]
CMP = ["=", "<>", "<", "<=", ">", ">="]


def gen_pred(rng):
    parts = []
    for _ in range(rng.integers(1, 4)):
        c = INT_COLS[rng.integers(0, len(INT_COLS))]
        op = CMP[rng.integers(0, len(CMP))]
        v = int(rng.integers(-120, 120))
        p = f"{c} {op} {v}"
        if rng.random() < 0.25:
            p = f"s = 'k{int(rng.integers(0, 25))}'"
        parts.append(p)
    glue = " AND " if rng.random() < 0.7 else " OR "
    return glue.join(parts)


def gen_query(rng, nulls_first=False):
    """One random SELECT; with nulls_first every ORDER BY item is spelled
    NULLS FIRST (the same draws, so the same query otherwise)."""
    nf = " NULLS FIRST" if nulls_first else ""
    kind = rng.random()
    if kind < 0.4:
        aggs = ", ".join(
            AGGS[rng.integers(0, len(AGGS))].format(
                c=INT_COLS[rng.integers(0, len(INT_COLS))])
            for _ in range(rng.integers(1, 4)))
        q = f"SELECT {aggs} FROM t WHERE {gen_pred(rng)}"
    elif kind < 0.75:
        g = ["b", "s"][rng.integers(0, 2)]
        agg = AGGS[rng.integers(1, len(AGGS))].format(
            c=INT_COLS[rng.integers(0, len(INT_COLS))])
        q = (f"SELECT {g}, count(*), {agg} FROM t WHERE {gen_pred(rng)} "
             f"GROUP BY {g} ORDER BY {g}{nf}")
    elif kind < 0.9:
        q = (f"SELECT a, b FROM t WHERE {gen_pred(rng)} "
             f"ORDER BY a{nf}, b{nf}, c{nf} "
             f"LIMIT {int(rng.integers(1, 50))}")
    elif kind < 0.92:
        q = (f"SELECT t1.b, count(*) FROM t t1 JOIN t t2 ON t1.b = t2.b "
             f"WHERE t1.a {CMP[rng.integers(0, 6)]} {int(rng.integers(-50, 50))} "
             f"GROUP BY t1.b ORDER BY t1.b{nf}")
    elif kind < 0.94:
        # CTE + HAVING
        q = (f"WITH x AS (SELECT b, sum(a) AS sa, count(*) AS c FROM t "
             f"WHERE {gen_pred(rng)} GROUP BY b) "
             f"SELECT b, sa FROM x WHERE c > {int(rng.integers(1, 50))} "
             f"ORDER BY b{nf}")
    elif kind < 0.96:
        # window function over a filtered subset
        q = (f"SELECT a, b, row_number() OVER (PARTITION BY b ORDER BY "
             f"a{nf}, c{nf}) AS rn FROM t WHERE {gen_pred(rng)} "
             f"ORDER BY a{nf}, b{nf}, c{nf} LIMIT 40")
    elif kind < 0.98:
        # set operation
        lo1, lo2 = int(rng.integers(-50, 0)), int(rng.integers(0, 50))
        op = ["UNION", "UNION ALL", "INTERSECT", "EXCEPT"][
            rng.integers(0, 4)]
        q = (f"SELECT b FROM t WHERE a < {lo1} {op} "
             f"SELECT b FROM t WHERE a > {lo2} ORDER BY b{nf}")
    else:
        # CASE + IN list aggregation
        vals = ", ".join(str(int(v)) for v in rng.integers(0, 10, 3))
        q = (f"SELECT CASE WHEN b IN ({vals}) THEN 1 ELSE 0 END AS k, "
             f"count(*), sum(a) FROM t GROUP BY k ORDER BY k{nf}")
    return q


def norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None:
                nr.append(None)
            elif isinstance(v, (float, np.floating)):
                nr.append(round(float(v), 6))
            elif isinstance(v, (int, np.integer)):
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return sorted(out, key=repr)


def rows_equal(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if len(x) != len(y):
            return False
        for p, q in zip(x, y):
            if isinstance(p, float) or isinstance(q, float):
                if p is None or q is None:
                    return False
                if not math.isclose(float(p), float(q), rel_tol=1e-6,
                                    abs_tol=1e-6):
                    return False
            elif p != q:
                return False
    return True


def routes(db, before: dict, gate: Optional[dict] = None) -> dict:
    """What ran since `before` (a `launch_counts()` reading): the launches'
    increments, the database's event counters (`dist_stats`) and, given
    `card_gate`'s counts, the gate's answers."""
    out = launches_since(before)
    out["dist_stats"] = {k: v for k, v in db.dist_stats.items() if v}
    out.update(gate or {})
    return out


@contextlib.contextmanager
def card_gate():
    """Inside the block the dense GROUP BY gate (executor.dense_agg_on_host,
    asked once for each dense GROUP BY the fused tiers decline) answers as
    on a CUDA database whatever the database's device, and counts its
    answers for the domains wider than the fused tiers take (the ones
    device_agg_min_rows decides): {"host_agg": sent to the host aggregate,
    "generic_agg": left to the generic device path}. The engine's own CPU
    routing is back when the block ends."""
    from adacom_tpu_torch.exec import executor
    from adacom_tpu_torch.ops import grouped_scan

    real = executor.dense_agg_on_host
    counts = {"host_agg": 0, "generic_agg": 0}

    def gate(rows, domain, _device_type, mesh, config):
        on_host = real(rows, domain, "cuda", mesh, config)
        if domain > grouped_scan.MAX_MULTI_GROUPS:
            counts["host_agg" if on_host else "generic_agg"] += 1
        return on_host

    executor.dense_agg_on_host = gate
    try:
        yield counts
    finally:
        executor.dense_agg_on_host = real


def db_config(overrides: Optional[dict], segment_rows: int):
    import adacom_tpu_torch as att

    cfg = att.DBConfig(segment_rows=segment_rows)
    for k, v in (overrides or {}).items():
        if not hasattr(cfg, k):
            raise ValueError(f"DBConfig has no field {k!r}")
        setattr(cfg, k, v)
    return cfg


class SqliteOracle:
    """sqlite on the fuzzer's table: `oracle(i, sql)` is query i's answer,
    normalized, computed once (two configs of one seed share it). `valid`:
    make_nulls' masks, whose False values are NULL."""

    def __init__(self, data: dict, valid: Optional[dict] = None):
        self.lite = sqlite3.connect(":memory:")
        self.lite.execute("CREATE TABLE t(a INTEGER, b INTEGER, c INTEGER, "
                          "s TEXT, f REAL)")
        cols = []
        for c in ("a", "b", "c", "s", "f"):
            vals = data[c].tolist()
            if valid is not None:
                vals = [v if ok else None for v, ok in zip(vals, valid[c])]
            cols.append(vals)
        self.lite.executemany("INSERT INTO t VALUES (?,?,?,?,?)", zip(*cols))
        self.answers: dict = {}

    def __call__(self, i: int, sql: str) -> list:
        if i not in self.answers:
            self.answers[i] = norm(self.lite.execute(sql).fetchall())
        return self.answers[i]


def stream(n_queries: int, seed: int, nulls: float = 0.0):
    """(data, [SQL]) of a seed: the table and the first n_queries queries,
    drawn as `run` draws them (with nulls, spelled for a NULL-bearing
    table)."""
    rng = np.random.default_rng(seed)
    data = make_data(rng, N_ROWS)
    return data, [gen_query(rng, bool(nulls)) for _ in range(n_queries)]


def oracle_answers(n_queries: int, seed: int, nulls: float = 0.0) -> list:
    """sqlite's normalized answers to a seed's first n_queries queries (what
    a separate oracle process computes)."""
    data, queries = stream(n_queries, seed, nulls)
    oracle = SqliteOracle(data, make_nulls(seed, N_ROWS, nulls))
    try:
        return [oracle(i, q) for i, q in enumerate(queries)]
    finally:
        oracle.lite.close()


def _compare(con, queries, oracle, log):
    """Run each query and hold it against `oracle` until MAX_MISMATCHES;
    returns (queries run, divergences)."""
    bad, mismatches, done = [], 0, 0
    for i, q in enumerate(queries):
        done += 1
        try:
            got = norm(con.query(q).fetchall())
        except Exception as e:  # a divergence, reported with its SQL
            print(f"[{i}] ENGINE ERROR on: {q}\n    {e}", file=log)
            bad.append({"i": i, "sql": q, "error": repr(e)})
            continue
        exp = oracle(i, q)
        if not rows_equal(got, exp):
            print(f"[{i}] MISMATCH on: {q}\n  got {got[:3]} ({len(got)})"
                  f"\n  exp {exp[:3]} ({len(exp)})", file=log)
            bad.append({"i": i, "sql": q, "got": got[:3], "exp": exp[:3]})
            mismatches += 1
            if mismatches >= MAX_MISMATCHES:
                break
    return done, bad


def run(n_queries: int = 300, seed: int = 0, platform: str = "cuda",
        config: Optional[dict] = None,
        oracle: Optional[Callable[[int, str], list]] = None,
        log=sys.stdout, nulls: float = 0.0) -> dict:
    """Fuzz `n_queries` SELECTs (seed `seed`) on a database on `platform`
    with the DBConfig fields in `config` set (segments of 2,048 rows, as
    the reference), `nulls` of each column NULL (make_nulls). `oracle(i,
    sql)` gives query i's normalized expected rows (default: sqlite in
    this process on the same table). Each dense GROUP BY is routed as on
    a card (`card_gate`). Stops after
    5 mismatches, as the reference does. Returns {"queries": queries run,
    "divergences": [{"i", "sql", "error" or "got"/"exp"}], "routes":
    routes() with the gate's counts}."""
    import adacom_tpu_torch as att

    data, queries = stream(n_queries, seed, nulls)
    valid = make_nulls(seed, N_ROWS, nulls)
    own = oracle is None
    if own:
        oracle = SqliteOracle(data, valid)
    db = att.Database(config=db_config(config, SEGMENT_ROWS),
                      platform=platform)
    try:
        con = db.connect()
        con.query("CREATE TABLE t(a INTEGER, b INTEGER, c BIGINT, "
                  "s VARCHAR, f DOUBLE)")
        app = con.appender("t")
        app.append_columns(data, valid)
        app.close()
        db.catalog.get_column_segment_catalog().compact_all_segments()
        before = launch_counts()
        with card_gate() as gate:
            done, bad = _compare(con, queries, oracle, log)
        return {"queries": done, "divergences": bad,
                "routes": routes(db, before, gate)}
    finally:
        if own:
            oracle.lite.close()
        db.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_queries", nargs="?", type=int, default=300)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--route", choices=(*ROUTES, "both"), default="default")
    ap.add_argument("--nulls", type=float, default=0.0, metavar="FRACTION")
    args = ap.parse_args(argv)
    names = ["host", "device"] if args.route == "both" else [args.route]
    oracle = SqliteOracle(stream(0, args.seed)[0],
                          make_nulls(args.seed, N_ROWS, args.nulls))
    bad = 0
    for name in names:
        res = run(args.n_queries, args.seed, args.platform, ROUTES[name],
                  oracle, nulls=args.nulls)
        bad += len(res["divergences"])
        print(f"{args.n_queries} queries ({name} route, nulls "
              f"{args.nulls}), "
              f"{len(res['divergences'])} divergences; routes "
              f"{res['routes']}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
