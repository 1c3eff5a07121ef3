"""Differential query fuzzer against sqlite: random SELECTs over a random
table, each answer compared with sqlite's as a row multiset.

Port of tools/fuzz_differential.py as a function, ``run``. The generator
(`make_data`, `gen_pred`, `gen_query`) and the comparison (`norm`,
`rows_equal`) are the reference's, so a seed gives the same table and the
same SQL in both packages. ``run`` also reports the routes the queries
took: the generic device path's runs, the B1/B2/B3 launches and the
database's event counters.

    python3 -m adacom_tpu_torch.tools.fuzz_differential [N_QUERIES] [SEED] \\
        [--platform cuda|cpu] [--route default|device|both]

`--route device` sets `DEVICE_ROUTE`: every aggregate and scan the device
tiers accept runs on them, where the default config keeps a 20,000-row
table on the host; `--route both` runs the two configs on one sqlite
oracle. Exits 1 on a divergence, printing the SQL."""

from __future__ import annotations

import argparse
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
MAX_MISMATCHES = 5


def make_data(rng, n):
    return {
        "a": rng.integers(-100, 100, n).astype(np.int32),
        "b": rng.integers(0, 10, n).astype(np.int32),
        "c": rng.integers(0, 1 << 40, n),
        "s": np.asarray([f"k{v}" for v in rng.integers(0, 20, n)],
                        dtype=object),
        "f": np.round(rng.normal(0, 50, n), 2),
    }


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


def gen_query(rng):
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
             f"GROUP BY {g} ORDER BY {g}")
    elif kind < 0.9:
        q = (f"SELECT a, b FROM t WHERE {gen_pred(rng)} "
             f"ORDER BY a, b, c LIMIT {int(rng.integers(1, 50))}")
    elif kind < 0.92:
        q = (f"SELECT t1.b, count(*) FROM t t1 JOIN t t2 ON t1.b = t2.b "
             f"WHERE t1.a {CMP[rng.integers(0, 6)]} {int(rng.integers(-50, 50))} "
             f"GROUP BY t1.b ORDER BY t1.b")
    elif kind < 0.94:
        # CTE + HAVING
        q = (f"WITH x AS (SELECT b, sum(a) AS sa, count(*) AS c FROM t "
             f"WHERE {gen_pred(rng)} GROUP BY b) "
             f"SELECT b, sa FROM x WHERE c > {int(rng.integers(1, 50))} "
             f"ORDER BY b")
    elif kind < 0.96:
        # window function over a filtered subset
        q = (f"SELECT a, b, row_number() OVER (PARTITION BY b ORDER BY a, c)"
             f" AS rn FROM t WHERE {gen_pred(rng)} ORDER BY a, b, c "
             f"LIMIT 40")
    elif kind < 0.98:
        # set operation
        lo1, lo2 = int(rng.integers(-50, 0)), int(rng.integers(0, 50))
        op = ["UNION", "UNION ALL", "INTERSECT", "EXCEPT"][
            rng.integers(0, 4)]
        q = (f"SELECT b FROM t WHERE a < {lo1} {op} "
             f"SELECT b FROM t WHERE a > {lo2} ORDER BY b")
    else:
        # CASE + IN list aggregation
        vals = ", ".join(str(int(v)) for v in rng.integers(0, 10, 3))
        q = (f"SELECT CASE WHEN b IN ({vals}) THEN 1 ELSE 0 END AS k, "
             f"count(*), sum(a) FROM t GROUP BY k ORDER BY k")
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


def routes(db, before: dict) -> dict:
    """What ran since `before` (a `launch_counts()` reading): the launches'
    increments, and the database's event counters (`dist_stats`)."""
    out = launches_since(before)
    out["dist_stats"] = {k: v for k, v in db.dist_stats.items() if v}
    return out


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
    normalized, computed once (two configs of one seed share it)."""

    def __init__(self, data: dict):
        self.lite = sqlite3.connect(":memory:")
        self.lite.execute("CREATE TABLE t(a INTEGER, b INTEGER, c INTEGER, "
                          "s TEXT, f REAL)")
        self.lite.executemany("INSERT INTO t VALUES (?,?,?,?,?)", zip(
            data["a"].tolist(), data["b"].tolist(), data["c"].tolist(),
            data["s"].tolist(), data["f"].tolist()))
        self.answers: dict = {}

    def __call__(self, i: int, sql: str) -> list:
        if i not in self.answers:
            self.answers[i] = norm(self.lite.execute(sql).fetchall())
        return self.answers[i]


def stream(n_queries: int, seed: int):
    """(data, [SQL]) of a seed: the table and the first n_queries queries,
    drawn as `run` draws them."""
    rng = np.random.default_rng(seed)
    data = make_data(rng, N_ROWS)
    return data, [gen_query(rng) for _ in range(n_queries)]


def oracle_answers(n_queries: int, seed: int) -> list:
    """sqlite's normalized answers to a seed's first n_queries queries (what
    a separate oracle process computes)."""
    data, queries = stream(n_queries, seed)
    oracle = SqliteOracle(data)
    try:
        return [oracle(i, q) for i, q in enumerate(queries)]
    finally:
        oracle.lite.close()


def run(n_queries: int = 300, seed: int = 0, platform: str = "cuda",
        config: Optional[dict] = None,
        oracle: Optional[Callable[[int, str], list]] = None,
        log=sys.stdout) -> dict:
    """Fuzz `n_queries` SELECTs (seed `seed`) on a database on `platform`
    with the DBConfig fields in `config` set (segments of 2,048 rows, as
    the reference). `oracle(i, sql)` gives query i's normalized expected
    rows (default: sqlite in this process on the same table). Stops after
    5 mismatches, as the reference does. Returns {"queries": queries run,
    "divergences": [{"i", "sql", "error" or "got"/"exp"}], "routes":
    routes()}."""
    import adacom_tpu_torch as att

    data, queries = stream(n_queries, seed)
    own = oracle is None
    if own:
        oracle = SqliteOracle(data)
    db = att.Database(config=db_config(config, SEGMENT_ROWS),
                      platform=platform)
    try:
        con = db.connect()
        con.query("CREATE TABLE t(a INTEGER, b INTEGER, c BIGINT, "
                  "s VARCHAR, f DOUBLE)")
        app = con.appender("t")
        app.append_columns(data)
        app.close()
        db.catalog.get_column_segment_catalog().compact_all_segments()
        bad, mismatches, done = [], 0, 0
        before = launch_counts()
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
                bad.append({"i": i, "sql": q, "got": got[:3],
                            "exp": exp[:3]})
                mismatches += 1
                if mismatches >= MAX_MISMATCHES:
                    break
        return {"queries": done, "divergences": bad,
                "routes": routes(db, before)}
    finally:
        if own:
            oracle.lite.close()
        db.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_queries", nargs="?", type=int, default=300)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--route", choices=("default", "device", "both"),
                    default="default")
    args = ap.parse_args(argv)
    configs = {"default": None, "device": DEVICE_ROUTE}
    names = list(configs) if args.route == "both" else [args.route]
    oracle = SqliteOracle(stream(0, args.seed)[0])
    bad = 0
    for name in names:
        res = run(args.n_queries, args.seed, args.platform, configs[name],
                  oracle)
        bad += len(res["divergences"])
        print(f"{args.n_queries} queries ({name} route), "
              f"{len(res['divergences'])} divergences; routes "
              f"{res['routes']}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
