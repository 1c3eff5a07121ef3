"""Verify the 22 TPC-H queries against the sqlite3 oracle on the same data
(timing without result verification is not parity; the reference system
verifies every benchmark run against answer files).

Port of tools/verify_sf1.py as a function, ``run``: the same data, the
same five sqlite indexes, the same comparison (floats within 1e-9
relative, 1e-6 absolute, all else exact; rows sorted where the query has
no ORDER BY) and the same per-query record, plus each query's launches
of the device tiers.

    python3 -m adacom_tpu_torch.tools.verify_sf1 [SF] [--platform cuda|cpu] \\
        [--out PATH]

SF defaults to 1.0. The JSON record is written only to --out. Exits 1
unless all 22 answers agree."""

from __future__ import annotations

import argparse
import json
import math
import sqlite3
import sys
import time
from typing import Optional

import numpy as np

from adacom_tpu_torch.tools import launch_counts, launches_since

SQLITE_INDEXES = ("l_ok ON lineitem(l_orderkey)",
                  "l_pk ON lineitem(l_partkey)",
                  "l_sk ON lineitem(l_suppkey)",
                  "o_ok ON orders(o_orderkey)",
                  "ps_pk ON partsupp(ps_partkey)")


def _norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None:
                nr.append(None)
            elif isinstance(v, (float, np.floating)):
                nr.append(float(v))
            elif isinstance(v, (int, np.integer)):
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return out


def _rows_equal(got, exp):
    if len(got) != len(exp):
        return False
    for g, e in zip(got, exp):
        if len(g) != len(e):
            return False
        for a, b in zip(g, e):
            if isinstance(a, float) or isinstance(b, float):
                if a is None or b is None:
                    return False
                if not math.isclose(float(a), float(b), rel_tol=1e-9,
                                    abs_tol=1e-6):
                    return False
            elif a != b:
                return False
    return True


def load_sqlite(data) -> sqlite3.Connection:
    """An in-memory sqlite3 database holding the TPC-H tables `data`
    (tpch.generate's) with SQLITE_INDEXES."""
    from adacom_tpu_torch.bench import tpch

    lite = sqlite3.connect(":memory:")
    tpch.load_into_sqlite(lite, data)
    for spec in SQLITE_INDEXES:
        lite.execute(f"CREATE INDEX {spec}")
    return lite


def sqlite_answers(sf: float) -> dict:
    """{qid: sqlite's rows, _norm'ed} of the 22 queries at scale `sf`."""
    from adacom_tpu_torch.bench import tpch

    lite = load_sqlite(tpch.generate(sf=sf))
    try:
        return {qid: _norm(lite.execute(tpch.oracle_sql(qid)).fetchall())
                for qid in sorted(tpch.QUERIES)}
    finally:
        lite.close()


def run(sf: float = 1.0, platform: str = "cuda", out: Optional[str] = None,
        log=sys.stderr) -> dict:
    """Load TPC-H at scale factor `sf` into a database on `platform`
    (compacted) and into sqlite, run the 22 queries on both and compare.
    Returns {"sf", "platform", "passed", "total", "queries": {"Qnn": {"ok",
    "rows", "engine_s", "oracle_s", "launches" [, "got_head",
    "exp_head"]}}}; writes it as JSON to `out` if given."""
    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import tpch

    t0 = time.time()
    data = tpch.generate(sf=sf)
    db = att.Database(platform=platform)
    lite = None
    try:
        con = db.connect()
        tpch.load_into_engine(con, data)
        db.catalog.get_column_segment_catalog().compact_all_segments()
        print(f"engine loaded +{time.time() - t0:.0f}s", file=log, flush=True)
        lite = load_sqlite(data)
        del data
        print(f"oracle loaded +{time.time() - t0:.0f}s", file=log, flush=True)
        results = {}
        for qid in sorted(tpch.QUERIES):
            sql = tpch.QUERIES[qid]
            before = launch_counts()
            te = time.perf_counter()
            got = _norm(con.query(sql).fetchall())
            te = time.perf_counter() - te
            launched = launches_since(before)
            ts = time.perf_counter()
            exp = _norm(lite.execute(tpch.oracle_sql(qid)).fetchall())
            ts = time.perf_counter() - ts
            if "ORDER BY" not in sql:
                got, exp = sorted(got, key=repr), sorted(exp, key=repr)
            ok = _rows_equal(got, exp)
            rec = results[f"Q{qid:02d}"] = {
                "ok": bool(ok), "rows": len(got), "engine_s": round(te, 3),
                "oracle_s": round(ts, 3),
                "launches": launched,
            }
            if not ok:
                rec["got_head"] = [list(r) for r in got[:3]]
                rec["exp_head"] = [list(r) for r in exp[:3]]
            print(f"Q{qid:02d} {'OK ' if ok else 'FAIL'} rows={len(got)} "
                  f"engine={te:.2f}s oracle={ts:.2f}s", file=log, flush=True)
    finally:
        if lite is not None:
            lite.close()
        db.close()
    n_ok = sum(1 for r in results.values() if r["ok"])
    res = {"sf": sf, "platform": platform, "passed": n_ok,
           "total": len(results), "queries": results}
    if out is not None:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sf", nargs="?", type=float, default=1.0)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="JSON path (default: none)")
    args = ap.parse_args(argv)
    res = run(args.sf, args.platform, args.out)
    print(json.dumps({"passed": res["passed"], "total": res["total"]}))
    return 0 if res["passed"] == res["total"] else 1


if __name__ == "__main__":
    sys.exit(main())
