"""Grouped dense-domain aggregate through the engine, with the fused tiers
off and on (`SET pallas_scan_enabled`).

Port of tools/grouped_agg_bench.py as a function, ``run``. Workload:
`SELECT g, sum(v), count(*) ... GROUP BY g` over n rows with a 6-value
group domain (TPC-H Q1's returnflag/linestatus shape), packed segments,
the best of 7 runs each way. Each side is named by the route it took, read
from the B2 launch count, the fused grouped tier's counter and the generic
path's runs: without the fused tiers the executor picks the generic device
path or the host aggregate, not a device twin of B2.

    python3 -m adacom_tpu_torch.tools.grouped_agg_bench [ROWS] \\
        [--platform cuda|cpu] [--out PATH]

ROWS defaults to 20,000,000. The JSON record is written only to --out."""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

from adacom_tpu_torch.tools import device_name, launch_counts, launches_since

QUERY = "SELECT g, sum(v), count(*) FROM t GROUP BY g ORDER BY g"
GROUPS = 6


def _route(launched: dict, tiers: int) -> str:
    """The route of a run: the B2 kernel (its launch count), the fused
    grouped tier's plain version (a CPU run: the tier's counter rose, no
    launch), the generic device path, or the host aggregate."""
    if launched["B2"]:
        return "b2_kernel"
    if tiers:
        return "b2_plain_version"
    if launched["device_scan"]:
        return "generic_device_path"
    return "host_aggregate"


def run(rows: int = 20_000_000, platform: str = "cuda",
        out: Optional[str] = None) -> dict:
    """Load t(g, v) with `rows` rows (seed 13), compact, and time QUERY
    with the fused tiers off and on. Both answers must agree, and group
    0's sum must equal numpy's. Returns the record: rows, groups, query,
    backend, "engine_s" ({"fused_off"/"fused_on": {"route", "s" (best
    seconds)}, "speedup"}) and the answer; writes it as JSON to `out` if
    given."""
    import adacom_tpu_torch as att

    db = att.Database(platform=platform)
    try:
        con = db.connect()
        con.query("CREATE TABLE t(g INTEGER, v INTEGER)")
        rng = np.random.default_rng(13)
        g = rng.integers(0, GROUPS, rows).astype(np.int32)
        v = rng.integers(0, 100_000, rows).astype(np.int32)
        app = con.appender("t")
        app.append_columns({"g": g, "v": v})
        app.close()
        db.catalog.get_column_segment_catalog().compact_all_segments()

        def best(n=7):
            before = launch_counts()
            tiers = db.dist_stats.get("pallas_grouped_agg", 0)
            ts, r = [], None
            for _ in range(n):
                t0 = time.perf_counter()
                r = con.query(QUERY).fetchall()
                ts.append(time.perf_counter() - t0)
            route = _route(launches_since(before),
                           db.dist_stats.get("pallas_grouped_agg", 0) - tiers)
            return route, min(ts), r

        con.query("SET pallas_scan_enabled = false")
        route_off, t_off, r_off = best()
        con.query("SET pallas_scan_enabled = true")
        route_on, t_on, r_on = best()
    finally:
        db.close()
    if r_off != r_on:
        raise AssertionError(f"{route_off} and {route_on} answers differ: "
                             f"{r_off} != {r_on}")
    exp0 = int(v[g == 0].astype(np.int64).sum())
    if int(r_on[0][1]) != exp0:
        raise AssertionError(f"group 0: sum {r_on[0][1]} != numpy's {exp0}")
    res = {
        "rows": rows,
        "groups": GROUPS,
        "query": QUERY,
        "backend": device_name(platform),
        "engine_s": {"fused_off": {"route": route_off, "s": t_off},
                     "fused_on": {"route": route_on, "s": t_on},
                     "speedup": t_off / t_on},
        "answer": [list(map(int, r)) for r in r_on],
    }
    if out is not None:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="?", type=float, default=20_000_000)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="JSON path (default: none)")
    args = ap.parse_args(argv)
    print(json.dumps(run(int(args.rows), args.platform, args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
