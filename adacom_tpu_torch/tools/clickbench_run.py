"""Run the 43-query ClickBench suite (bench/clickbench.py) on one shared
load: per query a discarded cold run and `nruns` hot runs, one TSV row per
hot run in the bench runner's schema
(`name\\trun\\ttiming\\tsizeInBytes\\tMemoryAllocationInBytes`).

Port of tools/clickbench_run.py as a function, ``run``; it writes only to
the path it is given and can hold every answer against sqlite.

    python3 -m adacom_tpu_torch.tools.clickbench_run [SCALE] [NRUNS] \\
        [--platform cuda|cpu] [--verify] [--out PATH]

SCALE 1.0 is 10M rows (default 0.1), NRUNS defaults to 3. --verify loads
the same data into sqlite in this process and compares every answer."""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable, Optional

from adacom_tpu_torch.tools import launch_counts, launches_since


def run(scale: float, nruns: int = 3, platform: str = "cuda",
        oracle: Optional[Callable[[int], list]] = None,
        out: Optional[str] = None, log=sys.stderr) -> dict:
    """Load generate(scale) once, compact, then run every query cold and
    `nruns` times hot. `oracle(qid)` (optional) returns sqlite's rows for
    query qid; each cold answer must equal them, and each hot answer the
    cold one, else AssertionError. Returns {"rows", "size", "load_s",
    "queries": {qid: {"cold_ms", "hot_ms" (list), "median_ms",
    "launches": {"B1", "B2", "B3", "decode", "scatter", "device_scan"} of
    the cold run}}}."""
    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import clickbench as cb

    t0 = time.perf_counter()
    data = cb.generate(scale)
    rows = len(data["hits"]["userid"][1])
    db = att.Database(platform=platform)
    try:
        con = db.connect()
        cb.load_into_engine(con, data)
        del data
        cat = db.catalog.get_column_segment_catalog()
        cat.compact_all_segments()
        size = cat.get_total_data_size()
        load_s = time.perf_counter() - t0
        queries, tsv = {}, []
        for qid in sorted(cb.QUERIES):
            sql = cb.QUERIES[qid]
            before = launch_counts()
            t = time.perf_counter()
            cold = con.query(sql).fetchall()
            cold_ms = (time.perf_counter() - t) * 1e3
            launches = launches_since(before)
            if oracle is not None and not cb.answers_equal(qid, cold,
                                                           oracle(qid)):
                raise AssertionError(
                    f"ClickBench Q{qid}: {cold[:3]} != sqlite's answer")
            hot = []
            for r in range(1, nruns + 1):
                t = time.perf_counter()
                again = con.query(sql).fetchall()
                dt = time.perf_counter() - t
                hot.append(dt * 1e3)
                if not cb.answers_equal(qid, again, cold):
                    raise AssertionError(f"ClickBench Q{qid}: hot run {r} "
                                         f"differs from the cold run")
                tsv.append(f"ClickBench_Q{qid:02d}\t{r}\t{dt:.6f}\t{size}\t"
                           f"{cat.get_total_data_size()}")
            queries[qid] = {
                "cold_ms": cold_ms, "hot_ms": hot,
                "median_ms": statistics.median(hot) if hot else None,
                "launches": launches}
            print(f"ClickBench_Q{qid:02d} cold {cold_ms:.3f} ms, hot "
                  f"median {queries[qid]['median_ms']} ms", file=log,
                  flush=True)
    finally:
        db.close()
    if out is not None:
        with open(out, "w") as f:
            f.write(f"# ClickBench 43 queries, {rows} rows (scale {scale}), "
                    f"platform {platform}"
                    f"{', every answer equal to sqlite' if oracle else ''}\n")
            f.write("\n".join(tsv) + "\n")
    return {"rows": rows, "size": size, "load_s": load_s, "queries": queries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scale", nargs="?", type=float, default=0.1)
    ap.add_argument("nruns", nargs="?", type=int, default=3)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--verify", action="store_true",
                    help="hold every answer against sqlite on the same data")
    ap.add_argument("--out", default=None, help="TSV path (default: none)")
    args = ap.parse_args(argv)
    oracle = None
    if args.verify:
        import sqlite3

        from adacom_tpu_torch.bench import clickbench as cb

        lite = sqlite3.connect(":memory:")
        cb.load_into_sqlite(lite, cb.generate(args.scale))

        def oracle(qid):
            return lite.execute(cb.ORACLE_QUERIES[qid]).fetchall()

    res = run(args.scale, args.nruns, args.platform, oracle, args.out)
    tot = sum(q["median_ms"] or 0.0 for q in res["queries"].values())
    print(f"sum of hot medians {tot:.3f} ms over {res['rows']} rows "
          f"(load {res['load_s']:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
