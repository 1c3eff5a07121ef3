"""Run the 22 TPC-H queries on one shared load and record them in the bench
runner's TSV schema (name, run, timing, sizeInBytes,
MemoryAllocationInBytes), plus a markdown table beside the reference
system's own runtimes. Per query a discarded cold run, then `nruns` hot
runs (the reference's benchmark_runner.cpp:120-131).

Port of tools/tpch_sf1.py as a function, ``run``. On the card the device
tiers serve what they accept; `--platform cpu` is the host lane, with
the fused tiers off (`pallas_scan_enabled=False`), as the reference's
default run.

    python3 -m adacom_tpu_torch.tools.tpch_sf1 [NRUNS] [--sf SF] \\
        [--platform cuda|cpu] [--tsv PATH] [--md PATH]

The TSV and the markdown are written only to the paths given."""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from adacom_tpu_torch.tools import device_name, launch_counts, launches_since

# The reference system's committed TPC-H SF 1 runtimes in seconds (means of
# 5 runs on its authors' server, threads = hardware concurrency; its
# TPCH_runtime.txt). Neither a TPU nor an H100 figure.
REF = {1: 0.094, 2: 0.038, 3: 0.045, 4: 0.066, 5: 0.062, 6: 0.017,
       7: 0.073, 8: 0.059, 9: 0.113, 10: 0.072, 11: 0.027, 12: 0.055,
       13: 0.099, 14: 0.033, 15: 0.046, 16: 0.042, 17: 0.077, 18: 0.463,
       19: 0.060, 20: 0.057, 21: 0.217, 22: 0.031}


def compare_md(means: dict, nruns: int, sf: float, device: str) -> list:
    """The markdown comparison's lines: per query this run's mean and
    range beside the reference system's runtime."""
    lines = [
        f"# TPC-H SF {sf:g}: adacom_tpu_torch vs the reference system's "
        "committed runtimes",
        "",
        "Reference numbers: the reference system's own TPCH_runtime.txt at",
        "SF 1 (means of 5 runs, threads = hardware concurrency on its",
        "authors' server); not a TPU or H100 figure.",
        f"This run: synthetic SF {sf:g} corpus (bench/tpch.py) on {device},",
        f"mean of {nruns} hot runs after a discarded cold run. The answers",
        "are verified against sqlite by",
        "`python3 -m adacom_tpu_torch.tools.verify_sf1`.",
        "",
        "| Query | adacom_tpu_torch (s) | min..max | reference (s) | ratio |",
        "|---|---|---|---|---|",
    ]
    tot = rtot = 0.0
    for qid in sorted(means):
        m = float(np.mean(means[qid]))
        lo, hi = min(means[qid]), max(means[qid])
        r = REF[qid]
        tot += m
        rtot += r
        lines.append(f"| Q{qid:02d} | {m:.3f} | {lo:.3f}..{hi:.3f} "
                     f"| {r:.3f} | {m / r:.1f}x |")
    lines.append(f"| **total** | **{tot:.2f}** |  | **{rtot:.2f}** | "
                 f"**{tot / rtot:.1f}x** |")
    return lines


def run(sf: float = 1.0, nruns: int = 3, platform: str = "cuda",
        tsv: Optional[str] = None, md: Optional[str] = None,
        log=sys.stderr) -> dict:
    """Load TPC-H at `sf` into a database on `platform`, compact, and run
    each query once cold and `nruns` times hot. Returns {"size" (bytes
    after compaction), "tsv" (the rows), "means" ({qid: [hot seconds]}),
    "launches" ({qid: the cold run's launches}), "total", "ref_total",
    "device"}; writes the TSV to `tsv` and the
    markdown to `md` if given."""
    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import tpch

    data = tpch.generate(sf=sf)
    db = att.Database(platform=platform)
    if platform == "cpu":
        # the host tier alone: the fused tiers' plain versions are neither
        # the host tier nor the device tier
        db.config.pallas_scan_enabled = False
    try:
        con = db.connect()
        tpch.load_into_engine(con, data)
        del data
        cat = db.catalog.get_column_segment_catalog()
        cat.compact_all_segments()
        size = cat.get_total_data_size()
        rows_tsv, means, launches = [], {}, {}
        for qid in sorted(tpch.QUERIES):
            before = launch_counts()
            con.query(tpch.QUERIES[qid]).fetchall()  # discarded cold run
            launches[qid] = launches_since(before)
            ts = []
            for r in range(1, nruns + 1):
                t0 = time.perf_counter()
                con.query(tpch.QUERIES[qid]).fetchall()
                dt = time.perf_counter() - t0
                ts.append(dt)
                rows_tsv.append(f"TPCH_Q{qid:02d}\t{r}\t{dt:.6f}\t{size}\t"
                                f"{cat.get_total_data_size()}")
            means[qid] = ts
            print(f"Q{qid:02d} mean {np.mean(ts):.3f}s "
                  f"(+/- {np.std(ts):.3f})", file=log, flush=True)
    finally:
        db.close()
    device = device_name(platform)
    if tsv is not None:
        with open(tsv, "w") as f:
            f.write("\n".join(rows_tsv) + "\n")
    if md is not None:
        with open(md, "w") as f:
            f.write("\n".join(compare_md(means, nruns, sf, device)) + "\n")
    return {"size": size, "tsv": rows_tsv, "means": means, "device": device,
            "launches": launches,
            "total": sum(float(np.mean(v)) for v in means.values()),
            "ref_total": sum(REF.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nruns", nargs="?", type=int, default=3)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tsv", default=None, help="TSV path (default: none)")
    ap.add_argument("--md", default=None,
                    help="markdown comparison path (default: none)")
    args = ap.parse_args(argv)
    res = run(args.sf, args.nruns, args.platform, args.tsv, args.md)
    print(f"total {res['total']:.2f}s vs reference {res['ref_total']:.2f}s "
          f"({res['device']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
