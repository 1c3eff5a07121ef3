"""Adaptive compaction over time (the reference system's
zipf_over_time.cpp): a Zipf point-lookup loop while the background policy
recompresses cold segments, recording per second the lookup rate, the data
footprint and the segment states.

Port of tools/adaptive_overtime.py as a function, ``run``, with the same
TSV columns. The footprint starts fully packed (every segment compacted
at load); the policy unpacks the hot head and keeps the cold tail packed.

    python3 -m adacom_tpu_torch.tools.adaptive_overtime [ROWS] [SECONDS] \\
        [--period S] [--platform cuda|cpu] [--out PATH]

ROWS defaults to 20,000,000, SECONDS to 30, the policy period to 2 s. The
TSV is written only to --out."""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

COLUMNS = "second\tqps\tdata_bytes\tn_packed\tn_plain\tpolicy_rounds"


def run(n: int = 20_000_000, seconds: float = 30.0, platform: str = "cuda",
        period_s: float = 2.0, out: Optional[str] = None,
        log=sys.stderr) -> dict:
    """Load t1(i UINTEGER) = 0..n-1, compact, and look up Zipf(k=1, seed
    31) values for `seconds` while the background policy runs every
    `period_s` seconds; the compaction thread is stopped before returning.
    Returns {"rows" (the TSV's lines), "packed_bytes", "plain_bytes",
    "policy_rounds", "lookups"}; writes the TSV to `out` if given."""
    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench.zipf import ZipfSampler

    cfg = att.DBConfig()
    cfg.adaptive_succinct_compression_enabled = True
    cfg.compaction_period_s = period_s
    db = att.Database(config=cfg, platform=platform)
    cat = db.catalog.get_column_segment_catalog()
    try:
        con = db.connect()
        con.query("CREATE TABLE t1(i UINTEGER)")
        app = con.appender("t1")
        chunk = 8 << 20
        for start in range(0, n, chunk):
            app.append_column("i", np.arange(start, min(start + chunk, n),
                                             dtype=np.uint32))
        app.close()
        cat.compact_all_segments()
        packed_bytes = cat.get_total_data_size()
        plain_bytes = 4 * n
        vals = ZipfSampler(n, 1.0, seed=31).sample(1 << 22)
        rows = [COLUMNS]
        t0 = time.perf_counter()
        t_int = t0
        done = k = sec = 0
        while time.perf_counter() - t0 < seconds:
            v = int(vals[k % len(vals)])
            k += 1
            con.query(f"SELECT i FROM t1 WHERE i == {v}")
            done += 1
            now = time.perf_counter()
            if now - t_int >= 1.0:
                segs = cat.segments_snapshot()
                n_packed = sum(1 for s in segs if s.is_compacted())
                sec += 1
                rows.append(f"{sec}\t{done / (now - t_int):.0f}\t"
                            f"{cat.get_total_data_size()}\t{n_packed}\t"
                            f"{len(segs) - n_packed}\t{cat.policy_rounds}")
                print(rows[-1], file=log, flush=True)
                t_int = now
                done = 0
    finally:
        cat.disable_background_compaction()
        db.close()
    rows.append(f"# all-plain={plain_bytes} all-packed={packed_bytes} "
                f"rows={n}")
    if out is not None:
        with open(out, "w") as f:
            f.write("\n".join(rows) + "\n")
    return {"rows": rows, "packed_bytes": packed_bytes,
            "plain_bytes": plain_bytes, "policy_rounds": cat.policy_rounds,
            "lookups": k}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="?", type=float, default=20_000_000)
    ap.add_argument("seconds", nargs="?", type=float, default=30.0)
    ap.add_argument("--period", type=float, default=2.0,
                    help="seconds between policy rounds")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="TSV path (default: none)")
    args = ap.parse_args(argv)
    res = run(int(args.rows), args.seconds, args.platform, args.period,
              args.out)
    print("\n".join(res["rows"][-3:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
