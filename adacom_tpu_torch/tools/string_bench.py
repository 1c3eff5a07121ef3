"""String compression as VARCHAR cardinality rises: footprints of raw
utf-8, the dictionary at ingest, and the dictionary with its FSST-class
compression, and a LIKE scan and a point equality at each tier.

Port of tools/string_bench.py as a function, ``one_case``, with the
reference's strings: the footprint fields are byte-identical to the JAX
package's. Sweep: n rows at 1,000 / 100,000 / n distinct strings.

    python3 -m adacom_tpu_torch.tools.string_bench [ROWS] \\
        [--platform cuda|cpu] [--out PATH]

ROWS defaults to 2,000,000. The JSON record is written only to --out."""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np


def one_case(n_rows: int, card: int, platform: str = "cuda") -> dict:
    import adacom_tpu_torch as att

    rng = np.random.default_rng(7)
    ids = rng.integers(0, card, n_rows)
    strs = np.asarray(
        [f"/warehouse/region-{i % 89:02d}/aisle-{(i // 89) % 97:02d}/sku-{i:09d}"
         for i in ids], dtype=object)
    raw_bytes = sum(len(s.encode()) for s in strs) + 8 * (n_rows + 1)

    cfg = att.DBConfig()
    cfg.segment_rows = 65536
    db = att.Database(config=cfg, platform=platform)
    try:
        con = db.connect()
        con.query("CREATE TABLE t(v VARCHAR)")
        app = con.appender("t")
        app.append_column("v", strs)
        app.close()
        col = db.catalog.get_table("t").columns["v"]
        codes_bytes = 4 * n_rows
        dict_plain = col.dictionary.footprint_bytes()

        probe = strs[n_rows // 2]
        like_sql = "SELECT count(*) FROM t WHERE contains(v, 'aisle-42')"
        eq_sql = f"SELECT count(*) FROM t WHERE v = '{probe}'"

        def best3(sql):
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                con.query(sql).fetchall()
                ts.append(time.perf_counter() - t0)
            return round(min(ts), 4)

        t_like_plain = best3(like_sql)
        t_eq_plain = best3(eq_sql)

        db.catalog.get_column_segment_catalog().compact_all_segments()
        fsst_on = col.dictionary.is_compressed()
        dict_fsst = col.dictionary.footprint_bytes()
        t_like_fsst = best3(like_sql)
        t_eq_fsst = best3(eq_sql)
    finally:
        db.close()
    return {
        "rows": n_rows,
        "distinct": int(card),
        "raw_bytes": int(raw_bytes),
        "dict_bytes": int(codes_bytes + dict_plain),
        "dict_fsst_bytes": int(codes_bytes + dict_fsst),
        "fsst_adopted": bool(fsst_on),
        "vs_raw_dict": round((codes_bytes + dict_plain) / raw_bytes, 3),
        "vs_raw_dict_fsst": round((codes_bytes + dict_fsst) / raw_bytes, 3),
        "scan_contains_s": {"plain": t_like_plain, "fsst": t_like_fsst},
        "point_eq_s": {"plain": t_eq_plain, "fsst": t_eq_fsst},
    }


def run(n_rows: int = 2_000_000, platform: str = "cuda",
        out: Optional[str] = None) -> list:
    """`one_case` at 1,000, 100,000 and n_rows distinct strings; writes
    the list as JSON to `out` if given."""
    res = [one_case(n_rows, c, platform) for c in (1_000, 100_000, n_rows)]
    if out is not None:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="?", type=float, default=2_000_000)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="JSON path (default: none)")
    args = ap.parse_args(argv)
    print(json.dumps(run(int(args.rows), args.platform, args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
