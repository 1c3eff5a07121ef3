"""DML differential fuzzer against sqlite: random INSERT/UPDATE/DELETE
(sometimes inside explicit transactions with a random COMMIT or ROLLBACK)
interleaved with state checks; the final table compared row for row.

Port of tools/fuzz_dml.py as a function, ``run``, with the reference's
op mix and seeds. Durable mode runs against a database directory and
compares on a fresh reopen after a crash: the first database is dropped
without its closing checkpoint (`crash`), so the reopen replays the WAL.
Every DELETE/UPDATE ... WHERE evaluates on the device scan unless the
plan is declined, so on the card this is a random check of that route.

    python3 -m adacom_tpu_torch.tools.fuzz_dml [N_OPS] [SEED] [durable] \\
        [--platform cuda|cpu] [--route default|device|host]

A durable run uses a temporary directory, removed at the end. Exits 1 on a
mismatch."""

from __future__ import annotations

import argparse
import sqlite3
import sys
import tempfile
from typing import Optional

import numpy as np

from adacom_tpu_torch.tools import launch_counts
from adacom_tpu_torch.tools.fuzz_differential import (
    ROUTES, db_config, routes)

SEGMENT_ROWS = 1024


def norm(rows):
    return sorted(tuple(int(v) if v is not None else None for v in r)
                  for r in rows)


def crash(db) -> None:
    """Drop a durable database as a crash would: the WAL is closed as it
    stands on disk and the closing checkpoint is skipped."""
    db.wal.close()
    db.catalog.shutdown()
    db._closed = True


def _ops(con, lite, rng, n_ops: int) -> Optional[str]:
    """The reference's op loop; returns the first state mismatch, if any."""
    in_txn = False
    for i in range(n_ops):
        r = rng.random()
        if not in_txn and r < 0.1:
            con.query("BEGIN TRANSACTION")
            lite.execute("BEGIN")
            in_txn = True
        elif in_txn and r < 0.25:
            if rng.random() < 0.5:
                con.query("COMMIT")
                lite.execute("COMMIT")
            else:
                con.query("ROLLBACK")
                lite.execute("ROLLBACK")
            in_txn = False
        elif r < 0.55:
            vals = ", ".join(
                f"({int(rng.integers(-50, 50))}, {int(rng.integers(0, 10))})"
                for _ in range(rng.integers(1, 40)))
            con.query(f"INSERT INTO t VALUES {vals}")
            lite.execute(f"INSERT INTO t VALUES {vals}")
        elif r < 0.75:
            lo = int(rng.integers(-60, 40))
            hi = lo + int(rng.integers(1, 30))
            q = f"DELETE FROM t WHERE a >= {lo} AND a < {hi}"
            con.query(q)
            lite.execute(q)
        else:
            lo = int(rng.integers(-60, 40))
            d = int(rng.integers(1, 5))
            q = f"UPDATE t SET b = b + {d} WHERE a >= {lo} AND a < {lo + 10}"
            con.query(q)
            lite.execute(q)
        if rng.random() < 0.2:
            got = norm(con.query("SELECT a, b FROM t").fetchall())
            exp = norm(lite.execute("SELECT a, b FROM t").fetchall())
            if got != exp:
                first = next((p for p in zip(got, exp) if p[0] != p[1]), None)
                return (f"[{i}] STATE MISMATCH ({len(got)} vs {len(exp)} "
                        f"rows); first diff: {first}")
    if in_txn:
        con.query("COMMIT")
        lite.execute("COMMIT")
    return None


def run(n_ops: int = 200, seed: int = 0, durable: bool = False,
        platform: str = "cuda", config: Optional[dict] = None) -> dict:
    """Run `n_ops` random DML ops (seed `seed`) on a database on
    `platform` (segments of 1,024 rows, as the reference, and the DBConfig
    fields in `config`) and on sqlite. Durable: in a temporary directory,
    crashed and reopened on the same platform before the final check.
    Returns {"ops", "durable", "rows" (the final row count), "mismatch"
    (None, or what differed), "routes"}."""
    import adacom_tpu_torch as att

    rng = np.random.default_rng(seed)
    tmp = tempfile.TemporaryDirectory() if durable else None
    path = None if tmp is None else f"{tmp.name}/db"
    lite = sqlite3.connect(":memory:")
    lite.isolation_level = None
    db = att.Database(path=path, config=db_config(config, SEGMENT_ROWS),
                      platform=platform)
    try:
        con = db.connect()
        con.query("CREATE TABLE t(a INTEGER, b INTEGER)")
        lite.execute("CREATE TABLE t(a INTEGER, b INTEGER)")
        before = launch_counts()
        mismatch = _ops(con, lite, rng, n_ops)
        got = exp = []
        if mismatch is None:
            if durable:
                stats = routes(db, before)["dist_stats"]
                crash(db)
                db = att.Database(path=path,
                                  config=db_config(config, SEGMENT_ROWS),
                                  platform=platform)
                con = db.connect()
                for k, v in stats.items():
                    db.dist_stats[k] = db.dist_stats.get(k, 0) + v
            got = norm(con.query("SELECT a, b FROM t").fetchall())
            exp = norm(lite.execute("SELECT a, b FROM t").fetchall())
            if got != exp:
                mismatch = f"FINAL MISMATCH {len(got)} vs {len(exp)}"
        return {"ops": n_ops, "durable": durable, "rows": len(got),
                "mismatch": mismatch, "routes": routes(db, before)}
    finally:
        lite.close()
        db.close()
        if tmp is not None:
            tmp.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ops", nargs="?", type=int, default=200)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("durable", nargs="?", choices=("durable",), default=None)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--route", choices=tuple(ROUTES), default="default")
    args = ap.parse_args(argv)
    res = run(args.n_ops, args.seed, args.durable is not None, args.platform,
              ROUTES[args.route])
    if res["mismatch"]:
        print(res["mismatch"])
        return 1
    print(f"{args.n_ops} DML ops{' +replay' if res['durable'] else ''}, "
          f"state matches ({res['rows']} rows); routes {res['routes']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
