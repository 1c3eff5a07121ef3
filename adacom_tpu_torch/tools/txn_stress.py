"""Concurrent writers, transactions and checkpoints on one durable
database, then a crash and a reopen, held against a numpy model of the
acknowledged operations.

The workload (`run`; chip_smoke.py phase 15 at the defaults, on the card;
tests/test_torch_txn_durability.py at a cut size, on the CPU):
- `appenders` threads, each on a connection of its own, append `w_rows`
  rows in all into w(id BIGINT, v INTEGER) through autocommit appenders,
  `batch` rows per call;
- one thread runs `updates` UPDATEs over u(id BIGINT, v INTEGER), `u_rows`
  rows: each row gains 1 exactly once;
- one thread runs `txns` transactions on x(id BIGINT, v INTEGER),
  alternating COMMIT and ROLLBACK; each appends `txn_rows` rows and deletes
  a tenth of the table's rows, and meanwhile another connection's
  autocommit INSERT into x must raise (one writer per table) and its count
  must be the committed one;
- one thread runs CHECKPOINT until the others are done, counting those
  refused while a transaction was open.
The WAL checkpoints itself at `autocheckpoint` bytes, so checkpoints run
while the writers do. After the threads the last batch of w is appended,
so the log has a tail to replay: every table's count(*) and sum(v) equal
the model; `crash(db)` drops the database without its closing
checkpoint; the reopened database equals the model; after compaction a
count(*), sum(v) over w takes the fused scan (B1)."""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Dict

import numpy as np

TABLES = ("w", "u", "x")


def _answers(con) -> Dict[str, tuple]:
    out = {}
    for t in TABLES:
        n, s = con.query(f"SELECT count(*), sum(v) FROM {t}").fetchall()[0]
        out[t] = (int(n), 0 if s is None else int(s))
    return out


def run(path: str, crash: Callable, platform: str = "cuda", config=None,
        w_rows: int = 10_000_000, batch: int = 100_000, appenders: int = 4,
        u_rows: int = 1_000_000, updates: int = 50, txns: int = 20,
        txn_rows: int = 100_000, autocheckpoint: int = 32 << 20,
        checkpoint_pause_s: float = 1.0, timeout_s: float = 600.0) -> dict:
    """The workload above on a durable database at `path` (a new
    directory) on `platform`, with `config` (a DBConfig; its
    wal_autocheckpoint is set to `autocheckpoint`). Raises RuntimeError
    when an answer differs from the model, a thread raised or outlived
    `timeout_s`. Returns the rows and sums of each table, the checkpoints
    (automatic, explicit, refused), the conflicts raised, the WAL bytes at
    the crash, the reopen seconds, the fused-scan runs of the query over w
    (`scan_agg` from dist_stats, `b1_launches` from the kernel's counter)
    and the seconds of the threads and of the whole run."""
    import adacom_tpu_torch as att
    from adacom_tpu_torch.main.connection import SQLError
    from adacom_tpu_torch.ops import fused_scan

    t_run = time.perf_counter()
    config = config or att.DBConfig()
    config.wal_autocheckpoint = autocheckpoint
    db = att.Database(path=path, config=config, platform=platform)
    con = db.connect()
    for t in TABLES:
        con.query(f"CREATE TABLE {t}(id BIGINT, v INTEGER)")
    u_id = np.arange(u_rows, dtype=np.int64)
    app = con.appender("u")
    app.append_columns({"id": u_id, "v": (u_id % 1000).astype(np.int32)})
    app.close()
    seq0 = db._ckpt_seq

    errors, stats = [], {"ok": 0, "refused": 0, "conflicts": 0}
    x_ids = np.zeros(0, np.int64)  # the committed rows of x
    done = threading.Event()

    def guarded(body):
        def target(*args):
            try:
                body(*args)
            except Exception:  # noqa: BLE001 - every failure is reported
                errors.append(traceback.format_exc())
        return target

    n_batches = -(-w_rows // batch)

    def append_w(batches):
        a = db.connect().appender("w")
        for b in batches:
            ids = np.arange(b * batch, min(w_rows, (b + 1) * batch),
                            dtype=np.int64)
            a.append_columns({"id": ids, "v": (ids % 1000).astype(np.int32)})
        a.close()

    def update_u():
        c = db.connect()
        for i in range(updates):
            c.query(f"UPDATE u SET v = v + 1 WHERE id % {updates} = {i}")

    def transact_x():
        nonlocal x_ids
        c, probe = db.connect(), db.connect()
        for j in range(txns):
            ids = j * txn_rows + np.arange(txn_rows, dtype=np.int64)
            c.query("BEGIN")
            a = c.appender("x")
            a.append_columns({"id": ids, "v": (1 + ids % 97).astype(np.int32)})
            a.close()
            c.query(f"DELETE FROM x WHERE id % 10 = {j % 10}")
            try:
                probe.query("INSERT INTO x VALUES (-1, 1)")
                raise RuntimeError("an autocommit INSERT into x went into "
                                   "a table another transaction owns")
            except SQLError:
                stats["conflicts"] += 1
            seen = probe.query("SELECT count(*) FROM x").fetchall()[0][0]
            if seen != len(x_ids):
                raise RuntimeError(f"another connection counts {seen} rows "
                                   f"of x, {len(x_ids)} are committed")
            if j % 2 == 0:
                c.query("COMMIT")
                x_ids = np.concatenate([x_ids, ids])
                x_ids = x_ids[x_ids % 10 != j % 10]
            else:
                c.query("ROLLBACK")

    def checkpoints():
        c = db.connect()
        while not done.is_set():
            try:
                c.query("CHECKPOINT")
                stats["ok"] += 1
            except SQLError:
                stats["refused"] += 1
            done.wait(checkpoint_pause_s)

    writers = [threading.Thread(
        target=guarded(append_w),
        args=(range(k, n_batches - 1, appenders),))
        for k in range(appenders)]
    writers += [threading.Thread(target=guarded(update_u)),
                threading.Thread(target=guarded(transact_x))]
    ckpt = threading.Thread(target=guarded(checkpoints))
    t_threads = time.perf_counter()
    for th in writers + [ckpt]:
        th.start()
    deadline = time.monotonic() + timeout_s
    for th in writers:
        th.join(max(0.0, deadline - time.monotonic()))
    done.set()
    ckpt.join(max(1.0, deadline - time.monotonic()))
    t_threads = time.perf_counter() - t_threads
    alive = [th.name for th in writers + [ckpt] if th.is_alive()]
    if alive:
        raise RuntimeError(f"threads alive after {timeout_s} s: {alive}")
    if errors:
        raise RuntimeError("a writer raised:\n" + "\n".join(errors))
    append_w([n_batches - 1])

    w_id = np.arange(w_rows, dtype=np.int64)
    model = {"w": (w_rows, int((w_id % 1000).sum())),
             "u": (u_rows, int((u_id % 1000).sum()) + u_rows),
             "x": (len(x_ids), int((1 + x_ids % 97).sum()))}
    got = _answers(con)
    if got != model:
        raise RuntimeError(f"before the crash: {got} != model {model}")
    auto = db._ckpt_seq - seq0 - stats["ok"]
    wal_bytes = db.wal.size()
    crash(db)
    t = time.perf_counter()
    db = att.Database(path=path, config=config, platform=platform)
    reopen_s = time.perf_counter() - t
    try:
        con = db.connect()
        got = _answers(con)
        if got != model:
            raise RuntimeError(f"after the crash: {got} != model {model}")
        db.catalog.get_table("w").compact_all()
        runs = db.dist_stats.get("pallas_scan_agg", 0)
        launches = fused_scan.KERNEL_LAUNCHES
        got = con.query("SELECT count(*), sum(v) FROM w").fetchall()[0]
        if (int(got[0]), int(got[1])) != model["w"]:
            raise RuntimeError(f"compacted w: {got} != model {model['w']}")
        scan_agg = db.dist_stats.get("pallas_scan_agg", 0) - runs
        b1_launches = fused_scan.KERNEL_LAUNCHES - launches
    finally:
        db.close()
    return {"rows": {t: model[t][0] for t in TABLES},
            "sums": {t: model[t][1] for t in TABLES},
            "auto_checkpoints": auto, "checkpoints": stats["ok"],
            "refused": stats["refused"], "conflicts": stats["conflicts"],
            "wal_bytes": wal_bytes, "reopen_s": reopen_s,
            "scan_agg": scan_agg, "b1_launches": b1_launches,
            "threads_s": t_threads, "seconds": time.perf_counter() - t_run}
