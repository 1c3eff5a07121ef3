"""Committed writes of the port survive concurrent connections,
transactions and checkpoints (and nothing else does).

Each case is a few statements on small durable databases under `tmp_path`
(the port on the CPU) and is held against a Python model of the
acknowledged operations: the live answers, and after a crash (`_crash`:
the WAL closed as it stands, no closing checkpoint) the reopened ones. The
JAX package runs the same steps beside it where it answers, and its wrong
answer is asserted as a record of the fault the port repairs:

R1. A table a transaction has written takes no write from another
    connection (autocommit INSERT, UPDATE, DELETE with or without WHERE,
    COPY FROM, an appender's flush, CREATE INDEX, DROP): SQLError, nothing
    changes; nor does a dropped table, through a writer that held it. The
    JAX package takes an autocommit INSERT, and the transaction's ROLLBACK
    then removes it; it logs a row after the DROP, and its directory no
    longer opens.
R2. Each transaction logs into a group of its own: another connection's
    autocommit write is durable at once and survives the transaction's
    ROLLBACK. The JAX package's single buffer holds it until the
    transaction ends and drops it with a ROLLBACK.
R3. A second BEGIN (another connection's, or the same one's, which now
    raises) leaves the open transaction's records alone. In the JAX package
    it empties the shared buffer: the reopen raises (a CREATE TABLE lost),
    or the ROLLBACK keeps a row.
R4. CHECKPOINT is refused, and an automatic checkpoint skipped, while a
    write transaction is open: after a crash the rolled-back row is absent
    and the committed one there once, as in sqlite. The JAX package
    checkpoints the open transaction's rows.
R5. A checkpoint holds its locks from the first read until the WAL is
    truncated: a second CHECKPOINT, a CREATE TABLE, an INSERT or an
    appender's flush in another thread waits for it and survives a crash.
    In the JAX package they run inside it (two checkpoints at once) and the
    writes are lost.
R6. ROLLBACK undoes CREATE/DROP of a table, index or view: memory, a crash
    copy and a later checkpoint agree. In the JAX package memory keeps the
    change and a crash loses it.

Beside them: connection tokens do not repeat, and a threaded stress of
appenders, UPDATEs, transactions and checkpoints (adacom_tpu_torch/tools/
txn_stress.py) crashes and reopens to its model within 20 s."""

import os
import shutil
import sqlite3
import sys
import threading
import time

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch as att
from adacom_tpu_torch.main.connection import SQLError
from adacom_tpu_torch.tools import txn_stress


@pytest.fixture(scope="module", autouse=True)
def _cold_pallas_runner_caches():
    """tests/test_pallas.py counts its Pallas runner caches' misses: leave
    them cold for the modules that run after this one in the process."""
    yield
    from adacom_tpu.ops import pallas_scan

    for f in vars(pallas_scan).values():
        if hasattr(f, "cache_clear") and \
                getattr(f, "__module__", None) == pallas_scan.__name__:
            f.cache_clear()


PKGS = {"jax": adacom_tpu, "port": att}
T_ROWS = "SELECT k, v FROM t ORDER BY k"


def _open(pkg, path, **cfg_kw):
    cfg = pkg.DBConfig()
    cfg.segment_rows = 1024
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    kw = {"platform": "cpu"} if pkg is att else {}
    return pkg.Database(path=str(path), config=cfg, **kw)


def _crash(db):
    """Drop the handle without a checkpoint: the WAL as it is on disk."""
    db.wal.close()
    db.catalog.shutdown()
    db._closed = True


def _reopen(pkg, path, **cfg_kw):
    """The database at `path` reopened, and a connection to it."""
    db = _open(pkg, path, **cfg_kw)
    return db, db.connect()


def _rows(con, sql):
    return [tuple(None if v is None else v if isinstance(v, str) else int(v)
                  for v in r) for r in con.query(sql).fetchall()]


def _setup(db):
    """t(k, v) holding (1, 10), an empty u(i); returns a connection."""
    con = db.connect()
    con.query("CREATE TABLE t(k INTEGER, v INTEGER)")
    con.query("INSERT INTO t VALUES (1, 10)")
    con.query("CREATE TABLE u(i INTEGER)")
    return con


def _catalog(db, con):
    """Tables (with their rows), views and indexes: what R6 compares."""
    tables = {n: _rows(con, f"SELECT * FROM {n} ORDER BY 1")
              for n in sorted(db.catalog.tables)}
    return tables, sorted(db.catalog.views), sorted(db.catalog.indexes)


# ======================================================================
# R1: one writer per table
# ======================================================================

def _copy(con, tmp_path):
    path = tmp_path / "r.csv"
    path.write_text("k,v\n5,50\n")
    con.query(f"COPY t FROM '{path}' (HEADER)")


def _append(con, _tmp_path):
    app = con.appender("t")
    app.append_row(6, 60)
    app.close()


WRITES = {
    "insert": lambda con, _p: con.query("INSERT INTO t VALUES (2, 20)"),
    "update": lambda con, _p: con.query("UPDATE t SET v = v + 1"),
    "delete": lambda con, _p: con.query("DELETE FROM t WHERE k = 1"),
    "delete_all": lambda con, _p: con.query("DELETE FROM t"),
    "copy": _copy,
    "appender": _append,
    "create_index": lambda con, _p: con.query("CREATE INDEX tk ON t(k)"),
    "drop": lambda con, _p: con.query("DROP TABLE t"),
}


@pytest.mark.parametrize("end", ["COMMIT", "ROLLBACK"])
@pytest.mark.parametrize("write", sorted(WRITES))
def test_r1_owned_table_refuses_other_writers(tmp_path, write, end):
    """A: BEGIN; INSERT INTO t. B's autocommit write into t raises and
    changes nothing; A's end decides its own row alone; then B writes."""
    db = _open(att, tmp_path / "db")
    a = _setup(db)
    b = db.connect()
    a.query("BEGIN")
    a.query("INSERT INTO t VALUES (7, 70)")
    with pytest.raises(SQLError, match="another transaction"):
        WRITES[write](b, tmp_path)
    assert _rows(b, T_ROWS) == [(1, 10)]
    assert _rows(a, T_ROWS) == [(1, 10), (7, 70)]
    assert sorted(db.catalog.indexes) == [] and db.catalog.has_table("t")
    a.query(end)
    b.query("INSERT INTO t VALUES (3, 30)")  # t is free again
    want = [(1, 10), (3, 30)] + ([(7, 70)] if end == "COMMIT" else [])
    assert _rows(b, T_ROWS) == want
    _crash(db)
    db, con = _reopen(att, tmp_path / "db")
    assert _rows(con, T_ROWS) == want
    db.close()


@pytest.mark.parametrize("end", ["COMMIT", "ROLLBACK"])
def test_r1_jax_package_takes_the_write(tmp_path, end):
    """The record: in the JAX package B's INSERT is accepted, B does not
    see it, and A's ROLLBACK (which cuts t by row position) removes it."""
    db = _open(adacom_tpu, tmp_path / "db")
    a = _setup(db)
    b = db.connect()
    a.query("BEGIN")
    a.query("INSERT INTO t VALUES (7, 70)")
    b.query("INSERT INTO t VALUES (2, 20)")
    assert _rows(b, T_ROWS) == [(1, 10)]
    a.query(end)
    want = [(1, 10)] if end == "ROLLBACK" else [(1, 10), (2, 20), (7, 70)]
    assert _rows(b, T_ROWS) == want
    _crash(db)


@pytest.mark.parametrize("txn", [False, True])
def test_r1_no_write_after_a_drop(tmp_path, txn):
    """B holds an appender on t; A drops t (autocommit, or in a committed
    transaction); B's flush raises, so no row is logged after the DROP and
    the directory reopens without t. The JAX package takes the flush and
    logs it after the DROP: its reopen raises."""
    for name, pkg in PKGS.items():
        d = tmp_path / name
        db = _open(pkg, d)
        a = _setup(db)
        app = db.connect().appender("t")
        app.append_row(2, 20)
        if txn:
            a.query("BEGIN")
        a.query("DROP TABLE t")
        if txn:
            a.query("COMMIT")
        if pkg is att:
            with pytest.raises(SQLError, match="dropped"):
                app.close()
            _crash(db)
            db, con = _reopen(pkg, d)
            assert not db.catalog.has_table("t")
            db.close()
            continue
        app.close()
        _crash(db)
        from adacom_tpu.catalog.catalog import CatalogException

        with pytest.raises(CatalogException, match="'t' does not exist"):
            _open(pkg, d)


# ======================================================================
# R2: a transaction's records are its own
# ======================================================================

@pytest.mark.parametrize("end", ["COMMIT", "ROLLBACK"])
def test_r2_autocommit_write_beside_a_transaction_is_durable(tmp_path, end):
    """A: BEGIN; INSERT INTO t. B: INSERT INTO u VALUES (3), acknowledged.
    A crash copy taken before A ends has u's row; after A's end and a
    crash, u has it too, and t has A's row only after COMMIT."""
    got = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        db = _open(pkg, d / "db")
        a = _setup(db)
        b = db.connect()
        a.query("BEGIN")
        a.query("INSERT INTO t VALUES (7, 70)")
        b.query("INSERT INTO u VALUES (3)")
        shutil.copytree(d / "db", d / "copy")  # a crash while A is open
        a.query(end)
        _crash(db)
        out = []
        for sub in ("copy", "db"):
            db, con = _reopen(pkg, d / sub)
            out.append((_rows(con, "SELECT i FROM u"), _rows(con, T_ROWS)))
            _crash(db)
        got[name] = out
    t_end = [(1, 10), (7, 70)] if end == "COMMIT" else [(1, 10)]
    assert got["port"] == [([(3,)], [(1, 10)]), ([(3,)], t_end)]
    # the record: B's row waited in A's buffer, and a ROLLBACK dropped it
    assert got["jax"] == [([], [(1, 10)]),
                          ([(3,)] if end == "COMMIT" else [], t_end)]


# ======================================================================
# R3: a second BEGIN
# ======================================================================

def test_r3_another_connections_begin_keeps_the_open_transaction(tmp_path):
    """A: BEGIN; CREATE TABLE y. B: BEGIN; COMMIT. A: INSERT INTO y;
    COMMIT. The reopen has y with A's row; the JAX package's B emptied the
    shared buffer, lost A's CREATE record, and its directory no longer
    opens."""
    for name, pkg in PKGS.items():
        d = tmp_path / name
        db = _open(pkg, d)
        a, b = db.connect(), db.connect()
        a.query("BEGIN")
        a.query("CREATE TABLE y(i INTEGER)")
        b.query("BEGIN")
        b.query("COMMIT")
        a.query("INSERT INTO y VALUES (1)")
        a.query("COMMIT")
        _crash(db)
        if pkg is adacom_tpu:
            from adacom_tpu.catalog.catalog import CatalogException

            with pytest.raises(CatalogException, match="'y' does not exist"):
                _open(pkg, d)
            continue
        db, con = _reopen(pkg, d)
        assert _rows(con, "SELECT i FROM y") == [(1,)]
        db.close()


def test_r3_begin_inside_a_transaction_raises(tmp_path):
    """BEGIN; INSERT; BEGIN; ROLLBACK: the port refuses the second BEGIN
    and the ROLLBACK takes the row back; the JAX package's second BEGIN
    forgets the first's rows, so its ROLLBACK keeps the row in memory
    (and the reopen drops it)."""
    got = {}
    for name, pkg in PKGS.items():
        db = _open(pkg, tmp_path / name)
        con = _setup(db)
        con.query("BEGIN")
        con.query("INSERT INTO t VALUES (7, 70)")
        if pkg is att:
            with pytest.raises(SQLError, match="already open"):
                con.query("BEGIN")
        else:
            con.query("BEGIN")
        con.query("ROLLBACK")
        live = _rows(con, T_ROWS)
        _crash(db)
        db, con = _reopen(pkg, tmp_path / name)
        got[name] = (live, _rows(con, T_ROWS))
        _crash(db)
    assert got["port"] == ([(1, 10)], [(1, 10)])
    assert got["jax"] == ([(1, 10), (7, 70)], [(1, 10)])


# ======================================================================
# R4: checkpoints at a consistent cut
# ======================================================================

def _sqlite_answer(path, end, kind):
    """The same steps in sqlite (a file in WAL mode, two connections): A
    inserts in a transaction, B checkpoints (or only reads: a second
    writer would wait in sqlite), A ends; the answer after a reopen."""
    a = sqlite3.connect(path, isolation_level=None)
    b = sqlite3.connect(path, isolation_level=None)
    a.execute("PRAGMA journal_mode=WAL")
    a.execute("PRAGMA wal_autocheckpoint=1")
    a.execute("CREATE TABLE t(k INTEGER, v INTEGER)")
    a.execute("INSERT INTO t VALUES (1, 10)")
    a.execute("BEGIN")
    a.execute("INSERT INTO t VALUES (2, 20)")
    if kind == "explicit":
        b.execute("PRAGMA wal_checkpoint(PASSIVE)")
    else:
        b.execute("SELECT count(*) FROM t").fetchall()
    a.execute(end)
    a.close()
    b.close()
    c = sqlite3.connect(path)
    out = c.execute("SELECT count(*), sum(v) FROM t").fetchall()
    c.close()
    return [tuple(int(v) for v in r) for r in out]


@pytest.mark.parametrize("end", ["COMMIT", "ROLLBACK"])
@pytest.mark.parametrize("kind", ["explicit", "auto"])
def test_r4_no_checkpoint_inside_a_write_transaction(tmp_path, kind, end):
    """A: BEGIN; INSERT INTO t VALUES (2, 20). B: CHECKPOINT (refused:
    SQLError), or an autocommit INSERT INTO u past a 1-byte autocheckpoint
    threshold (its checkpoint skipped). A ends; a crash; the reopen equals
    the model and sqlite. The JAX package checkpoints A's row: back after
    a ROLLBACK, twice after a COMMIT that an explicit CHECKPOINT
    preceded."""
    want = [(2, 30)] if end == "COMMIT" else [(1, 10)]
    assert _sqlite_answer(str(tmp_path / "lite.db"), end, kind) == want
    got = {}
    for name, pkg in PKGS.items():
        db = _open(pkg, tmp_path / name)
        a = _setup(db)
        if kind == "auto":
            db.config.wal_autocheckpoint = 1  # the setup's records are over
        b = db.connect()
        seq = db._ckpt_seq
        a.query("BEGIN")
        a.query("INSERT INTO t VALUES (2, 20)")
        if kind == "explicit" and pkg is att:
            with pytest.raises(SQLError, match="CHECKPOINT"):
                b.query("CHECKPOINT")
            with pytest.raises(SQLError, match="CHECKPOINT"):
                a.query("CHECKPOINT")  # the caller's own transaction too
        elif kind == "explicit":
            b.query("CHECKPOINT")
        else:
            b.query("INSERT INTO u VALUES (3)")
        if pkg is att:
            assert db._ckpt_seq == seq
        a.query(end)
        _crash(db)
        db, con = _reopen(pkg, tmp_path / name)
        got[name] = _rows(con, "SELECT count(*), sum(v) FROM t")
        _crash(db)
    assert got["port"] == want
    # the record: A's row in the checkpoint; an explicit one before a
    # COMMIT doubles it (the JAX package's COMMIT checkpoints again at a
    # 1-byte threshold, which hides it there)
    double = kind == "explicit" and end == "COMMIT"
    assert got["jax"] == ([(3, 50)] if double else [(2, 30)])


def test_r4_close_with_an_open_transaction_keeps_the_wal(tmp_path):
    """Database.close() while another connection's transaction is open
    writes no checkpoint and leaves the WAL: the reopen has the committed
    rows only."""
    db = _open(att, tmp_path)
    con = _setup(db)
    other = db.connect()
    other.query("BEGIN")
    other.query("INSERT INTO t VALUES (2, 20)")
    size = db.wal.size()
    db.close()
    assert db._read_current() is None
    assert os.path.getsize(tmp_path / "wal.log") == size
    db, con = _reopen(att, tmp_path)
    assert _rows(con, T_ROWS) == [(1, 10)]
    db.close()


# ======================================================================
# R5: a checkpoint holds its locks
# ======================================================================

def _r5_action(kind):
    def act(con):
        if kind == "checkpoint":
            con.query("CHECKPOINT")
        elif kind == "create_table":
            con.query("CREATE TABLE z(i INTEGER)")
        elif kind == "insert":
            con.query("INSERT INTO t VALUES (9, 90)")
        else:
            app = con.appender("t")
            app.append_row(8, 80)
            app.close()
    return act


@pytest.mark.parametrize("kind", ["checkpoint", "create_table", "insert",
                                  "appender"])
def test_r5_checkpoint_excludes_concurrent_changes(tmp_path, monkeypatch,
                                                   kind):
    """A CHECKPOINT pauses after it has read the tables (a hook on
    write_checkpoint); meanwhile another thread runs `kind`. In the port
    that thread waits until the checkpoint is done (so no two checkpoints
    overlap), its change then reaches the log, and a crash keeps it. In
    the JAX package it runs inside the checkpoint and its change is
    truncated away with the WAL."""
    import importlib

    answers = {}
    for name, pkg in PKGS.items():
        ckpt = importlib.import_module(f"{pkg.__name__}.storage.checkpoint")
        write = ckpt.write_checkpoint
        paused, go = threading.Event(), threading.Event()
        inside, most = [0], [0]

        def hooked(db, path, write=write, paused=paused, go=go,
                   inside=inside, most=most):
            inside[0] += 1
            most[0] = max(most[0], inside[0])
            try:
                write(db, path)
                if not paused.is_set():
                    paused.set()
                    go.wait(30)
            finally:
                inside[0] -= 1

        monkeypatch.setattr(ckpt, "write_checkpoint", hooked)
        d = tmp_path / name
        db = _open(pkg, d)
        _setup(db)
        first = threading.Thread(
            target=lambda: db.connect().query("CHECKPOINT"))
        first.start()
        assert paused.wait(30)
        second = threading.Thread(target=_r5_action(kind),
                                  args=(db.connect(),))
        second.start()
        second.join(0.3)
        waited = second.is_alive()
        go.set()
        first.join(30)
        second.join(30)
        assert not first.is_alive() and not second.is_alive()
        monkeypatch.setattr(ckpt, "write_checkpoint", write)
        _crash(db)
        db, con = _reopen(pkg, d)
        answers[name] = (waited, most[0], _rows(con, T_ROWS),
                         db.catalog.has_table("z"), db._ckpt_seq)
        _crash(db)
    t_rows = {"insert": [(1, 10), (9, 90)],
              "appender": [(1, 10), (8, 80)]}.get(kind, [(1, 10)])
    assert answers["port"] == (True, 1, t_rows, kind == "create_table",
                               2 if kind == "checkpoint" else 1)
    # the record: the second thread ran inside the first checkpoint
    waited, most, rows, has_z, _seq = answers["jax"]
    assert not waited
    if kind == "checkpoint":
        assert most == 2
    else:
        assert (rows, has_z) == ([(1, 10)], False)  # the change was lost


# ======================================================================
# R6: ROLLBACK undoes catalog changes
# ======================================================================

CHANGES = {
    "create_table": ("CREATE TABLE x(i INTEGER)", "INSERT INTO x VALUES (1)"),
    "drop_table": ("INSERT INTO t VALUES (2, 20)", "DROP TABLE t"),
    "create_index": ("CREATE INDEX tv ON t(v)",),
    "drop_index": ("DROP INDEX tk",),
    "create_view": ("CREATE VIEW w AS SELECT k FROM t",),
    "drop_view": ("DROP VIEW tview",),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_r6_rollback_undoes_catalog_changes(tmp_path, change):
    """BEGIN; the change; ROLLBACK. The catalog in memory is the one
    before BEGIN, and so are a crash copy's and, after a CHECKPOINT, the
    reopened database's. The JAX package keeps the change in memory and a
    crash copy loses it."""
    got = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        db = _open(pkg, d / "db")
        con = _setup(db)
        con.query("CREATE UNIQUE INDEX tk ON t(k)")
        con.query("CREATE VIEW tview AS SELECT v FROM t")
        before = _catalog(db, con)
        con.query("BEGIN")
        for sql in CHANGES[change]:
            con.query(sql)
        con.query("ROLLBACK")
        live = _catalog(db, con)
        shutil.copytree(d / "db", d / "copy")
        if pkg is att:
            con.query("CHECKPOINT")
        _crash(db)
        out = [before, live]
        for sub in ("copy", "db"):
            db, con = _reopen(pkg, d / sub)
            out.append(_catalog(db, con))
            _crash(db)
        got[name] = out
    before = got["port"][0]
    assert got["port"] == [before] * 4
    jbefore, jlive, jcopy, _ = got["jax"]
    assert jbefore == before and jcopy == before and jlive != before


# ======================================================================
# connection tokens, and the threaded stress
# ======================================================================

def test_connection_tokens_never_repeat(tmp_path):
    """Connections made and dropped in a loop get new tokens (id() of a
    collected connection comes back), so none inherits a dead one's
    tables."""
    db = _open(att, tmp_path)
    tokens = [db.connect()._token for _ in range(200)]
    assert len(set(tokens)) == len(tokens)
    db.close()


def test_stress_concurrent_writers_transactions_checkpoints(tmp_path):
    """Four appenders, an UPDATE thread, a COMMIT/ROLLBACK transaction
    thread with a conflicting autocommit probe, and a CHECKPOINT thread,
    the WAL checkpointing itself every 4 KB; a crash and a reopen equal the
    model (txn_stress raises otherwise), every thread joined in time. The
    interpreter switches threads every 0.1 ms meanwhile."""
    cfg = att.DBConfig()
    cfg.segment_rows = 4096
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    t0 = time.perf_counter()
    try:
        out = txn_stress.run(
            str(tmp_path / "db"), _crash, platform="cpu", config=cfg,
            w_rows=160_000, batch=4_000, u_rows=20_000, updates=10, txns=6,
            txn_rows=4_000, autocheckpoint=4096, checkpoint_pause_s=0.01,
            timeout_s=15.0)
    finally:
        sys.setswitchinterval(interval)
    assert time.perf_counter() - t0 < 20.0
    assert out["rows"]["w"] == 160_000 and out["rows"]["u"] == 20_000
    assert out["auto_checkpoints"] >= 1 and out["conflicts"] == 6
    assert out["checkpoints"] + out["refused"] >= 1
    assert out["wal_bytes"] > 0 and out["scan_agg"] == 1
