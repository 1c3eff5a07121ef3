"""Durability of the port (WAL, replay, checkpoint, reopen) against the JAX
package.

The twins of tests/test_wal.py run each scenario on both packages (the JAX
package on its CPU backend, the port with platform="cpu") in directories of
their own, and the answers must be equal: floats within 1e-12 relative,
everything else exact. Beyond them: a checkpoint and a WAL written by either
package open in the other; TPC-H at SF 0.01 loaded durably, compacted,
checkpointed and reopened answers as the in-memory port does; DELETE and
UPDATE ... WHERE on the generic device path reach the WAL; a tail torn
inside a transaction replays none of it in the port and the records
before the tear in the JAX package;
a checkpoint with short segments mid-table restores its deletes (the JAX
package raises there, so the port is held against numpy)."""

import importlib
import math
import os

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu_torch.bench import tpch
from adacom_tpu_torch.exec import device_scan


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


PKGS = {"jax": adacom_tpu, "port": adacom_tpu_torch}


def _open(pkg, path, **cfg_kw):
    cfg = pkg.DBConfig()
    cfg.segment_rows = 4096
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    kw = {"platform": "cpu"} if pkg is adacom_tpu_torch else {}
    db = pkg.Database(path=str(path), config=cfg, **kw)
    return db, db.connect()


def _crash(db):
    """Simulate a crash: drop the handle without checkpointing."""
    if db.wal is not None:
        db.wal.close()
    db.catalog.shutdown()
    db._closed = True


def _norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None or isinstance(v, str):
                nr.append(v)
            elif isinstance(v, (float, np.floating)):
                nr.append(float(v))
            elif isinstance(v, (bool, int, np.integer, np.bool_)):
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return out


def _equal(got, want, what=""):
    got, want = _norm(got), _norm(want)
    assert len(got) == len(want), (what, got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w), (what, g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert a is not None and b is not None and math.isclose(
                    a, b, rel_tol=1e-12, abs_tol=0.0), (what, g, w)
            else:
                assert a == b, (what, g, w)


def _abort_class(pkg):
    return importlib.import_module(
        f"{pkg.__name__}.main.database").CheckpointAbort


# ======================================================================
# twins of tests/test_wal.py: the same steps on both packages
# ======================================================================


def _replay_after_crash(pkg, d):
    db, con = _open(pkg, d)
    con.query("CREATE TABLE t(i INTEGER, s VARCHAR)")
    con.query("INSERT INTO t VALUES (1, 'a'), (2, 'b'), (3, 'c')")
    con.query("CREATE VIEW v AS SELECT i FROM t WHERE i > 1")
    _crash(db)  # no checkpoint: only the WAL survives
    db, con = _open(pkg, d)
    out = [con.query("SELECT i, s FROM t ORDER BY i").fetchall(),
           con.query("SELECT COUNT(*) FROM v").fetchall()]
    assert _norm(out[0]) == [(1, "a"), (2, "b"), (3, "c")]
    db.close()
    return out


def _checkpoint_then_wal_tail(pkg, d):
    db, con = _open(pkg, d)
    con.query("CREATE TABLE t(i BIGINT)")
    app = con.appender("t")
    app.append_column("i", np.arange(10_000, dtype=np.int64))
    app.close()
    con.query("CHECKPOINT")
    assert db.wal.size() == 0  # truncated
    con.query("INSERT INTO t VALUES (123456)")  # post-checkpoint tail
    _crash(db)
    db, con = _open(pkg, d)
    out = [con.query("SELECT COUNT(*), MAX(i), SUM(i) FROM t").fetchall()]
    assert _norm(out[0]) == [(10_001, 123456, 49_995_000 + 123456)]
    db.close()
    return out


def _delete_update_replay(pkg, d):
    db, con = _open(pkg, d)
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (1), (2), (3), (4), (5)")
    con.query("DELETE FROM t WHERE i = 2")
    con.query("UPDATE t SET i = 40 WHERE i = 4")
    _crash(db)
    db, con = _open(pkg, d)
    out = [con.query("SELECT i FROM t ORDER BY i").fetchall()]
    assert _norm(out[0]) == [(1,), (3,), (5,), (40,)]
    db.close()
    return out


def _rollback_not_durable(pkg, d):
    db, con = _open(pkg, d)
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (1)")
    con.query("BEGIN")
    con.query("INSERT INTO t VALUES (2), (3)")
    con.query("ROLLBACK")
    con.query("BEGIN")
    con.query("INSERT INTO t VALUES (9)")
    con.query("COMMIT")
    _crash(db)
    db, con = _open(pkg, d)
    out = [con.query("SELECT i FROM t ORDER BY i").fetchall()]
    assert _norm(out[0]) == [(1,), (9,)]
    db.close()
    return out


def _torn_tail_record(pkg, d):
    db, con = _open(pkg, d)
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (10), (20)")
    _crash(db)
    # a crash mid-append: a partial record at the tail
    with open(os.path.join(d, "wal.log"), "ab") as f:
        f.write(b"\xff\xff\xff\xff\x00\x00\x00\x00partial")
    db, con = _open(pkg, d)
    out = [con.query("SELECT COUNT(*), SUM(i) FROM t").fetchall()]
    assert _norm(out[0]) == [(2, 30)]
    db.close()
    return out


def _checkpoint_abort_recovers(pkg, d):
    db, con = _open(pkg, d)
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (7), (8)")
    con.query("CHECKPOINT")
    con.query("INSERT INTO t VALUES (9)")
    con.query("SET debug_checkpoint_abort = 'before_header'")
    with pytest.raises(_abort_class(pkg)):
        con.query("CHECKPOINT")
    _crash(db)
    # the aborted checkpoint is invisible: old checkpoint + WAL
    db, con = _open(pkg, d)
    out = [con.query("SELECT i FROM t ORDER BY i").fetchall(),
           [(db._read_current(),)]]
    assert _norm(out[0]) == [(7,), (8,), (9,)]
    db.close()
    return out


def _autocheckpoint_threshold(pkg, d):
    db, con = _open(pkg, d, wal_autocheckpoint=2_000)
    con.query("CREATE TABLE t(i BIGINT)")
    sizes = []
    for k in range(6):
        con.query(f"INSERT INTO t VALUES ({k})")
        sizes.append((k, db._ckpt_seq))
    # the WAL was checkpoint-truncated at least once
    assert db.wal.size() < 2_000 + 600
    assert db._read_current() is not None
    _crash(db)
    db, con = _open(pkg, d)
    out = [con.query("SELECT COUNT(*), SUM(i) FROM t").fetchall(), sizes]
    assert _norm(out[0]) == [(6, 15)]
    db.close()
    return out


def _checkpoint_restores_deletes(pkg, d):
    db, con = _open(pkg, d)
    con.query("CREATE TABLE t(i INTEGER)")
    app = con.appender("t")
    app.append_column("i", np.arange(20_000, dtype=np.int32))
    app.close()
    con.query("DELETE FROM t WHERE i % 1000 = 7")
    db.close()  # checkpoints
    db, con = _open(pkg, d)
    out = [con.query("SELECT COUNT(*), SUM(i) FROM t").fetchall(),
           con.query("SELECT COUNT(*) FROM t WHERE i = 1007").fetchall(),
           con.query("SELECT COUNT(*) FROM t WHERE i = 1008").fetchall()]
    assert _norm(out[0])[0][0] == 20_000 - 20
    assert _norm(out[1] + out[2]) == [(0,), (1,)]
    db.close()
    return out


def _close_checkpoints_and_reopen(pkg, d):
    db, con = _open(pkg, d)
    con.query("CREATE TABLE t(i INTEGER, x DOUBLE)")
    app = con.appender("t")
    app.append_columns({"i": np.arange(9_000, dtype=np.int32),
                        "x": np.round(np.arange(9_000) * 0.25, 2)})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    db.close()
    assert os.path.exists(os.path.join(d, "CURRENT"))
    db, con = _open(pkg, d)
    out = [con.query("SELECT COUNT(*), SUM(x), SUM(i) FROM t").fetchall()]
    assert abs(_norm(out[0])[0][1]
               - np.round(np.arange(9_000) * 0.25, 2).sum()) < 1e-6
    db.close()
    return out


def _truncate_replay(pkg, d):
    db, con = _open(pkg, d)
    con.query("CREATE TABLE t(i BIGINT)")
    con.query("CREATE UNIQUE INDEX ui ON t(i)")
    con.query("INSERT INTO t VALUES (1), (2), (3)")
    con.query("DELETE FROM t")
    con.query("INSERT INTO t VALUES (9)")
    _crash(db)
    db, con = _open(pkg, d)
    out = [con.query("SELECT i FROM t").fetchall()]
    assert _norm(out[0]) == [(9,)]
    assert db.catalog.get_table("t").index_on("i") is not None
    with pytest.raises(Exception):  # UNIQUE still enforced after replay
        con.query("INSERT INTO t VALUES (9)")
    db.close()
    return out


TWINS = {f.__name__.lstrip("_"): f for f in (
    _replay_after_crash, _checkpoint_then_wal_tail, _delete_update_replay,
    _rollback_not_durable, _torn_tail_record, _checkpoint_abort_recovers,
    _autocheckpoint_threshold, _checkpoint_restores_deletes,
    _close_checkpoints_and_reopen, _truncate_replay)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_of_test_wal(name, tmp_path):
    got = {k: TWINS[name](pkg, str(tmp_path / k)) for k, pkg in PKGS.items()}
    assert len(got["port"]) == len(got["jax"])
    for a, b in zip(got["port"], got["jax"]):
        _equal(a, b, name)


# ======================================================================
# one package writes, the other opens
# ======================================================================


def _fill(con, n=10_000):
    """Strings with NULLs, DECIMAL, DOUBLE, DATE and integers, and a
    view."""
    rng = np.random.default_rng(0xD0AB)
    con.query("CREATE TABLE f(k INTEGER, g BIGINT, p DECIMAL(12,2), "
              "x DOUBLE, d DATE, s VARCHAR)")
    s = np.asarray([f"s{v}" for v in rng.integers(0, 40, n)], dtype=object)
    s_valid = rng.random(n) > 0.1
    g_valid = rng.random(n) > 0.05
    app = con.appender("f")
    app.append_columns(
        {"k": np.arange(n, dtype=np.int32),
         "g": rng.integers(-50, 50, n).astype(np.int64),
         "p": rng.integers(0, 10**6, n).astype(np.int64),
         "x": np.round(rng.random(n) * 100, 3),
         "d": rng.integers(8000, 10000, n).astype(np.int32),
         "s": s},
        {"s": s_valid, "g": g_valid})
    app.close()
    con.query("CREATE TABLE e(i INTEGER)")
    con.query("INSERT INTO e VALUES (1), (2)")
    con.query("CREATE VIEW fv AS SELECT s, count(*) AS n FROM f GROUP BY s")


def _index(con):
    """Three indexes, made after the UPDATEs of f. f's are not UNIQUE: in
    the JAX package a UNIQUE index built over deleted rows counts them, so
    it would raise on f's (the port's skips them)."""
    con.query("CREATE INDEX fk ON f(k)")
    con.query("CREATE INDEX fg ON f(g)")
    con.query("CREATE UNIQUE INDEX eu ON e(i)")


ANSWERS = [
    "SELECT count(*), sum(k), sum(g), count(g), sum(p), sum(x), min(d), "
    "max(d) FROM f",
    "SELECT s, count(*), sum(p) FROM f GROUP BY s ORDER BY s NULLS LAST",
    "SELECT * FROM fv ORDER BY s NULLS LAST",
    "SELECT k, g, s FROM f WHERE k = 4242",
    "SELECT g, count(*) FROM f WHERE g = 7 GROUP BY g",
    "SELECT count(*), sum(i) FROM e",
]


def _answers(con):
    return [con.query(sql).fetchall() for sql in ANSWERS]


# ANSWERS[1:3] group by f.s, which holds NULLs, and the JAX package puts a
# NULL key's rows in the group of the value stored under it (ROADMAP queue
# C). Across packages they are held as the rows they group (ROWS, equal in
# both) and the port's answers against sqlite on those rows; the other
# package's answers must name the same non-NULL groups.
NULL_GROUPED = (1, 2)
ROWS = "SELECT s, p FROM f ORDER BY k"


def _sqlite_grouped(rows):
    import sqlite3

    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE f(s TEXT, p REAL)")
    lite.executemany("INSERT INTO f VALUES (?, ?)", rows)
    return {1: lite.execute(ANSWERS[1]).fetchall(),
            2: lite.execute("SELECT s, count(*) AS n FROM f GROUP BY s "
                            "ORDER BY s NULLS LAST").fetchall()}


def _equal_across(got, want, port, rows):
    """got (the reader's ANSWERS) equal want (the writer's), except the
    NULL_GROUPED ones: port's (the port side's answers) equal sqlite's on
    rows, and both sides give the same non-NULL groups."""
    lite = _sqlite_grouped(_norm(rows))
    for i, (sql, g, w) in enumerate(zip(ANSWERS, got, want)):
        if i in NULL_GROUPED:
            _equal(port[i], lite[i], sql)
            assert sorted(r[0] for r in g if r[0] is not None) == \
                sorted(r[0] for r in w if r[0] is not None), sql
        else:
            _equal(g, w, sql)


def _layout(db):
    """Per table: segment (count, state, codec, reads), the delete masks,
    views and index definitions."""
    out = {}
    for tname, t in sorted(db.catalog.tables.items()):
        t.flush()
        segs = {c: [(s.count, s.state, s.codec, s.num_reads)
                    for s in t.columns[c].segments] for c in t.column_order}
        dels = {k: np.flatnonzero(v).tolist()
                for k, v in sorted(t._deletes.items())}
        out[tname] = (segs, dels)
    return (out, dict(db.catalog.views),
            sorted(sorted(i.to_def().items())
                   for i in db.catalog.indexes.values()))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoint_opens_in_the_other_package(writer, reader, tmp_path):
    d = str(tmp_path / "db")
    db, con = _open(PKGS[writer], d)
    _fill(con)
    con.query("DELETE FROM f WHERE k % 97 = 3")
    con.query("PRAGMA compact_all_segments")
    con.query("SET compression_codec='auto'")
    con.query("UPDATE f SET x = x + 1 WHERE k < 300")  # a few new segments
    con.query("PRAGMA compact_all_segments")
    _index(con)
    want = _answers(con)
    rows = con.query(ROWS).fetchall()
    db.close()  # the checkpoint
    db, con = _open(PKGS[writer], d)
    layout = _layout(db)
    _crash(db)
    db, con = _open(PKGS[reader], d)
    got_layout = _layout(db)
    assert got_layout == layout
    states = {st for segs, _d in layout[0].values() for c in segs.values()
              for (_n, st, _c, _r) in c}
    codecs = {cd for segs, _d in layout[0].values() for c in segs.values()
              for (_n, _s, cd, _r) in c}
    assert states == {"packed", "plain"} and len(codecs - {None}) >= 2
    got = _answers(con)
    _equal(con.query(ROWS).fetchall(), rows, ROWS)
    _equal_across(got, want, got if reader == "port" else want, rows)
    db.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_wal_replays_in_the_other_package(writer, reader, tmp_path):
    d = str(tmp_path / "db")
    db, con = _open(PKGS[writer], d)
    _fill(con)
    con.query("INSERT INTO f VALUES (20000, NULL, 1.25, 2.5, DATE "
              "'1999-01-01', NULL)")
    con.query("DELETE FROM f WHERE k % 89 = 5")
    con.query("UPDATE f SET g = g * 2 WHERE k BETWEEN 100 AND 120")
    con.query("DELETE FROM e")
    con.query("INSERT INTO e VALUES (5)")
    con.query("CREATE VIEW ev AS SELECT i FROM e")
    _index(con)
    con.query("DROP INDEX fg")
    want = _answers(con) + [con.query("SELECT * FROM ev").fetchall()]
    rows = con.query(ROWS).fetchall()
    assert db._read_current() is None  # everything is in the WAL
    _crash(db)
    db, con = _open(PKGS[reader], d)
    got = _answers(con) + [con.query("SELECT * FROM ev").fetchall()]
    _equal(con.query(ROWS).fetchall(), rows, ROWS)
    _equal_across(got, want, got if reader == "port" else want, rows)
    _equal(got[-1], want[-1])
    assert sorted(db.catalog.indexes) == ["eu", "fk"]
    with pytest.raises(Exception):  # the replayed UNIQUE index holds
        con.query("INSERT INTO e VALUES (5)")
    db.close()


# ======================================================================
# the port alone and the faults found
# ======================================================================


def test_tpch_durable_reopen_equals_in_memory(tmp_path):
    data = tpch.generate(0.01)
    mem = adacom_tpu_torch.Database(platform="cpu")
    mcon = mem.connect()
    tpch.load_into_engine(mcon, data)
    mcon.query("PRAGMA compact_all_segments")
    want = {q: mcon.query(sql).fetchall() for q, sql in tpch.QUERIES.items()}
    mem.close()

    d = str(tmp_path / "tpch")
    db = adacom_tpu_torch.Database(path=d, platform="cpu")
    con = db.connect()
    tpch.load_into_engine(con, data)
    assert db.wal.size() > 0
    con.query("PRAGMA compact_all_segments")
    con.query("CHECKPOINT")
    assert db.wal.size() == 0
    states = con.query("PRAGMA compression_info").fetchall()
    db.close()
    db = adacom_tpu_torch.Database(path=d, platform="cpu")
    con = db.connect()
    assert _norm(con.query("PRAGMA compression_info").fetchall()) == \
        _norm(states)
    for q, sql in sorted(tpch.QUERIES.items()):
        _equal(con.query(sql).fetchall(), want[q], f"Q{q}")
    db.close()


def test_dml_on_the_generic_device_path_reaches_the_wal(tmp_path):
    """DELETE/UPDATE ... WHERE over packed segments run on the port's
    generic device path (CPU tensors here) and replay in both packages."""
    rows = {}
    for name, pkg in PKGS.items():
        d = str(tmp_path / name)
        db, con = _open(pkg, d)
        con.query("CREATE TABLE t(k BIGINT, v INTEGER, x DOUBLE)")
        n = 20_000
        app = con.appender("t")
        app.append_columns({"k": np.arange(n, dtype=np.int64),
                            "v": (np.arange(n) % 13).astype(np.int32),
                            "x": np.arange(n) * 0.5})
        app.close()
        con.query("PRAGMA compact_all_segments")
        device_scan.RUNS = 0
        con.query("DELETE FROM t WHERE k % 7 = 3 AND x > 100.0")
        con.query("UPDATE t SET v = v + 100 WHERE v = 5 AND k < 15000")
        if pkg is adacom_tpu_torch:
            assert device_scan.RUNS >= 2  # both WHEREs ran on the device
        live = con.query("SELECT count(*), sum(k), sum(v), sum(x) FROM t"
                         ).fetchall()
        _crash(db)
        db, con = _open(pkg, d)
        rows[name] = con.query("SELECT count(*), sum(k), sum(v), sum(x) "
                               "FROM t").fetchall()
        _equal(rows[name], live, name)
        db.close()
    _equal(rows["port"], rows["jax"])


def test_tail_torn_inside_a_transaction_replays_its_prefix(tmp_path):
    """An UPDATE in a transaction logs its deletes, then the new rows; a
    tail torn in the last record. The JAX package's records carry no
    commit marker, so it replays the prefix: the deletes without the rows.
    The port writes a marker before the transaction's records and replays
    none of a torn one (storage/wal.py)."""
    got = {}
    for name, pkg in PKGS.items():
        d = str(tmp_path / name)
        db, con = _open(pkg, d)
        con.query("CREATE TABLE t(i INTEGER)")
        app = con.appender("t")
        app.append_column("i", np.arange(10_000, dtype=np.int32))
        app.close()
        con.query("BEGIN")
        con.query("UPDATE t SET i = i + 100000 WHERE i >= 9000")
        con.query("COMMIT")
        size = db.wal.size()
        _crash(db)
        with open(os.path.join(d, "wal.log"), "r+b") as f:
            f.truncate(size - 5)
        db, con = _open(pkg, d)
        got[name] = con.query("SELECT count(*), max(i) FROM t").fetchall()
        db.close()
    assert _norm(got["port"]) == [(10_000, 9_999)]
    assert _norm(got["jax"]) == [(9_000, 8_999)]


def test_short_segments_mid_table_keep_their_deletes(tmp_path):
    """A transaction's appends start fresh segments, so a table has short
    segments mid-table; the checkpoint keys deletes by segment index. The
    port restores each stored segment as one segment (numpy is the
    oracle); the JAX package restages them and its restore raises."""
    vals = np.arange(10_000, dtype=np.int32)
    for name, pkg in PKGS.items():
        d = str(tmp_path / name)
        db, con = _open(pkg, d)
        con.query("CREATE TABLE t(i INTEGER)")
        app = con.appender("t")
        app.append_column("i", vals[:5000])
        app.close()
        con.query("BEGIN")
        app = con.appender("t")
        app.append_column("i", vals[5000:])
        app.close()
        con.query("COMMIT")
        con.query("DELETE FROM t WHERE i >= 9000 OR i % 1000 = 1")
        counts = [s.count for s in db.catalog.get_table("t").columns["i"]
                  .segments]
        assert counts == [4096, 904, 4096, 904]
        db.close()
        if pkg is adacom_tpu:
            with pytest.raises(IndexError):
                _open(pkg, d)
            continue
        db, con = _open(pkg, d)
        keep = vals[(vals < 9000) & (vals % 1000 != 1)]
        assert [s.count for s in db.catalog.get_table("t").columns["i"]
                .segments] == counts
        assert _norm(con.query("SELECT count(*), sum(i), max(i) FROM t")
                     .fetchall()) == [(len(keep), int(keep.sum()), 8999)]
        db.close()
