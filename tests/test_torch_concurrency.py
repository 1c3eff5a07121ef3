"""Concurrent writes and reads in the port, against the JAX package: the
twins of tests/test_concurrency.py.

Each scenario runs on both packages (the JAX package on its CPU backend,
the port with platform="cpu"), asserts the reference test's invariants
inside (readers see consistent prefixes, MVCC visibility, write-write
conflicts, pinned delete-mask versions), and returns its final answers,
which must be equal across the packages. Tolerance: every answer is an
integer count or sum and must match exactly.

The segment race stress runs on the port only: the JAX package's side of
it is its own file's (`test_scan_vs_append_segment_race_stress`). It is
bounded by a number of appends, not by wall time, so a loaded machine
runs the same race."""

import importlib
import threading

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch

PKGS = {"jax": adacom_tpu, "port": adacom_tpu_torch}


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


def _db(pkg, segment_rows=2048):
    cfg = pkg.DBConfig()
    cfg.segment_rows = segment_rows
    kw = {"platform": "cpu"} if pkg is adacom_tpu_torch else {}
    return pkg.Database(config=cfg, **kw)


def _sql_error(pkg):
    return importlib.import_module(f"{pkg.__name__}.main.connection").SQLError


def _ints(row):
    return tuple(None if v is None else int(v) for v in row)


JOIN_S = 300  # a thread still running after this is a hang


def _join(threads):
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), f"{t.name} did not finish"


def _run_threads(targets):
    ts = [threading.Thread(target=f, args=a) for f, a in targets]
    for t in ts:
        t.start()
    _join(ts)


# ======================================================================
# twins: one scenario per reference test, run on each package
# ======================================================================


def _concurrent_appenders_lose_nothing(pkg):
    db = _db(pkg)
    con = db.connect()
    con.query("CREATE TABLE t(i BIGINT)")
    n_threads, per_batch, n_batches = 8, 1000, 10
    errs = []

    def writer(tid):
        try:
            c = db.connect()
            for b_ in range(n_batches):
                app = c.appender("t")
                app.append_column(
                    "i", np.full(per_batch, tid * 1_000_000 + b_, np.int64))
                app.close()
        except Exception as e:  # reported by the assertion below
            errs.append(e)

    _run_threads([(writer, (k,)) for k in range(n_threads)])
    assert not errs
    r = _ints(con.query("SELECT count(*), sum(i) FROM t").fetchone())
    exp = sum(per_batch * (tid * 1_000_000 + b_)
              for tid in range(n_threads) for b_ in range(n_batches))
    assert r == (n_threads * per_batch * n_batches, exp)
    db.close()
    return [r]


def _readers_during_writes_see_consistent_prefixes(pkg):
    db = _db(pkg)
    wcon = db.connect()
    wcon.query("CREATE TABLE t(i BIGINT)")
    stop = threading.Event()
    bad = []

    def reader():
        try:
            c = db.connect()
            last = 0
            while not stop.is_set():
                n, s = _ints(c.query(
                    "SELECT count(*), sum(i) FROM t").fetchone())
                s = s or 0
                # every appended value is 1: a consistent snapshot has
                # s == n, and the row count never goes back
                if s != n or n < last:
                    bad.append((n, s, last))
                    return
                last = n
        except Exception as e:
            bad.append(("reader died", repr(e)))
            raise

    rt = threading.Thread(target=reader)
    rt.start()
    for _ in range(50):
        app = wcon.appender("t")
        app.append_column("i", np.ones(500, np.int64))
        app.close()
    stop.set()
    _join([rt])
    assert not bad, bad[:3]
    out = [_ints(wcon.query("SELECT count(*), sum(i) FROM t").fetchone())]
    assert out == [(25_000, 25_000)]
    db.close()
    return out


def _rollback_under_concurrent_reads(pkg):
    db = _db(pkg)
    wcon = db.connect()
    wcon.query("CREATE TABLE t(i BIGINT)")
    app = wcon.appender("t")
    app.append_column("i", np.arange(5000, dtype=np.int64))
    app.close()
    base_sum = int(np.arange(5000).sum())
    wcon.query("BEGIN TRANSACTION")
    wcon.query("INSERT INTO t VALUES (999999)")
    wcon.query("ROLLBACK")
    out = [_ints(wcon.query("SELECT count(*), sum(i) FROM t").fetchone())]
    assert out[0] == (5000, base_sum)
    wcon.query("BEGIN TRANSACTION")
    wcon.query("INSERT INTO t VALUES (7)")
    wcon.query("COMMIT")
    out.append(_ints(wcon.query("SELECT count(*), sum(i) FROM t").fetchone()))
    assert out[1] == (5001, base_sum + 7)
    db.close()
    return out


def _concurrent_distinct_tables(pkg):
    db = _db(pkg)
    con = db.connect()
    con.query("CREATE TABLE a(i BIGINT)")
    con.query("CREATE TABLE b2(i BIGINT)")
    errs = []

    def w(tname, k):
        try:
            c = db.connect()
            for _ in range(20):
                app = c.appender(tname)
                app.append_column("i", np.full(200, k, np.int64))
                app.close()
        except Exception as e:  # reported by the assertion below
            errs.append(e)

    _run_threads([(w, ("a", 1)), (w, ("b2", 2))])
    assert not errs
    out = [_ints(con.query("SELECT sum(i), count(*) FROM a").fetchone()),
           _ints(con.query("SELECT sum(i), count(*) FROM b2").fetchone())]
    assert out == [(20 * 200, 4000), (2 * 20 * 200, 4000)]
    db.close()
    return out


def _mvcc_reader_sees_only_committed(pkg):
    db = _db(pkg, 1024)
    w, r = db.connect(), db.connect()
    w.query("CREATE TABLE t(i INTEGER)")
    app = w.appender("t")
    app.append_column("i", np.arange(5000, dtype=np.int32))
    app.close()
    counts = ("SELECT count(*) FROM t", "SELECT count(*) FROM t WHERE "
              "i = 111111", "SELECT count(*) FROM t WHERE i < 100")
    out = [[int(r.query(q).scalar()) for q in counts]]
    w.query("BEGIN TRANSACTION")
    w.query("INSERT INTO t VALUES (111111), (222222)")
    w.query("DELETE FROM t WHERE i < 100")
    # the writer sees its own effects, the reader the committed state
    out.append([int(w.query(q).scalar()) for q in counts])
    out.append([int(r.query(q).scalar()) for q in counts])
    w.query("COMMIT")
    out.append([int(r.query(q).scalar()) for q in counts])
    assert out == [[5000, 0, 100], [4902, 1, 0], [5000, 0, 100],
                   [4902, 1, 0]]
    db.close()
    return out


def _mvcc_write_write_conflict(pkg):
    db = _db(pkg)
    a, b = db.connect(), db.connect()
    a.query("CREATE TABLE t(i INTEGER)")
    a.query("INSERT INTO t VALUES (1), (2)")
    a.query("BEGIN TRANSACTION")
    a.query("INSERT INTO t VALUES (3)")
    b.query("BEGIN TRANSACTION")
    with pytest.raises(_sql_error(pkg)):
        b.query("INSERT INTO t VALUES (4)")  # a second writer conflicts
    b.query("ROLLBACK")
    a.query("COMMIT")
    # after the first commit the table is writable again
    b.query("BEGIN TRANSACTION")
    b.query("INSERT INTO t VALUES (5)")
    b.query("COMMIT")
    out = [_ints(r) for r in a.query("SELECT i FROM t ORDER BY i").fetchall()]
    assert out == [(1,), (2,), (3,), (5,)]
    db.close()
    return out


def _mvcc_rollback_restores_and_releases(pkg):
    db = _db(pkg, 1024)
    w, r = db.connect(), db.connect()
    w.query("CREATE TABLE t(i INTEGER)")
    app = w.appender("t")
    app.append_column("i", np.arange(3000, dtype=np.int32))
    app.close()
    w.query("BEGIN TRANSACTION")
    w.query("INSERT INTO t VALUES (9999999)")
    w.query("DELETE FROM t WHERE i >= 2000")
    # 1000 original rows and the fresh 9999999 are deleted
    out = [int(w.query("SELECT count(*) FROM t").scalar())]
    w.query("ROLLBACK")
    for con in (w, r):
        out.append(_ints(con.query(
            "SELECT count(*), sum(i) FROM t").fetchone()))
        assert int(con.query("SELECT count(*) FROM t WHERE i = 9999999"
                             ).scalar()) == 0
    # the table is writable after the rollback
    r.query("BEGIN TRANSACTION")
    r.query("INSERT INTO t VALUES (7)")
    r.query("COMMIT")
    out.append(int(w.query("SELECT count(*) FROM t").scalar()))
    s = int(np.arange(3000).sum())
    assert out == [2000, (3000, s), (3000, s), 3001]
    db.close()
    return out


def _delete_masks_are_pinned_versions(pkg):
    db = _db(pkg)
    wcon = db.connect()
    wcon.query("CREATE TABLE t(i BIGINT)")
    app = wcon.appender("t")
    app.append_column("i", np.arange(20_000, dtype=np.int64))
    app.close()
    stop = threading.Event()
    bad, seen = [], []

    def reader():
        try:
            c = db.connect()
            while not stop.is_set():
                n = int(c.query(
                    "SELECT count(*) FROM t WHERE i >= 0").scalar())
                # deletes come in 1000-row statements: a consistent
                # snapshot counts a multiple of 1000
                seen.append(n)
                if n % 1000 != 0:
                    bad.append(n)
                    return
        except Exception as e:
            bad.append(repr(e))
            raise

    rt = threading.Thread(target=reader)
    rt.start()
    for k in range(0, 20_000, 1000):
        wcon.query(f"DELETE FROM t WHERE i >= {k} AND i < {k + 1000}")
    stop.set()
    _join([rt])
    assert not bad, bad[:3]
    assert seen == sorted(seen, reverse=True)  # never a count back
    out = [int(wcon.query("SELECT count(*) FROM t").scalar())]
    assert out == [0]
    db.close()
    return out


def _concurrent_reader_with_delete_update_mix(pkg):
    db = _db(pkg)
    wcon = db.connect()
    wcon.query("CREATE TABLE t(i BIGINT, v BIGINT)")
    app = wcon.appender("t")
    app.append_columns({"i": np.arange(10_000, dtype=np.int64),
                        "v": np.arange(10_000, dtype=np.int64)})
    app.close()
    stop = threading.Event()
    bad = []

    def reader():
        try:
            c = db.connect()
            while not stop.is_set():
                n = int(c.query("SELECT count(*) FROM t").scalar())
                if not 9_000 <= n <= 10_000:
                    bad.append(("count", n))
                    return
        except Exception as e:
            bad.append(repr(e))
            raise

    rts = [threading.Thread(target=reader) for _ in range(2)]
    for t in rts:
        t.start()
    for k in range(0, 9_000, 1_000):
        wcon.query(f"UPDATE t SET v = v + 1000000 WHERE i >= {k} "
                   f"AND i < {k + 1000}")
    wcon.query("DELETE FROM t WHERE i < 1000")
    stop.set()
    _join(rts)
    assert not bad, bad[:3]
    out = [_ints(wcon.query("SELECT count(*), sum(v) FROM t").fetchone())]
    # the UPDATEs covered i in [0, 9000); 1000..8999 survive with +1e6
    exp = int(np.arange(1000, 10_000).sum()) + 8_000 * 1_000_000
    assert out == [(9_000, exp)]
    db.close()
    return out


TWINS = {f.__name__.lstrip("_"): f for f in (
    _concurrent_appenders_lose_nothing,
    _readers_during_writes_see_consistent_prefixes,
    _rollback_under_concurrent_reads, _concurrent_distinct_tables,
    _mvcc_reader_sees_only_committed, _mvcc_write_write_conflict,
    _mvcc_rollback_restores_and_releases, _delete_masks_are_pinned_versions,
    _concurrent_reader_with_delete_update_mix)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_of_test_concurrency(name):
    got = {k: TWINS[name](pkg) for k, pkg in PKGS.items()}
    assert got["port"] == got["jax"]


# ======================================================================
# the port alone
# ======================================================================


RACE_APPENDS = 400


def test_scan_vs_append_segment_race_stress():
    """A scan pins a TableSnapshot while appends pop and reseal the partial
    tail segment (256-row segments, 100-row batches), and a scan of a
    pinned snapshot re-checks residency under the segment's lock (the race
    repaired in storage/segment.py). Two readers run filtered and
    aggregate scans through RACE_APPENDS appends; no reader may raise,
    and each answer must be a consistent prefix of the appended ones."""
    db = _db(adacom_tpu_torch, 256)
    try:
        wcon = db.connect()
        wcon.query("CREATE TABLE t(i BIGINT)")
        stop = threading.Event()
        bad, scans = [], [0, 0]

        def reader(k):
            try:
                c = db.connect()
                while not stop.is_set():
                    # a filtered scan (zonemap candidates, the host
                    # equality path) and an aggregate scan
                    n1 = int(c.query(
                        "SELECT count(*) FROM t WHERE i = 1").scalar())
                    n, s = _ints(c.query(
                        "SELECT count(*), sum(i) FROM t").fetchone())
                    if n % 100 or (s or 0) != n or n1 % 100 or n1 > n:
                        bad.append((n1, n, s))
                        return
                    scans[k] += 1
            except Exception as e:
                bad.append(repr(e))
                raise

        rts = [threading.Thread(target=reader, args=(k,)) for k in range(2)]
        for t in rts:
            t.start()
        for _ in range(RACE_APPENDS):
            app = wcon.appender("t")
            app.append_column("i", np.ones(100, np.int64))
            app.close()
        stop.set()
        _join(rts)
        assert not bad, bad[:3]
        assert min(scans) > 0, scans
        assert _ints(wcon.query("SELECT count(*), sum(i) FROM t").fetchone()
                     ) == (100 * RACE_APPENDS, 100 * RACE_APPENDS)
    finally:
        db.close()
