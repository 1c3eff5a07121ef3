"""The port's host task scheduler and inter-query concurrency, against the
JAX package: the twins of tests/test_scheduler.py.

Each scenario runs on both packages (the JAX package on its CPU backend,
the port with platform="cpu") and returns its answers, which must be equal
across the packages and equal to numpy's. Tolerance: every answer is an
integer and must match exactly; the scheduler's outputs are compared as
Python lists."""

import threading

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu.parallel.scheduler import TaskScheduler as JTaskScheduler
from adacom_tpu_torch.parallel.scheduler import TaskScheduler

PKGS = {"jax": adacom_tpu, "port": adacom_tpu_torch}
JOIN_S = 300  # a thread still running after this is a hang
SCHEDULERS = {"jax": JTaskScheduler, "port": TaskScheduler}


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


def _db(pkg, n=200_000, segment_rows=8192):
    cfg = pkg.DBConfig()
    cfg.segment_rows = segment_rows
    kw = {"platform": "cpu"} if pkg is adacom_tpu_torch else {}
    db = pkg.Database(config=cfg, **kw)
    con = db.connect()
    con.query("CREATE TABLE t(i BIGINT, g INTEGER)")
    app = con.appender("t")
    v = np.arange(n, dtype=np.int64)
    app.append_columns({"i": v, "g": (v % 17).astype(np.int32)})
    app.close()
    return db, con, n


def _parallel_host_scan_matches_serial(pkg):
    db, con, n = _db(pkg)
    sql = "SELECT SUM(i) FROM (SELECT i FROM t WHERE i % 3 = 1) q"
    con.query("SET threads = 1")
    serial = int(con.query(sql).scalar())
    con.query("SET threads = 8")
    parallel = int(con.query(sql).scalar())
    v = np.arange(n)
    assert serial == parallel == int(v[v % 3 == 1].sum())
    db.close()
    return [serial, parallel]


def _interquery_concurrency(pkg):
    db, con, n = _db(pkg, n=100_000)
    errors, results = [], {}

    def worker(k):
        c = db.connect()
        try:
            for _ in range(5):
                got = c.query(f"SELECT COUNT(*), SUM(i) FROM t WHERE g = {k}"
                              ).fetchall()
                results.setdefault(k, []).append(
                    [tuple(int(x) for x in r) for r in got])
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), f"{t.name} did not finish"
    assert not errors
    v = np.arange(n)
    for k, runs in results.items():
        m = v % 17 == k
        assert runs == [[(int(m.sum()), int(v[m].sum()))]] * 5, k
    db.close()
    return sorted(results.items())


def _concurrent_read_while_compacting(pkg):
    db, con, n = _db(pkg, n=150_000)
    cat = db.catalog.get_column_segment_catalog()
    stop = threading.Event()
    errors = []

    def compact_loop():
        try:
            while not stop.is_set():
                cat.compact_all_segments()
                for t in db.catalog.tables.values():
                    t.uncompact_all()
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    bg = threading.Thread(target=compact_loop)
    bg.start()
    got = []
    try:
        for _ in range(10):
            got.append(int(con.query(
                "SELECT COUNT(*) FROM t WHERE i < 1000").scalar()))
    finally:
        stop.set()
        bg.join(JOIN_S)
    assert not bg.is_alive(), "the compaction thread did not stop"
    assert not errors
    assert got == [1000] * 10
    db.close()
    return got


TWINS = {f.__name__.lstrip("_"): f for f in (
    _parallel_host_scan_matches_serial, _interquery_concurrency,
    _concurrent_read_while_compacting)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_of_test_scheduler(name):
    got = {k: TWINS[name](pkg) for k, pkg in PKGS.items()}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("threads", [1, 8])
def test_scheduler_order_preserved(threads):
    items = list(range(100))
    got = {k: s.get().map_segments(lambda x: x * x, items, threads=threads)
           for k, s in SCHEDULERS.items()}
    assert got["port"] == got["jax"] == [x * x for x in items]


def test_scheduler_exception_propagates():
    def boom(x):
        if x == 37:
            raise ValueError("morsel 37")
        return x

    for sched in SCHEDULERS.values():
        with pytest.raises(ValueError, match="morsel 37"):
            sched.get().map_segments(boom, list(range(64)), threads=8)
