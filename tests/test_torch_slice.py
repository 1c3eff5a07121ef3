"""The port's scan -> aggregate slice end to end, against the JAX package:
the same tables and SQL on adacom_tpu.Database() and
adacom_tpu_torch.Database(platform="cpu") must give identical fetchall()."""

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu_torch.ops import fused_scan


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


N = 20_000
SEG_ROWS = 4096  # several segments plus a ragged tail


def _load(mod, **db_kw):
    cfg = mod.DBConfig()
    cfg.segment_rows = SEG_ROWS
    db = mod.Database(config=cfg, **db_kw)
    con = db.connect()
    rng = np.random.default_rng(0xD1CE)
    con.query("CREATE TABLE t1(i UINTEGER)")
    app = con.appender("t1")
    app.append_column("i", np.arange(N, dtype=np.uint32))
    app.close()
    # signed values with NULLs, and a constant block (a width-0 segment)
    con.query("CREATE TABLE t2(i INTEGER)")
    vals = rng.integers(-50_000, 50_000, N).astype(np.int32)
    vals[SEG_ROWS:2 * SEG_ROWS] = 777
    valid = rng.random(N) > 0.25
    valid[SEG_ROWS:2 * SEG_ROWS] = True
    app = con.appender("t2")
    app.append_column("i", vals, valid)
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    return db, con


QUERIES = [
    # the main path: bench.py's full-table aggregate
    "SELECT count(*), sum(i) FROM t1",
    "SELECT count(i), sum(i), min(i), max(i) FROM t1 WHERE i BETWEEN 1234 AND 17777",
    "SELECT count(*), sum(i), min(i), max(i) FROM t1 WHERE i > 500 AND i < 501",
    "SELECT count(*), sum(i), min(i), max(i) FROM t1 WHERE i >= 4000000000",
    "SELECT avg(i), count(*) FROM t1 WHERE i < 9000",
    "SELECT count(*), count(i), sum(i), min(i), max(i) FROM t2",
    "SELECT count(i), sum(i), min(i), max(i) FROM t2 WHERE i >= -100 AND i <= 40000",
    "SELECT count(i), sum(i) FROM t2 WHERE i = 777",
    # point lookups (host latency tier)
    "SELECT i FROM t1 WHERE i == 0",
    "SELECT i FROM t1 WHERE i == 4096",
    "SELECT i FROM t1 WHERE i == 19999",
    "SELECT i FROM t1 WHERE i == 20000",
    "SELECT i FROM t2 WHERE i = 777 LIMIT 3",
    # routed to the host aggregate
    "SELECT count(DISTINCT i) FROM t1 WHERE i < 3000",
    "SELECT i % 5 AS g, count(*), sum(i), min(i) FROM t2 GROUP BY g ORDER BY g",
    "SELECT i FROM t2 WHERE i > 49000 ORDER BY i DESC LIMIT 4",
]


@pytest.fixture(scope="module")
def engines():
    jdb, jcon = _load(adacom_tpu)
    tdb, tcon = _load(adacom_tpu_torch, platform="cpu")
    yield jcon, tcon
    jdb.close()
    tdb.close()


@pytest.mark.parametrize("sql", QUERIES)
def test_same_answers_as_reference(engines, sql):
    jcon, tcon = engines
    ref = jcon.query(sql).fetchall()
    got = tcon.query(sql).fetchall()
    assert got == ref
    assert [tuple(type(x) for x in r) for r in got] == \
        [tuple(type(x) for x in r) for r in ref]


def test_main_path_runs_the_fused_scan(engines, monkeypatch):
    _jcon, tcon = engines
    calls = []
    real = fused_scan.scan_table

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(fused_scan, "scan_table", counting)
    got = tcon.query("SELECT count(*), sum(i) FROM t1").fetchall()
    assert got == [(N, N * (N - 1) // 2)]
    assert len(calls) == 1  # one launch for the one width class
    # a grouped aggregate takes the host tier instead
    tcon.query("SELECT i % 2 AS g, count(*) FROM t1 GROUP BY g").fetchall()
    assert len(calls) == 1


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        adacom_tpu_torch.Database(platform="cuda")
