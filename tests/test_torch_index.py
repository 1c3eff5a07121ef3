"""The port's indexes against the JAX package: the twins of
tests/test_index.py.

Each scenario runs on both packages (the JAX package on its CPU backend,
the port with platform="cpu") on the same seeded data: point lookups
through CREATE INDEX, UNIQUE and PRIMARY KEY enforcement, an index after
deletes and after a reopen, the range-lookup API, composite indexes and
the index join. It returns its answers (rows, hit lists as sorted global
row numbers, which constraint raised), which must be equal across the
packages, and holds them against numpy as the reference test does.
Tolerance: every answer is an integer, a string or a bool, compared
exactly."""

import importlib

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


def _db(pkg, segment_rows=4096, path=None):
    cfg = pkg.DBConfig()
    cfg.segment_rows = segment_rows
    kw = {"platform": "cpu"} if pkg is adacom_tpu_torch else {}
    db = pkg.Database(path=path, config=cfg, **kw)
    return db, db.connect()


def _sql_error(pkg):
    return importlib.import_module(f"{pkg.__name__}.main.connection").SQLError


def _rows(res):
    return [tuple(int(v) if isinstance(v, (int, np.integer)) else v
                  for v in r) for r in res.fetchall()]


def _global_rows(hits, segment_rows):
    """An index's [(segment, rows)] hits as sorted global row numbers."""
    if not hits:
        return []
    return sorted(int(x) for si, rows in hits
                  for x in np.asarray(rows) + si * segment_rows)


def _create_index_and_lookup(pkg, _path):
    db, con = _db(pkg)
    con.query("CREATE TABLE t(i BIGINT, x INTEGER)")
    keys = np.random.default_rng(4).permutation(30_000).astype(np.int64)
    app = con.appender("t")
    app.append_columns({"i": keys, "x": (keys % 7).astype(np.int32)})
    app.close()
    con.query("CREATE INDEX idx_i ON t(i)")
    out = []
    for probe in (0, 17, 29_999, 12_345):
        r = _rows(con.query(f"SELECT i, x FROM t WHERE i = {probe}"))
        assert r == [(probe, probe % 7)], (probe, r)
        out.append(r)
    out.append(_rows(con.query("SELECT i FROM t WHERE i = -5")))
    assert out[-1] == []
    con.query("DROP INDEX idx_i")
    out.append(_rows(con.query("SELECT i FROM t WHERE i = 17")))
    assert out[-1] == [(17,)]
    db.close()
    return out


def _unique_index_rejects_duplicates(pkg, _path):
    db, con = _db(pkg)
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (1), (2), (3)")
    con.query("CREATE UNIQUE INDEX u ON t(i)")
    for sql in ("INSERT INTO t VALUES (2)", "INSERT INTO t VALUES (7), (7)"):
        with pytest.raises(_sql_error(pkg), match="duplicate"):
            con.query(sql)
    con.query("INSERT INTO t VALUES (4)")
    out = _rows(con.query("SELECT i FROM t ORDER BY i"))
    assert out == [(1,), (2,), (3,), (4,)]
    db.close()
    return out


def _unique_index_existing_duplicates_rejected(pkg, _path):
    db, con = _db(pkg)
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (1), (1)")
    with pytest.raises(_sql_error(pkg), match="duplicate"):
        con.query("CREATE UNIQUE INDEX u ON t(i)")
    out = [db.catalog.get_table("t").index_on("i") is None,
           _rows(con.query("SELECT count(*) FROM t"))]
    db.close()
    return out


def _primary_key_constraint(pkg, _path):
    db, con = _db(pkg)
    con.query("CREATE TABLE t(id INTEGER PRIMARY KEY, v VARCHAR)")
    con.query("INSERT INTO t VALUES (1, 'a'), (2, 'b')")
    with pytest.raises(_sql_error(pkg), match="duplicate"):
        con.query("INSERT INTO t VALUES (1, 'dup')")
    # the table-level constraint
    con.query("CREATE TABLE t2(a INTEGER, b INTEGER, PRIMARY KEY (a))")
    con.query("INSERT INTO t2 VALUES (5, 6)")
    with pytest.raises(_sql_error(pkg), match="duplicate"):
        con.query("INSERT INTO t2 VALUES (5, 9)")
    out = [_rows(con.query("SELECT id, v FROM t ORDER BY id")),
           _rows(con.query("SELECT a, b FROM t2"))]
    assert out == [[(1, "a"), (2, "b")], [(5, 6)]]
    db.close()
    return out


def _index_with_deletes(pkg, _path):
    db, con = _db(pkg)
    con.query("CREATE TABLE t(i INTEGER)")
    app = con.appender("t")
    app.append_column("i", np.arange(10_000, dtype=np.int32))
    app.close()
    con.query("CREATE INDEX idx ON t(i)")
    con.query("DELETE FROM t WHERE i = 777")
    out = [int(con.query(f"SELECT COUNT(*) FROM t WHERE i = {v}").scalar())
           for v in (777, 778)]
    assert out == [0, 1]
    db.close()
    return out


def _index_survives_reopen(pkg, path):
    db, con = _db(pkg, path=path)
    con.query("CREATE TABLE t(i INTEGER PRIMARY KEY)")
    con.query("INSERT INTO t VALUES (1), (2)")
    db.close()
    db2, con2 = _db(pkg, path=path)
    assert "pk_t_i" in db2.catalog.indexes
    with pytest.raises(_sql_error(pkg), match="duplicate"):
        con2.query("INSERT INTO t VALUES (2)")
    con2.query("INSERT INTO t VALUES (3)")
    out = [sorted(db2.catalog.indexes),
           _rows(con2.query("SELECT i FROM t ORDER BY i"))]
    db2.close()
    return out


def _index_range_lookup_api(pkg, _path):
    db, con = _db(pkg)
    con.query("CREATE TABLE t(i INTEGER)")
    vals = np.random.default_rng(9).permutation(20_000).astype(np.int32)
    app = con.appender("t")
    app.append_column("i", vals)
    app.close()
    idx = db.catalog.create_index("r", "t", "i")
    hits = idx.lookup_range(100, 199)
    assert sum(len(rows) for _, rows in hits) == 100
    table = db.catalog.get_table("t")
    for seg_idx, rows in hits:
        got = table.columns["i"].segments[seg_idx]._host_compute_values()[rows]
        assert ((got >= 100) & (got <= 199)).all()
    out = _global_rows(hits, 4096)
    assert out == sorted(np.nonzero((vals >= 100) & (vals <= 199))[0]
                         .tolist())
    db.close()
    return out


def _composite_index_eq_lookup(pkg, _path):
    """CREATE INDEX over (a, b): composite equality probes."""
    db, con = _db(pkg, 2048)
    con.query("CREATE TABLE t(a INTEGER, b INTEGER, p INTEGER)")
    rng = np.random.default_rng(5)
    a = rng.integers(0, 50, 10_000).astype(np.int32)
    b = rng.integers(0, 40, 10_000).astype(np.int32)
    app = con.appender("t")
    app.append_columns({"a": a, "b": b,
                        "p": np.arange(10_000, dtype=np.int32)})
    app.close()
    con.query("CREATE INDEX iab ON t(a, b)")
    idx = db.catalog.get_table("t").index_on_columns(["a", "b"])
    assert idx is not None and idx.composite
    out = []
    for key in ((7, 13), (0, 0), (49, 39), (51, 1)):
        got = _global_rows(idx.lookup_eq(key), 2048)
        assert got == np.nonzero((a == key[0]) & (b == key[1]))[0].tolist()
        out.append(got)
    out.append(_rows(con.query("SELECT p FROM t WHERE a = 7 AND b = 13 "
                               "ORDER BY p")))
    db.close()
    return out


def _index_join_probes_instead_of_scanning(pkg, _path):
    """A small probe side joined to an indexed big side runs the index
    join."""
    db, con = _db(pkg)
    con.query("CREATE TABLE big(k INTEGER, v BIGINT)")
    rng = np.random.default_rng(6)
    k = rng.permutation(200_000).astype(np.int32)
    v = rng.integers(0, 1 << 40, 200_000)
    app = con.appender("big")
    app.append_columns({"k": k, "v": v})
    app.close()
    con.query("CREATE INDEX bk ON big(k)")
    con.query("CREATE TABLE probe(k INTEGER)")
    pk = rng.integers(0, 400_000, 500).astype(np.int32)
    app = con.appender("probe")
    app.append_column("k", pk)
    app.close()
    r = _rows(con.query("SELECT count(*), sum(b.v) FROM probe p JOIN big b "
                        "ON p.k = b.k"))
    assert db.dist_stats.get("index_join", 0) > 0, "index join did not run"
    lut = dict(zip(k.tolist(), v.tolist()))
    exp = [lut[x] for x in pk.tolist() if x in lut]
    assert r == [(len(exp), sum(exp))]
    db.close()
    return r


TWINS = {f.__name__.lstrip("_"): f for f in (
    _create_index_and_lookup, _unique_index_rejects_duplicates,
    _unique_index_existing_duplicates_rejected, _primary_key_constraint,
    _index_with_deletes, _index_survives_reopen, _index_range_lookup_api,
    _composite_index_eq_lookup, _index_join_probes_instead_of_scanning)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_of_test_index(name, tmp_path):
    got = {k: TWINS[name](pkg, str(tmp_path / k)) for k, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
