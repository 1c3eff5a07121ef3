"""The port's segment, column and table storage against the JAX package: the
twins of tests/test_storage.py.

Each scenario builds the same segments or tables from the same seeded
numpy data in both packages (the port's BufferManager on the CPU device)
and returns what it observed: decoded values, footprints, data sizes,
segment counts, packed words and validity words, query answers. The two
packages' observations must be equal. Tolerance: everything here is an
integer, a byte string or a bool, compared exactly; packed words and the
validity bitmap are compared as their uint32 bytes (the vertical-lane
layout is shared). Where the port's API differs, the scenario adapts:
BufferManager(config, device), and the port reads validity words through
`validity_arrays()` where the JAX package has `validity_reader()`.

The reference's `test_dml_fuzz_smoke` runs tools/fuzz_dml.py; its port
twin is tests/test_torch_tools.py's `test_fuzz_dml_matches_sqlite`."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu.ops import bitpack as jbitpack
from adacom_tpu_torch.ops import bitpack as tbitpack

PKGS = {"jax": adacom_tpu, "port": adacom_tpu_torch}
SEED = 0x5EED


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


def _ns(pkg):
    """The storage modules of a package."""
    n = pkg.__name__

    def mod(m):
        return importlib.import_module(f"{n}.{m}")

    return SimpleNamespace(
        pkg=pkg, port=pkg is adacom_tpu_torch, tt=mod("types"),
        DBConfig=mod("config").DBConfig,
        Catalog=mod("catalog.segment_catalog").ColumnSegmentCatalog,
        BufferManager=mod("storage.buffer").BufferManager,
        Segment=mod("storage.segment").ColumnSegment,
        Table=mod("storage.table").Table)


def _mk(ns, config=None):
    config = config or ns.DBConfig(segment_rows=4096)
    bm = ns.BufferManager(config, torch.device("cpu")) if ns.port else \
        ns.BufferManager(config)
    return config, bm, ns.Catalog(config)


def _values(a):
    """A jax array or a torch tensor as numpy."""
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


def _u32(words):
    """Packed words of either package (uint32 in the JAX package, int32
    bit-views in the port) as uint32 numpy."""
    return _values(words).view(np.uint32)


def _packed_words(seg):
    """(plane words as uint32 bytes, widths, min_factor, lanes) of a
    compacted segment, made resident first."""
    if hasattr(seg, "packed"):
        p = seg.packed()
    else:
        seg._ensure_resident()
        p = seg._packed
    return [None if w is None else _u32(w).tobytes() for w in p.words], \
        tuple(p.widths), int(p.min_factor), int(p.n_lanes)


def _db(ns, segment_rows=None, **kw):
    cfg = ns.DBConfig()
    if segment_rows is not None:
        cfg.segment_rows = segment_rows
    if ns.port:
        kw["platform"] = "cpu"
    return ns.pkg.Database(config=cfg, **kw)


# ======================================================================
# twins: one scenario per reference test, run on each package
# ======================================================================


def _segment_compact_roundtrip(ns):
    rng = np.random.default_rng(SEED)
    config, bm, _ = _mk(ns)
    vals = rng.integers(1_000_000, 1_065_536, size=4096, dtype=np.uint32)
    seg = ns.Segment(ns.tt.UINTEGER, vals, config, bm)
    np.testing.assert_array_equal(_values(seg.decoded()), vals)
    assert seg.compact() and seg.is_compacted()
    fp = seg.footprint_bytes()
    assert fp < 4096 * 4 * 0.6  # width 17: about 17/32 of plain
    words = _packed_words(seg)
    np.testing.assert_array_equal(_values(seg.decoded()), vals)
    assert seg.uncompact()
    np.testing.assert_array_equal(_values(seg.decoded()), vals)
    return [fp, words, seg.is_compacted()]


def _segment_constant(ns):
    config, bm, _ = _mk(ns)
    vals = np.full(4096, 7_777_777, dtype=np.uint32)
    seg = ns.Segment(ns.tt.UINTEGER, vals, config, bm)
    seg.compact()
    assert seg.footprint_bytes() == 0  # a constant plane stores nothing
    np.testing.assert_array_equal(_values(seg.decoded()), vals)
    return [seg.footprint_bytes(), _packed_words(seg)]


def _segment_int64_two_planes(ns):
    rng = np.random.default_rng(SEED)
    config, bm, _ = _mk(ns)
    vals = (rng.integers(0, 1 << 40, size=4096, dtype=np.int64)
            + 10_000_000_000).astype(np.int64)
    seg = ns.Segment(ns.tt.BIGINT, vals, config, bm)
    seg.compact()
    np.testing.assert_array_equal(_values(seg.decoded()), vals)
    assert seg.footprint_bytes() < 4096 * 8 * 0.75  # 40 of 64 bits
    return [seg.footprint_bytes(), _packed_words(seg)]


def _segment_signed_negative(ns):
    rng = np.random.default_rng(SEED)
    config, bm, _ = _mk(ns)
    vals = rng.integers(-500, 12_000, size=4096).astype(np.int32)
    seg = ns.Segment(ns.tt.INTEGER, vals, config, bm)
    seg.compact()
    np.testing.assert_array_equal(_values(seg.decoded()), vals)
    assert (seg.vmin, seg.vmax) == (int(vals.min()), int(vals.max()))
    return [seg.vmin, seg.vmax, _packed_words(seg)]


def _segment_fetch_rows(ns):
    rng = np.random.default_rng(SEED)
    config, bm, _ = _mk(ns)
    vals = rng.integers(0, 1 << 20, size=4096, dtype=np.uint32)
    seg = ns.Segment(ns.tt.UINTEGER, vals, config, bm)
    seg.compact()
    idx = rng.integers(0, 4096, size=100)
    got = np.asarray(seg.fetch_rows(idx))
    np.testing.assert_array_equal(got, vals[idx])
    return [got.astype(np.int64).tolist()]


def _segment_nulls(ns):
    rng = np.random.default_rng(SEED)
    config, bm, _ = _mk(ns)
    vals = rng.integers(0, 1000, size=4096, dtype=np.uint32)
    validity = rng.random(4096) > 0.1
    seg = ns.Segment(ns.tt.UINTEGER, vals, config, bm, validity=validity)
    assert seg.null_count == int((~validity).sum())
    if ns.port:
        (words,) = seg.validity_arrays()
        bits = tbitpack.unpack_numpy(_u32(words), 4096, 1)
    else:
        _meta, (words,), decode = seg.validity_reader()
        bits = np.asarray(decode(words))[:4096]
    np.testing.assert_array_equal(bits.astype(bool), validity)
    return [seg.null_count, _u32(words).tobytes()]


def _table_staging_and_segment_alignment(ns):
    rng = np.random.default_rng(SEED)
    config, bm, cat = _mk(ns)
    t = ns.Table("t", [("a", ns.tt.UINTEGER), ("b", ns.tt.BIGINT)], config,
                 bm, cat)
    for _ in range(5):
        t.append_batch({"a": rng.integers(0, 100, 3000).astype(np.uint32),
                        "b": rng.integers(0, 100, 3000).astype(np.int64)})
    assert t.row_count() == 15000
    t.flush()
    assert t.segment_count() == 4  # ceil(15000 / 4096)
    assert t.segment("a", 3).count == 15000 - 3 * 4096
    return [t.row_count(), t.segment_count(),
            [t.segment("a", i).count for i in range(4)],
            [int(_values(t.segment("b", i).decoded()).sum())
             for i in range(4)]]


def _table_unseal_partial_append(ns):
    config, bm, cat = _mk(ns)
    t = ns.Table("t", [("a", ns.tt.UINTEGER)], config, bm, cat)
    t.append_batch({"a": np.arange(100, dtype=np.uint32)})
    t.flush()
    assert t.segment_count() == 1
    t.append_batch({"a": np.arange(100, 200, dtype=np.uint32)})
    t.flush()
    # appended into the same partial segment, not a new one
    assert t.segment_count() == 1
    got = _values(t.segment("a", 0).decoded())
    np.testing.assert_array_equal(got, np.arange(200, dtype=np.uint32))
    return [t.segment_count(), got.astype(np.int64).tolist()]


def _adaptive_policy_step(ns):
    rng = np.random.default_rng(SEED)
    config, bm, cat = _mk(ns)
    t = ns.Table("t", [("a", ns.tt.UINTEGER)], config, bm, cat)
    t.append_batch({"a": rng.integers(0, 1 << 20, 4096 * 10)
                    .astype(np.uint32)})
    t.flush()
    segs = t.columns["a"].segments
    assert len(segs) == 10
    for _ in range(50):  # hot: the last segment read many times
        segs[-1].add_read_access()
    n_c, n_u = cat.compress_lowest_k_segments(rate=0.9)
    assert n_c == 9
    assert not segs[-1].is_compacted()
    assert all(s.is_compacted() for s in segs[:-1])
    assert segs[-1].num_reads == 25  # counters decayed, not reset
    return [n_c, n_u, [s.is_compacted() for s in segs],
            [s.num_reads for s in segs]]


def _memory_limit_paging(ns):
    rng = np.random.default_rng(SEED)
    config = ns.DBConfig(segment_rows=4096)
    config.memory_limit = 4096 * 4 * 3  # room for about 3 plain segments
    config, bm, cat = _mk(ns, config)
    t = ns.Table("t", [("a", ns.tt.UINTEGER)], config, bm, cat)
    t.append_batch({"a": rng.integers(0, 1 << 20, 4096 * 8)
                    .astype(np.uint32)})
    t.flush()
    segs = t.columns["a"].segments
    for _ in range(2):  # scan everything twice: paging keeps the limit
        for s in segs:
            _ = s.decoded()
    assert bm.device_bytes <= config.memory_limit
    sums = []
    for s in segs:
        got = _values(s.decoded())
        np.testing.assert_array_equal(got, s._host_values)
        sums.append(int(got.astype(np.int64).sum()))
    return [bm.device_bytes <= config.memory_limit, sums]


def _data_size_accounting(ns):
    rng = np.random.default_rng(SEED)
    config, bm, cat = _mk(ns)
    t = ns.Table("t", [("a", ns.tt.UINTEGER)], config, bm, cat)
    t.append_batch({"a": rng.integers(0, 1 << 17, 4096 * 4)
                    .astype(np.uint32)})
    t.flush()
    plain = bm.get_data_size()
    assert plain == 4096 * 4 * 4
    t.compact_all()
    packed = bm.get_data_size()
    assert packed < plain and packed == cat.get_total_data_size()
    t.uncompact_all()
    assert bm.get_data_size() == plain
    return [plain, packed, cat.get_total_data_size()]


def _zonemap_fresh_after_tail_reseal(ns):
    """Appending into a partial tail segment re-seals it with new bounds;
    filtered scans see the fresh rows."""
    db = _db(ns, 1024)
    con = db.connect()
    con.query("CREATE TABLE t(a INTEGER)")
    con.query("INSERT INTO t VALUES (100), (101)")
    out = [int(con.query("SELECT count(*) FROM t WHERE a >= 500").scalar())]
    con.query("INSERT INTO t VALUES (900), (901)")
    out.append(int(con.query(
        "SELECT count(*) FROM t WHERE a >= 500").scalar()))
    con.query("DELETE FROM t WHERE a >= 500")
    out.append(int(con.query("SELECT count(*) FROM t").scalar()))
    assert out == [0, 2, 2]
    db.close()
    return out


def _table_snapshot_survives_tail_unseal(ns):
    """A pinned TableSnapshot stays resolvable while the writer pops and
    reseals the partial tail segment."""
    db = _db(ns, 256)
    try:
        con = db.connect()
        con.query("CREATE TABLE t(i BIGINT)")
        app = con.appender("t")
        app.append_column("i", np.ones(300, np.int64))  # 1 full + partial
        app.close()
        table = db.catalog.get_table("t")
        snap = table.read_snapshot()
        n0 = snap.segment_count()
        rows0 = sum(snap.segment_rows(i) for i in range(n0))
        assert rows0 == 300
        for _ in range(10):  # each append pops the partial tail
            a = con.appender("t")
            a.append_column("i", np.ones(10, np.int64))
            a.close()
            table.flush()
        assert snap.segment_count() == n0
        total = sum(int(snap.segment("i", i).host_plain().sum())
                    for i in range(n0))
        assert total == 300
        n = int(con.query("SELECT count(*) FROM t").scalar())
        assert n == 400
        return [n0, rows0, total, n]
    finally:
        db.close()


def _truncate_preserves_indexes_and_unique(ns):
    """DELETE without WHERE keeps indexes live, UNIQUE enforced."""
    db = _db(ns)
    try:
        con = db.connect()
        con.query("CREATE TABLE t(i BIGINT, s VARCHAR)")
        con.query("CREATE UNIQUE INDEX ui ON t(i)")
        con.query("INSERT INTO t VALUES (1, 'a'), (2, 'b')")
        con.query("DELETE FROM t")
        out = [int(con.query("SELECT count(*) FROM t").scalar())]
        assert db.catalog.get_table("t").index_on("i") is not None
        con.query("INSERT INTO t VALUES (7, 'x')")
        with pytest.raises(Exception) as exc:
            con.query("INSERT INTO t VALUES (7, 'y')")
        msg = str(exc.value).lower()
        assert "duplicate" in msg or "unique" in msg or "constraint" in msg
        # the old keys really went: a key from before the truncate is fine
        con.query("INSERT INTO t VALUES (1, 'z')")
        out.append([(int(i), s) for i, s in con.query(
            "SELECT i, s FROM t ORDER BY i").fetchall()])
        assert out == [0, [(1, "z"), (7, "x")]]
        return out
    finally:
        db.close()


TWINS = {f.__name__.lstrip("_"): f for f in (
    _segment_compact_roundtrip, _segment_constant, _segment_int64_two_planes,
    _segment_signed_negative, _segment_fetch_rows, _segment_nulls,
    _table_staging_and_segment_alignment, _table_unseal_partial_append,
    _adaptive_policy_step, _memory_limit_paging, _data_size_accounting,
    _zonemap_fresh_after_tail_reseal, _table_snapshot_survives_tail_unseal,
    _truncate_preserves_indexes_and_unique)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_of_test_storage(name):
    got = {k: TWINS[name](_ns(pkg)) for k, pkg in PKGS.items()}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("width", [1, 7, 17, 31, 32])
def test_packed_words_open_in_the_other_package(width):
    """A segment's packed words from either package decode in the other's
    bitpack to the same values (the layout is shared)."""
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 1 << width, 4096 - 5, dtype=np.uint64) \
        .astype(np.uint32)
    words = {}
    for k, pkg in PKGS.items():
        ns = _ns(pkg)
        config, bm, _ = _mk(ns)
        seg = ns.Segment(ns.tt.UINTEGER, vals, config, bm)
        seg.compact()
        words[k] = _packed_words(seg)
    assert words["port"] == words["jax"]
    (plane,), widths, mf, lanes = words["port"]
    w = np.frombuffer(plane, np.uint32).reshape(widths[0], lanes)
    for unpack in (jbitpack.unpack_numpy, tbitpack.unpack_numpy):
        np.testing.assert_array_equal(
            unpack(w, len(vals), widths[0]).astype(np.int64) + mf, vals)
