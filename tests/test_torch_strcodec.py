"""The port's FSST and string-dictionary compression against the JAX package:
the twins of tests/test_strcodec.py.

The port builds native/adacom_native.cpp for the machine it runs on; the
JAX package loads the committed native/libadacom_native.so. The FSST
trainer and encoder are deterministic, so on the same corpus both builds
must give the same symbol table and byte-identical encoded strings, and
each decodes the other's. The dictionary and engine scenarios run on both
packages (the port with platform="cpu") and return footprints, flags and
decoded strings, which must be equal. Tolerance: everything is bytes,
strings, integers or bools, compared exactly."""

import importlib

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu import native as jnative
from adacom_tpu_torch import native as tnative

PKGS = {"jax": adacom_tpu, "port": adacom_tpu_torch}
NATIVES = {"jax": jnative, "port": tnative}
SEED = 0x5EED

pytestmark = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="a native library is unavailable")


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


def _corpus(strings):
    enc = [s.encode("utf-8") for s in strings]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    return np.frombuffer(b"".join(enc), np.uint8), offs, enc


def _urls():
    rng = np.random.default_rng(SEED)
    return [f"http://site{i % 971}.example.com/path/{i}?ref=abc"
            for i in rng.integers(0, 100000, 5000)]


def _adversarial():
    rng = np.random.default_rng(SEED)
    strings = ["", "a", "\x00\xff" * 3, "日本語テキスト", "x" * 500]
    strings += ["".join(chr(c) for c in rng.integers(32, 1000,
                                                      rng.integers(0, 30)))
                for _ in range(500)]
    return strings


@pytest.mark.parametrize("corpus", ["urls", "adversarial"])
def test_fsst_same_bytes_in_both_builds(corpus):
    """Train, encode and decode with each build: the same symbol table,
    the same encoded bytes, and every string back in both builds, each
    decoding the other's blob."""
    strings = _urls() if corpus == "urls" else _adversarial()
    arr, offs, enc = _corpus(strings)
    out = {}
    for k, nat in NATIVES.items():
        symtab, symlens, n = nat.fsst_train(arr)
        blob, eoffs = nat.fsst_encode(symtab, symlens, n, arr, offs)
        out[k] = (symtab, symlens, n, blob, eoffs)
    (js, jl, jn, jb, je), (ts, tl, tn, tb, te) = out["jax"], out["port"]
    assert jn == tn
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tl, jl)
    assert tb.tobytes() == jb.tobytes()
    np.testing.assert_array_equal(te, je)
    if corpus == "urls":
        assert len(tb) < 0.6 * len(arr)  # repetitive text compresses well
    step = 137 if corpus == "urls" else 1
    for i in range(0, len(strings), step):
        piece = tb[te[i]:te[i + 1]]
        for nat in NATIVES.values():
            assert nat.fsst_decode(ts, tl, tn, piece) == enc[i], i


def _table_mod(pkg):
    return importlib.import_module(f"{pkg.__name__}.storage.table")


def _dictionary_compress_transparent(pkg):
    rng = np.random.default_rng(SEED)
    d = _table_mod(pkg).StringDictionary()
    strings = [f"customer-{i:06d}@mail-provider-{i % 37}.com"
               for i in range(20000)]
    codes = d.encode(strings)
    plain = d.footprint_bytes()
    assert d.compress_fsst() and d.is_compressed()
    packed = d.footprint_bytes()
    assert packed < 0.7 * plain, (packed, plain)
    # random access without restoring the plain form
    sel = rng.integers(0, len(strings), 64)
    first = d.decode(codes[sel])
    assert first == [strings[i] for i in sel] and d.is_compressed()
    # an append restores the plain form first
    c = d.encode_one("a-new-string")
    assert not d.is_compressed()
    assert d.decode(np.asarray([c])) == ["a-new-string"]
    assert d.decode(codes[sel]) == [strings[i] for i in sel]
    return [np.asarray(codes).tolist(), plain, packed, first, int(c)]


def _dictionary_incompressible_stays_plain(pkg):
    rng = np.random.default_rng(SEED)
    d = _table_mod(pkg).StringDictionary()
    strings = ["".join(chr(c) for c in rng.integers(0x30, 0x2500, 24))
               for _ in range(2000)]
    d.encode(strings)
    # high-entropy strings: an encoder output no smaller keeps it plain
    adopted = d.compress_fsst()
    assert not adopted or d.footprint_bytes() <= \
        sum(len(s.encode()) for s in strings) + 8 * (len(strings) + 1)
    return [bool(adopted), d.is_compressed(), d.footprint_bytes()]


def _db(pkg, **kw):
    cfg = pkg.DBConfig()
    cfg.segment_rows = 4096
    if pkg is adacom_tpu_torch:
        kw["platform"] = "cpu"
    return pkg.Database(config=cfg, **kw)


def _engine_fsst_on_compact(pkg):
    db = _db(pkg)
    con = db.connect()
    con.query("CREATE TABLE t(v VARCHAR, i INTEGER)")
    strs = [f"/product/category-{i % 53}/item-{i:07d}" for i in range(30000)]
    app = con.appender("t")
    app.append_columns({"v": np.asarray(strs, dtype=object),
                        "i": np.arange(30000, dtype=np.int32)})
    app.close()
    col = db.catalog.get_table("t").columns["v"]
    plain = col.dictionary.footprint_bytes()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    assert col.dictionary.is_compressed()
    packed = col.dictionary.footprint_bytes()
    assert packed < plain
    # queries over the compressed dictionary
    out = [plain, packed,
           int(con.query("SELECT count(*) FROM t WHERE "
                         "v = '/product/category-1/item-0000001'").scalar()),
           con.query("SELECT v FROM t WHERE i = 12345").fetchone()[0],
           [tuple(r) for r in con.query(
               "SELECT v, count(*) FROM t WHERE i < 200 GROUP BY v "
               "ORDER BY v LIMIT 5").fetchall()]]
    assert out[2:4] == [1, strs[12345]]
    db.close()
    return out


def _fsst_dictionary_checkpoint_roundtrip(pkg, path):
    """CHECKPOINT with an FSST-compressed dictionary stores the plain
    strings and reloads exactly."""
    db = _db(pkg, path=path)
    con = db.connect()
    con.query("CREATE TABLE t(v VARCHAR)")
    strs = [f"/x/y/entry-{i:07d}" for i in range(20000)]
    app = con.appender("t")
    app.append_column("v", np.asarray(strs, dtype=object))
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    assert db.catalog.get_table("t").columns["v"].dictionary.is_compressed()
    con.query("CHECKPOINT")
    db.close()
    db2 = _db(pkg, path=path)
    con2 = db2.connect()
    out = [con2.query("SELECT v FROM t WHERE v = '/x/y/entry-0012345'"
                      ).fetchall(),
           int(con2.query("SELECT count(*) FROM t").fetchone()[0])]
    assert out == [[("/x/y/entry-0012345",)], 20000]
    db2.close()
    return out


TWINS = {f.__name__.lstrip("_"): f for f in (
    _dictionary_compress_transparent, _dictionary_incompressible_stays_plain,
    _engine_fsst_on_compact)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_of_test_strcodec(name):
    got = {k: TWINS[name](pkg) for k, pkg in PKGS.items()}
    assert got["port"] == got["jax"]


def test_twin_fsst_dictionary_checkpoint_roundtrip(tmp_path):
    got = {k: _fsst_dictionary_checkpoint_roundtrip(pkg, str(tmp_path / k))
           for k, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
