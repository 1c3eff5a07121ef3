"""Parquet and JSON I/O of the port against the JAX package: the
read_parquet and read_json table functions and COPY TO/FROM with FORMAT
PARQUET. Twins of tests/test_parquet_json.py: the same SQL on both packages
(the JAX package on its CPU backend, the port with platform="cpu") with
equal answers, and each of the reference test's checks on the port."""

import json

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch


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


pytest.importorskip("pyarrow")


@pytest.fixture()
def cons():
    """(port connection, JAX package connection)."""
    pdb = adacom_tpu_torch.Database(platform="cpu")
    jdb = adacom_tpu.Database()
    yield pdb.connect(), jdb.connect()
    pdb.close()
    jdb.close()


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


def _both(cons, sql):
    """The port's rows, after checking them equal to the JAX package's
    (every value here is exact: no float is summed)."""
    got, want = (con.query(sql).fetchall() for con in cons)
    assert _norm(got) == _norm(want), sql
    return got


def _write_sample_parquet(path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pa.table({
        "i": pa.array([1, 2, None, 4], type=pa.int32()),
        "f": pa.array([1.5, None, 3.5, 4.0]),
        "s": pa.array(["a", "bb", None, "dd"]),
        "d": pa.array([0, 9496, None, 11323], type=pa.int32()).cast(
            pa.date32()),
        "b": pa.array([True, None, False, True]),
    })
    pq.write_table(t, path)


def test_read_parquet(cons, tmp_path):
    p = str(tmp_path / "x.parquet")
    _write_sample_parquet(p)
    rows = _both(cons, f"SELECT * FROM read_parquet('{p}')")
    assert len(rows) == 4
    assert tuple(rows[0])[:3] == (1, 1.5, "a")
    assert str(rows[0][3]) == "1970-01-01"
    assert str(rows[3][3]) == "2001-01-01"
    assert rows[2][0] is None and rows[1][1] is None and rows[2][2] is None
    r = _both(cons, f"SELECT count(*), sum(i), min(d), max(s) FROM "
                    f"read_parquet('{p}')")
    assert _norm(r)[0][:2] == (4, 7)


def test_copy_roundtrip_parquet(cons, tmp_path):
    got = []
    for name, con in zip(("port", "jax"), cons):
        p = str(tmp_path / f"{name}.parquet")
        con.query("CREATE TABLE t(a BIGINT, b DOUBLE, c VARCHAR, d DATE, "
                  "e DECIMAL(8,2))")
        con.query("INSERT INTO t VALUES (1, 1.5, 'x', '1996-03-13', 2.25), "
                  "(2, NULL, 'yy', NULL, NULL), "
                  "(3, 2.5, NULL, '2000-01-01', 7.5)")
        n = con.query(f"COPY t TO '{p}' (FORMAT PARQUET)").fetchone()[0]
        assert int(n) == 3
        con.query("CREATE TABLE t2(a BIGINT, b DOUBLE, c VARCHAR, d DATE, "
                  "e DOUBLE)")
        assert int(con.query(f"COPY t2 FROM '{p}'").fetchone()[0]) == 3
        got.append(p)
    import pyarrow.parquet as pq

    # the files hold the same table
    assert pq.read_table(got[0]).equals(pq.read_table(got[1]))
    for p in got:
        rows = _both(cons, f"SELECT * FROM read_parquet('{p}') ORDER BY a")
        assert tuple(rows[0])[:3] == (1, 1.5, "x")
        assert str(rows[0][3]) == "1996-03-13"
        assert rows[1][1] is None and rows[1][3] is None
        assert rows[2][2] is None and float(rows[2][4]) == 7.5
    assert _norm(_both(cons, "SELECT count(*), sum(a), sum(e) FROM t2")) \
        == [(3, 6, 9.75)]


def test_read_json_ndjson(cons, tmp_path):
    p = str(tmp_path / "x.ndjson")
    with open(p, "w") as f:
        f.write('{"a": 1, "s": "x", "f": 1.5}\n')
        f.write('{"a": 2, "s": "yy"}\n')
        f.write('{"a": null, "s": "z", "f": 2.5, "extra": true}\n')
    rows = _both(cons, f"SELECT a, s, f, extra FROM read_json('{p}')")
    assert _norm(rows)[0] == (1, "x", 1.5, None)
    assert rows[1][2] is None  # missing key -> NULL
    assert rows[2][0] is None and bool(rows[2][3]) is True
    r = _both(cons, f"SELECT sum(a), count(f) FROM read_json('{p}')")
    assert _norm(r) == [(3, 2)]


def test_read_json_array(cons, tmp_path):
    p = str(tmp_path / "arr.json")
    with open(p, "w") as f:
        json.dump([{"k": "a", "v": 10}, {"k": "b", "v": 20},
                   {"k": "c", "v": 2.5}], f)
    rows = _both(cons, f"SELECT k, v FROM read_json('{p}') ORDER BY v DESC")
    assert _norm(rows) == [("b", 20.0), ("a", 10.0), ("c", 2.5)]


def test_json_dates_and_nested(cons, tmp_path):
    p = str(tmp_path / "d.ndjson")
    with open(p, "w") as f:
        f.write('{"d": "1996-03-13", "obj": {"x": 1}}\n')
        f.write('{"d": "2000-12-31", "obj": [1, 2]}\n')
    rows = _both(cons, f"SELECT d, obj FROM read_json('{p}')")
    assert str(rows[0][0]) == "1996-03-13"
    # nested values stringify to their JSON text
    assert json.loads(rows[0][1]) == {"x": 1}
    assert json.loads(rows[1][1]) == [1, 2]
    # COPY FROM a JSON file into a table
    for con in cons:
        con.query("CREATE TABLE j(d DATE, obj VARCHAR)")
        assert con.query(f"COPY j FROM '{p}'").scalar() == 2
    _both(cons, "SELECT * FROM j ORDER BY d")
