"""All 22 TPC-H queries on the port at scale factor 0.01 (segments of
8,192 rows, as tests/test_tpch.py sets them): on plain and on packed
segments against an indexed sqlite3 oracle on the same data, and on
packed segments against the JAX package's answers. Floats agree within
rel_tol=1e-9, abs_tol=1e-6 against sqlite (its sums accumulate REALs) and
within 1e-12 relative against the JAX package; everything else is exact.
Rows are sorted where the query has no ORDER BY."""

import math
import sqlite3

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu_torch.bench import tpch


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


SF = 0.01
SEG_ROWS = 8192
# the oracle's indexes (tools/verify_sf1.py's and o_custkey)
SQLITE_INDEXES = ("lineitem(l_orderkey)", "lineitem(l_partkey)",
                  "lineitem(l_suppkey)", "orders(o_orderkey)",
                  "orders(o_custkey)", "partsupp(ps_partkey)")


@pytest.fixture(scope="module")
def data():
    return tpch.generate(sf=SF)


@pytest.fixture(scope="module")
def port(data):
    db = adacom_tpu_torch.Database(
        platform="cpu", config=adacom_tpu_torch.DBConfig(segment_rows=SEG_ROWS))
    con = db.connect()
    tpch.load_into_engine(con, data)
    yield con
    db.close()


@pytest.fixture(scope="module")
def oracle(data):
    """qid -> sqlite's rows, each computed once."""
    lite = sqlite3.connect(":memory:")
    tpch.load_into_sqlite(lite, data)
    for i, spec in enumerate(SQLITE_INDEXES):
        lite.execute(f"CREATE INDEX i{i} ON {spec}")
    answers = {}

    def get(qid):
        if qid not in answers:
            answers[qid] = _norm(lite.execute(tpch.oracle_sql(qid)).fetchall())
        return answers[qid]
    return get


@pytest.fixture(scope="module")
def reference(data):
    """The JAX package on the same data, packed."""
    db = adacom_tpu.Database(config=adacom_tpu.DBConfig(segment_rows=SEG_ROWS))
    con = db.connect()
    tpch.load_into_engine(con, data)
    con.query("PRAGMA compact_all_segments")
    return con


def _norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None:
                nr.append(None)
            elif isinstance(v, (float, np.floating)):
                nr.append(float(v))
            elif isinstance(v, (int, np.integer)):
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return out


def _rows_equal(got, exp, rel_tol, abs_tol):
    if len(got) != len(exp):
        return False
    for g, e in zip(got, exp):
        if len(g) != len(e):
            return False
        for a, b in zip(g, e):
            if isinstance(a, float) or isinstance(b, float):
                if a is None or b is None or not math.isclose(
                        float(a), float(b), rel_tol=rel_tol, abs_tol=abs_tol):
                    return False
            elif a != b:
                return False
    return True


def _ordered(qid, got, exp):
    if "ORDER BY" not in tpch.QUERIES[qid]:
        return sorted(got, key=repr), sorted(exp, key=repr)
    return got, exp


@pytest.mark.parametrize("qid", sorted(tpch.QUERIES))
@pytest.mark.parametrize("mode", ["plain", "packed"])
def test_tpch_query_vs_sqlite(port, oracle, qid, mode):
    port.query("PRAGMA compact_all_segments" if mode == "packed"
               else "PRAGMA uncompact_all")
    got, exp = _ordered(qid, _norm(port.query(tpch.QUERIES[qid]).fetchall()),
                        oracle(qid))
    assert _rows_equal(got, exp, 1e-9, 1e-6), \
        f"Q{qid} [{mode}]:\n got {got[:4]}\n exp {exp[:4]}"


@pytest.mark.parametrize("qid", sorted(tpch.QUERIES))
def test_tpch_query_vs_jax(port, reference, qid):
    port.query("PRAGMA compact_all_segments")
    got, exp = _ordered(qid, _norm(port.query(tpch.QUERIES[qid]).fetchall()),
                        _norm(reference.query(tpch.QUERIES[qid]).fetchall()))
    assert _rows_equal(got, exp, 1e-12, 0.0), \
        f"Q{qid}:\n got {got[:4]}\n exp {exp[:4]}"
