"""Plan serialization of the port against the JAX package, and the
`deserialized` verifier variant. Twins of tests/test_serialize.py: the same
SQL bound and optimized in both packages gives the same JSON, the plan
round-trips in the port, and both answers agree."""

import json
import math

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu.sql import binder as jax_binder
from adacom_tpu.sql import optimizer as jax_optimizer
from adacom_tpu.sql import parser as jax_parser
from adacom_tpu.sql import serialize as jax_serialize
from adacom_tpu.exec.executor import Executor as JaxExecutor
from adacom_tpu.main.result import QueryResult as JaxResult
from adacom_tpu_torch.exec.executor import Executor
from adacom_tpu_torch.main.result import QueryResult
from adacom_tpu_torch.sql.binder import Binder
from adacom_tpu_torch.sql.optimizer import optimize
from adacom_tpu_torch.sql.parser import parse
from adacom_tpu_torch.sql.serialize import (SerializeError, deserialize_plan,
                                            serialize_plan)


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


def _fill(con):
    con.query("CREATE TABLE t(k INTEGER, v BIGINT, s VARCHAR, x DOUBLE)")
    rng = np.random.default_rng(5)
    n = 5000
    app = con.appender("t")
    app.append_columns({
        "k": rng.integers(0, 20, n).astype(np.int32),
        "v": rng.integers(-100, 100, n).astype(np.int64),
        "s": np.asarray(["red", "green", "blue", "teal"], object)[
            rng.integers(0, 4, n)],
        "x": rng.random(n),
    })
    app.close()


@pytest.fixture(scope="module")
def dbs():
    """(port database, JAX package database) holding the same table t."""
    pdb = adacom_tpu_torch.Database(platform="cpu")
    jdb = adacom_tpu.Database()
    _fill(pdb.connect())
    _fill(jdb.connect())
    yield pdb, jdb
    pdb.close()
    jdb.close()


QUERIES = [
    "SELECT k, sum(v), count(*) FROM t GROUP BY k ORDER BY k",
    "SELECT * FROM t WHERE k = 3 AND v > 0 ORDER BY v LIMIT 7",
    "SELECT s, avg(x) FROM t WHERE s <> 'red' GROUP BY s ORDER BY s",
    "SELECT a.k, b.v FROM t a JOIN t b ON a.k = b.k WHERE a.v > 90 ORDER BY a.k, b.v LIMIT 20",
    "SELECT k, CASE WHEN v > 0 THEN 'pos' ELSE 'neg' END AS sgn FROM t WHERE k = 1 ORDER BY v LIMIT 5",
    "SELECT k FROM t WHERE v > (SELECT avg(v) FROM t) ORDER BY k LIMIT 5",
]


def _rows(mat, result_cls):
    return result_cls(mat.names, mat.types, mat.cols, mat.valids,
                      mat.dicts).fetchall()


def _same(a, b):
    assert len(a) == len(b)
    for r, w in zip(a, b):
        for x, y in zip(r, w):
            if isinstance(x, (float, np.floating)):
                assert math.isclose(float(x), float(y), rel_tol=1e-12)
            else:
                assert x == y


@pytest.mark.parametrize("sql", QUERIES)
def test_roundtrip_same_results_and_json(dbs, sql):
    pdb, jdb = dbs
    stmts, _key, lits, structural = parse(sql)
    plan = optimize(Binder(pdb.catalog, pdb.config).bind_select(stmts[0]),
                    set(structural))
    payload = json.dumps(serialize_plan(plan, pdb.catalog))
    plan2 = deserialize_plan(json.loads(payload), pdb.catalog)
    rows1 = _rows(Executor(pdb).execute(plan, lits), QueryResult)
    rows2 = _rows(Executor(pdb).execute(plan2, lits), QueryResult)
    assert rows1 == rows2
    # the JAX package: the same JSON for the same SQL, but for its
    # BSubquery's runtime field, and the same answer
    jstmts, _k, jlits, jstruct = jax_parser.parse(sql)
    jplan = jax_optimizer.optimize(
        jax_binder.Binder(jdb.catalog, jdb.config).bind_select(jstmts[0]),
        set(jstruct))
    jpayload = json.dumps(jax_serialize.serialize_plan(jplan, jdb.catalog))
    assert json.dumps(_without_cached_value(json.loads(jpayload))) == payload
    _same(rows1, _rows(JaxExecutor(jdb).execute(jplan, jlits), JaxResult))
    # a payload that still carries the field (the JAX package's, or this
    # package's before the field went) loads and answers the same
    plan3 = deserialize_plan(json.loads(jpayload), pdb.catalog)
    assert _rows(Executor(pdb).execute(plan3, lits), QueryResult) == rows1


def _without_cached_value(v):
    """A plan's JSON less BSubquery's `cached_value`, which the JAX
    package's plans carry (always null) and this package's do not."""
    if isinstance(v, list):
        return [_without_cached_value(x) for x in v]
    if not isinstance(v, dict):
        return v
    out = {}
    for k, x in v.items():
        if k == "cached_value" and v.get("__t") == "BSubquery":
            assert x is None
            continue
        out[k] = _without_cached_value(x)
    return out


def test_deserialize_rejects_a_non_plan(dbs):
    with pytest.raises(SerializeError):
        deserialize_plan({"__ty": ["INTEGER", 0, 0]}, dbs[0].catalog)


def test_verifier_runs_all_variants(dbs):
    got = []
    for db in dbs:
        con = db.connect()
        con.query("SET query_verification_enabled = true")
        try:
            got.append(con.query(
                "SELECT k, sum(v) FROM t WHERE k < 10 GROUP BY k ORDER BY k"
            ).fetchall())
        finally:
            con.query("SET query_verification_enabled = false")
    assert len(got[0]) == 10
    _same(got[0], got[1])
