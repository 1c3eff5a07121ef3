"""The port's holistic and extended aggregates against the JAX package: the
twins of tests/test_aggregates.py.

The same seeded table (50,000 rows, 1,000 distinct values) is loaded into
both packages once (the JAX package on its CPU backend, the port with
platform="cpu"); each case runs its SQL on both, holds the answers
against numpy as the reference test does, and the two packages' rows must
be equal. Tolerance: approx_count_distinct's estimates (HyperLogLog, an
integer) must be equal across the packages and within the reference's
25% / 30% of the true count; median and quantiles within 1e-9 of numpy
and equal across the packages after rounding to 6 decimals
(tests/test_sql.py's `_norm`); bool_and/bool_or exactly."""

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


@pytest.fixture(scope="module")
def engines():
    """{package: connection} over t(i BIGINT, g INTEGER, x DOUBLE), plus
    numpy's copy of i."""
    vals = np.random.default_rng(7).integers(0, 1000, 50_000).astype(np.int64)
    dbs, cons = [], {}
    for k, pkg in PKGS.items():
        cfg = pkg.DBConfig()
        cfg.segment_rows = 4096
        db = pkg.Database(config=cfg, **({"platform": "cpu"}
                                         if pkg is adacom_tpu_torch else {}))
        con = db.connect()
        con.query("CREATE TABLE t(i BIGINT, g INTEGER, x DOUBLE)")
        app = con.appender("t")
        app.append_columns({"i": vals, "g": (vals % 4).astype(np.int32),
                            "x": vals.astype(np.float64) / 2.0})
        app.close()
        con.query("CREATE TABLE e(i INTEGER)")
        con.query("CREATE TABLE b(g INTEGER, p BOOLEAN)")
        con.query("INSERT INTO b VALUES (1, true), (1, true), (2, true), "
                  "(2, false), (3, false)")
        dbs.append(db)
        cons[k] = con
    yield cons, vals
    for db in dbs:
        db.close()


def _both(engines, sql):
    cons, _vals = engines
    return {k: con.query(sql).fetchall() for k, con in cons.items()}


def _round(rows):
    return [tuple(round(float(v), 6) if isinstance(v, (float, np.floating))
                  else v for v in r) for r in rows]


def test_approx_count_distinct(engines):
    vals = engines[1]
    got = _both(engines, "SELECT approx_count_distinct(i) FROM t")
    assert got["port"] == got["jax"]
    est, true = got["port"][0][0], len(np.unique(vals))
    assert abs(est - true) / true < 0.25, (est, true)
    got = _both(engines, "SELECT g, approx_count_distinct(i) FROM t "
                         "GROUP BY g ORDER BY g")
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 4
    for g, est in got["port"]:
        true = len(np.unique(vals[vals % 4 == g]))
        assert abs(est - true) / true < 0.3, (g, est, true)


def test_median_and_quantiles(engines):
    vals = engines[1]
    s = np.sort(vals)
    got = _both(engines, "SELECT median(i), quantile_cont(x, 0.25), "
                         "quantile_disc(i, 0.9) FROM t")
    assert _round(got["port"]) == _round(got["jax"])
    med, qc, qd = got["port"][0]
    assert abs(med - np.median(vals)) < 1e-9
    assert abs(qc - np.quantile(vals / 2.0, 0.25)) < 1e-9
    assert qd == s[int(np.ceil(0.9 * len(s))) - 1]
    got = _both(engines, "SELECT g, median(i) m FROM t GROUP BY g ORDER BY g")
    assert _round(got["port"]) == _round(got["jax"])
    for g, m in got["port"]:
        assert abs(m - np.median(vals[vals % 4 == g])) < 1e-9


def test_median_empty_group(engines):
    got = _both(engines, "SELECT median(i) FROM e")
    assert got["port"] == got["jax"] == [(None,)]


def test_bool_and_or(engines):
    got = _both(engines, "SELECT g, bool_and(p), bool_or(p) FROM b "
                         "GROUP BY g ORDER BY g")
    assert got["port"] == got["jax"] == [(1, True, True), (2, False, True),
                                         (3, False, False)]
