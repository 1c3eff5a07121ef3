"""Statement verification, EXPLAIN ANALYZE, the profiler and the
tpu_profile trace PRAGMAs of the port. Twins of tests/test_profiler.py:
the same SQL on both packages (the JAX package on its CPU backend, the
port with platform="cpu") with equal answers and equal EXPLAIN text; the
trace PRAGMAs write a torch.profiler Chrome trace."""

import json
import os

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu_torch.main import connection as port_connection
from adacom_tpu_torch.main.connection import SQLError


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
    con.query("CREATE TABLE t(i INTEGER, g INTEGER)")
    app = con.appender("t")
    v = np.arange(20_000, dtype=np.int32)
    app.append_columns({"i": v, "g": (v % 5).astype(np.int32)})
    app.close()
    return con


def _dbs():
    """(port connection, JAX package connection) over the same table."""
    out = []
    for pkg, kw in ((adacom_tpu_torch, {"platform": "cpu"}),
                    (adacom_tpu, {})):
        cfg = pkg.DBConfig()
        cfg.segment_rows = 4096
        out.append(_fill(pkg.Database(config=cfg, **kw).connect()))
    return out


def _close(cons):
    for con in cons:
        con.db.close()


def _both(cons, sql):
    got, want = (con.query(sql).fetchall() for con in cons)
    assert [tuple(int(v) for v in r) for r in got] == \
        [tuple(int(v) for v in r) for r in want], sql
    return got


def test_verifier_passes_on_correct_queries():
    cons = _dbs()
    for con in cons:
        con.query("SET query_verification_enabled = true")
    r = _both(cons, "SELECT g, COUNT(*) c, SUM(i) s FROM t WHERE i < 1000 "
                    "GROUP BY g ORDER BY g")
    assert len(r) == 5 and r[0][1] == 200
    r = _both(cons, "SELECT a.g FROM t a JOIN t b ON a.i = b.i WHERE "
                    "a.i = 7")
    assert r == [(2,)]
    _close(cons)


def test_verifier_catches_mismatch(monkeypatch):
    con = _dbs()[0]
    con.query("SET query_verification_enabled = true")
    from adacom_tpu_torch.main import verification

    orig = verification._rows_key
    calls = {"n": 0}

    def patched(rows):
        calls["n"] += 1
        # corrupt only the variant runs (2nd+ call per verify)
        out = orig(rows)
        return out + ["<corrupted>"] if calls["n"] > 1 and out else out

    monkeypatch.setattr(verification, "_rows_key", patched)
    with pytest.raises(SQLError, match="mismatch"):
        con.query("SELECT COUNT(*) FROM t WHERE i < 10")
    con.db.close()


def test_explain_and_analyze():
    cons = _dbs()
    sql = "SELECT g, SUM(i) FROM t GROUP BY g"
    texts = [con.query(f"EXPLAIN {sql}").fetchall()[0][0] for con in cons]
    assert texts[0] == texts[1]
    assert "Aggregate" in texts[0] and "Get" in texts[0]
    text = cons[0].query(f"EXPLAIN ANALYZE {sql}").fetchall()[0][0]
    assert "rows=5" in text and "time=" in text and "Total Time" in text
    _close(cons)


def test_profiler_phases_and_operator_tree():
    cons = _dbs()
    profiles = []
    for con in cons:
        con.query("PRAGMA enable_profiling")
        con.query("SELECT COUNT(*) FROM t WHERE i % 2 = 0")
        profiles.append(con.last_profile)
    p = profiles[0]
    assert p["statement"] == profiles[1]["statement"] == "SelectStmt"
    assert set(p["phases"]) == set(profiles[1]["phases"]) == {"plan_s",
                                                              "execute_s"}
    assert "Aggregate" in p["operators"] and "rows=1" in p["operators"]
    assert p["total_s"] > 0
    _close(cons)


def test_verifier_prepared_and_external_variants():
    """Prepared (value-free template) and external (fresh connection)
    variants run; a statement whose binding baked literals skips the
    prepared variant instead of failing."""
    cons = _dbs()
    for con in cons:
        con.query("SET query_verification_enabled = true")
    r = _both(cons, "SELECT SUM(i) FROM t WHERE i >= 10 AND i < 500")
    assert r[0][0] == sum(range(10, 500))
    for con in cons:
        con.query("CREATE TABLE s(v VARCHAR)")
        con.query("INSERT INTO s VALUES ('alpha'), ('beta'), ('alphabet')")
    r = _both(cons, "SELECT count(*) FROM s WHERE substring(v, 1, 4) = "
                    "'alph'")
    assert int(r[0][0]) == 2
    _close(cons)


def test_tpu_profile_trace_pragmas(tmp_path):
    """PRAGMA tpu_profile_start/stop capture a torch.profiler trace of the
    statements between them (on the CPU here: host events only) and return
    the trace directory, as the JAX package's PRAGMAs return it."""
    con = _dbs()[0]
    d = str(tmp_path / "trace")
    with pytest.raises(SQLError, match="without tpu_profile_start"):
        con.query("PRAGMA tpu_profile_stop")
    con.query(f"PRAGMA tpu_profile_start('{d}')")
    with pytest.raises(SQLError, match="already running"):
        con.query(f"PRAGMA tpu_profile_start('{d}')")
    assert con.query("SELECT SUM(i) FROM t").scalar() == sum(range(20_000))
    r = con.query("PRAGMA tpu_profile_stop").fetchall()
    assert r == [(d,)]
    with open(os.path.join(d, port_connection.TRACE_FILE)) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert len(trace["traceEvents"]) > 0 and names
    # a second capture into the same directory replaces the trace
    con.query(f"PRAGMA tpu_profile_start('{d}')")
    con.query("SELECT count(*) FROM t")
    assert con.query("PRAGMA tpu_profile_stop").fetchall() == [(d,)]
    con.db.close()
