"""The port's out-of-core join and sort: the spill primitives give the
JAX package's answers on the same inputs, and SQL joins and sorts under a
memory_limit small enough to spill (the spill routine must run) answer as
they do in RAM (the port's twin of tests/test_spill.py)."""

import numpy as np
import pytest

import adacom_tpu_torch
from adacom_tpu.exec import spill as jspill
from adacom_tpu_torch.exec import spill


@pytest.mark.parametrize("parts", [2, 8])
def test_partitioned_join_pairs_matches_jax_and_inram(rng, parts):
    lk = rng.integers(0, 2000, 50_000).astype(np.uint64)
    rk = rng.integers(0, 2000, 8_000).astype(np.uint64)
    li, ri = spill.partitioned_join_pairs(lk, rk, parts)
    li, ri = np.asarray(li), np.asarray(ri)
    assert np.all(lk[li] == rk[ri])
    jli, jri = jspill.partitioned_join_pairs(lk, rk, parts)
    np.testing.assert_array_equal(li, np.asarray(jli))
    np.testing.assert_array_equal(ri, np.asarray(jri))
    # pair count vs the direct computation
    rks = np.sort(rk)
    n = np.searchsorted(rks, lk, "right") - np.searchsorted(rks, lk, "left")
    assert len(li) == int(n.sum())


@pytest.mark.parametrize("parts", [2, 8])
def test_external_sort_matches_jax_and_lexsort(rng, parts):
    a = rng.integers(-5000, 5000, 300_000).astype(np.int64)
    b = rng.integers(0, 10, 300_000).astype(np.int64)
    idx = np.asarray(spill.external_sort_indices([b, a], parts))  # a primary
    np.testing.assert_array_equal(
        idx, np.asarray(jspill.external_sort_indices([b, a], parts)))
    exp = np.lexsort((b, a))
    np.testing.assert_array_equal(a[exp], a[idx])
    np.testing.assert_array_equal(b[exp], b[idx])


def _fill(con, rng):
    n = 400_000
    con.query("CREATE TABLE big(k INTEGER, v INTEGER)")
    con.query("CREATE TABLE small(k INTEGER, w INTEGER)")
    app = con.appender("big")
    app.append_columns({"k": rng.integers(0, 3000, n).astype(np.int32),
                        "v": rng.integers(0, 1 << 30, n).astype(np.int32)})
    app.close()
    sk = np.arange(3000, dtype=np.int32)
    app = con.appender("small")
    app.append_columns({"k": sk, "w": sk * 5})
    app.close()


SQL = {
    # the materializing join (streaming off) takes the grace-hash spill
    "join": ("SELECT count(*), sum(s.w), sum(b.v) FROM big b "
             "JOIN small s ON b.k = s.k", "partitioned_join_pairs",
             {"streaming_join_enabled": False}),
    # the streamed probe builds its table from small: no spill, same answer
    "streamed join": ("SELECT count(*), sum(s.w), sum(b.v) FROM big b "
                      "JOIN small s ON b.k = s.k", None, {}),
    "order": ("SELECT v FROM big ORDER BY v", "external_sort_indices", {}),
    "top-n": ("SELECT k, v FROM big ORDER BY v DESC, k LIMIT 50",
              "external_sort_indices", {}),
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_spills_and_matches(monkeypatch, name):
    sql, routine, cfg = SQL[name]
    calls = []
    if routine is not None:
        real = getattr(spill, routine)
        monkeypatch.setattr(spill, routine,
                            lambda *a, **k: calls.append(1) or real(*a, **k))

    def run(limit):
        config = adacom_tpu_torch.DBConfig()
        config.segment_rows = 16384
        for k, v in cfg.items():
            setattr(config, k, v)
        db = adacom_tpu_torch.Database(platform="cpu", config=config)
        con = db.connect()
        _fill(con, np.random.default_rng(0x5B111))
        con.query(f"PRAGMA memory_limit='{limit}'")
        r = [tuple(int(x) for x in row) for row in con.query(sql).fetchall()]
        db.close()
        return r

    in_ram = run("none")
    assert not calls
    assert run("1MB") == in_ram
    assert bool(calls) == (routine is not None), f"{routine} calls: {calls}"
