import datetime

import numpy as np
import pytest

from benchmark import registry, traffic
from conftest import small_desc


@pytest.mark.parametrize("config", ["tpch_lineitem_sf10"])
def test_data_is_the_seeds(spec, config):
    gen = registry.load_module("configs", config)
    desc = small_desc(spec, config)
    a, b = gen.generate(desc, 2**31 + 7), gen.generate(desc, 2**31 + 7)
    for table in a:
        for col in a[table]:
            assert np.array_equal(a[table][col], b[table][col]), (table, col)
    assert set(a) == set(desc["tables"])
    for table, cols in desc["tables"].items():
        assert set(a[table]) == set(cols)


def test_lineitem_follows_tpch_domains(spec):
    desc = small_desc(spec, "tpch_lineitem_sf10")
    data = registry.load_module("configs", "tpch_lineitem_sf10").generate(desc, 5)
    li, sup = data["lineitem"], data["supplier"]
    n_supp = int(10_000 * desc["scale_factor"])
    assert 1 <= li["l_quantity"].min() // 100 and li["l_quantity"].max() // 100 <= 50
    assert (li["l_quantity"] % 100 == 0).all()
    assert li["l_discount"].min() >= 0 and li["l_discount"].max() <= 10
    assert li["l_tax"].min() >= 0 and li["l_tax"].max() <= 8
    assert set(np.unique(li["l_returnflag"])) == {"A", "N", "R"}
    assert set(np.unique(li["l_linestatus"])) == {"F", "O"}
    assert li["l_suppkey"].min() >= 1 and li["l_suppkey"].max() <= n_supp
    day = np.datetime64("1992-01-01", "D").astype(np.int64)
    assert li["l_shipdate"].min() > day
    assert li["l_shipdate"].max() <= np.datetime64("1998-12-31", "D").astype(np.int64) - 151 + 121
    current = np.datetime64("1995-06-17", "D").astype(np.int64)
    assert ((li["l_linestatus"] == "O") == (li["l_shipdate"] > current)).all()
    assert (li["l_returnflag"][li["l_shipdate"] > current] == "N").all()
    assert list(sup["s_suppkey"]) == list(range(1, n_supp + 1))
    assert all(10 <= len(a) <= 40 for a in sup["s_address"])
    assert all(s.startswith("Supplier#") and len(s) == 18 for s in sup["s_name"])


def test_streams_are_the_seeds_and_in_range(spec):
    seen = []
    mix = traffic.Mix(registry.load_json("traffic", "revenue"), small_desc(spec, "tpch_lineitem_sf10"))
    one, two = mix.clients(3 * 2**31), mix.clients(3 * 2**31)
    assert len(one) == 3
    for s1, s2 in zip(one, two):
        for k in range(200):
            r1, r2 = s1.request(k), s2.request(k)
            assert r1[2] == r2[2]
            seen.append(r1[1])
    for p in seen:
        d, e = datetime.date.fromisoformat(p["date"]), datetime.date.fromisoformat(p["date_end"])
        assert d.day == 1 and "1993-01-01" <= p["date"] <= "1997-10-01"
        assert (e.year * 12 + e.month) - (d.year * 12 + d.month) == 3
    # quarters drawn per query: both ends of the range come up
    assert {p["date"] for p in seen} >= {"1993-01-01", "1997-10-01"}


def test_zipf_and_decimal_draws():
    """The kinds of parameter that no committed mix uses yet: a bounded
    Zipf over a size the configuration names, and a decimal literal."""
    spec = {"clients": [{"count": 1, "templates": ["t"], "requests": 2000}],
            "templates": {"t": {"answer": "a", "sql": "SELECT {v}, {d}", "params": {
                "v": {"zipf": ["rows", 1.0]}, "k": {"int": [2, 9]},
                "d": {"decimal": ["k", -1, 2]}}}}}
    stream = traffic.Mix(spec, {"rows": 200_000}).clients(11)[0]
    reqs = [stream.request(k)[1] for k in range(2000)]
    vals = [p["v"] for p in reqs]
    assert min(vals) >= 1 and max(vals) <= 200_000
    # Zipf(k=1): the smallest keys are the most frequent
    assert vals.count(1) > vals.count(2) > vals.count(50)
    assert all(p["d"] == f"0.{p['k'] - 1:02d}" for p in reqs)


def test_any_whole_seed():
    for seed in (0, -1, 2**31 + 3, 2**70):
        assert traffic.rng_for(seed, 1).integers(0, 10) == traffic.rng_for(seed, 1).integers(0, 10)
