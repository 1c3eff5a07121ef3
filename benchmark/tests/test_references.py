"""The plain reference against sqlite3 (only here) at a tiny scale."""

import sqlite3
from fractions import Fraction

import numpy as np
import pytest

from benchmark import compare, registry, traffic
from conftest import small_desc


@pytest.fixture(scope="module")
def lineitem(spec):
    desc = small_desc(spec, "tpch_lineitem_sf10")
    data = registry.load_module("configs", "tpch_lineitem_sf10").generate(desc, 99)
    lite = sqlite3.connect(":memory:")
    li = data["lineitem"]
    # decimals as scaled integers keep sqlite's sums exact
    lite.execute("CREATE TABLE lineitem(p INTEGER, d INTEGER, ship TEXT, supp INTEGER)")
    ship = np.datetime_as_string(li["l_shipdate"].astype("datetime64[D]"))
    lite.executemany("INSERT INTO lineitem VALUES (?,?,?,?)", zip(
        li["l_extendedprice"].tolist(), li["l_discount"].tolist(), ship.tolist(),
        li["l_suppkey"].tolist()))
    ref = registry.load_module("reference", "tpch_lineitem_sf10").Reference(data)
    return data, ref, lite


def _params(mix, name, n=12):
    tpl = traffic.Mix(registry.load_json("traffic", mix), {}).templates[name]
    drawn = tpl.draw(traffic.rng_for(4, 4), n)
    return [tpl.params_at(drawn, k) for k in range(n)]


def test_revenue_top(lineitem):
    _, ref, lite = lineitem
    for p in _params("revenue", "revenue"):
        top = lite.execute(
            "SELECT supp, sum(p * (100 - d)) AS r FROM lineitem WHERE ship >= ? AND ship < ? "
            "GROUP BY supp ORDER BY r DESC, supp LIMIT 10", (p["date"], p["date_end"])).fetchall()
        assert len(top) == 10
        assert ref.answer("tpch_revenue_top", p) == [(k, Fraction(r, 10**4)) for k, r in top]


def test_float32_control_departs(lineitem):
    """The control (the reference in float32) reads a gap where the exact
    reference reads none."""
    data, ref, _ = lineitem
    low = registry.load_module("reference", "tpch_lineitem_sf10").Reference(data, "float32")
    p = _params("revenue", "revenue")[0]
    wrong, gap = compare.answer_gap(low.answer("tpch_revenue_top", p),
                                    ref.answer("tpch_revenue_top", p))
    assert not wrong and gap > 1e-9
