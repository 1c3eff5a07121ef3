"""Each cell's run, its client loops and its check, against a tiny CPU
database: the harness's look for a card is skipped, the rest is the run."""

import time

import pytest

from benchmark import harness, registry
from conftest import small_desc


def run(spec, cell_name, seconds=1.0, traced=False, seed=2**31 + 99):
    cell = registry.cell(spec, cell_name)
    return harness.run_cell(spec, cell, seed, seconds, traced, "cpu", time.perf_counter(),
                            desc=small_desc(spec, cell["config"]))


@pytest.mark.parametrize("cell_name", ["lineitem_sf10.revenue"])
def test_cell_rehearsal(spec, cell_name):
    r = run(spec, cell_name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    names = {m["name"] for m in registry.metrics_of(spec, "end_to_end", cell_name)}
    # device numbers are never written from a CPU run
    assert set(r["metrics"]) == names - {"device_peak_mib"}
    assert r["metrics"]["queries_per_s"]["value"] > 0


def test_traced_rehearsal_reads_per_layer_metrics(spec):
    r = run(spec, "lineitem_sf10.revenue", traced=True)
    assert r["correct"]
    assert {"plan_ms", "execute_ms", "data_size_mib"} <= set(r["metrics"])
    # no device trace on the CPU: its metrics are left out, never 0
    assert not {"kernels_per_query", "scan_roofline", "device_idle_pct"} & set(r["metrics"])
