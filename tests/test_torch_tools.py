"""The port's fuzzers and device warm-up, on the CPU: the query stream of
`adacom_tpu_torch.tools.fuzz_differential` equals the reference tool's
for four seeds, both fuzzers agree with sqlite at the default config, on
the device route (`DEVICE_ROUTE`) and on the host route (`HOST_ROUTE`),
the DML fuzzer also across a crash
and a reopen, no tool runs on a `cuda` platform without a card, and the
warm-up does nothing on the CPU. Comparisons are exact except where the
fuzzers' own comparison allows 1e-6 on floats.

The reference tools (`tools/*.py`) are loaded by path; they import the
JAX package, which the conftest keeps on the CPU."""

import importlib
import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

from adacom_tpu_torch.tools import fuzz_differential as fd
from adacom_tpu_torch.tools import fuzz_dml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("fuzz_differential", "fuzz_dml", "verify_sf1", "tpch_sf1",
         "record_suites", "grouped_agg_bench", "string_bench",
         "adaptive_overtime", "q18_stream", "route_sweep")
# the smallest run of each tool's command line
SMALL_ARGS = {
    "fuzz_differential": ["5", "3"], "fuzz_dml": ["5", "3"],
    "verify_sf1": ["0.01"], "tpch_sf1": ["1", "--sf", "0.01"],
    "record_suites": ["--scale", "0.0002", "--nruns", "1", "--pattern",
                      "SuccinctZipfDistribution"],
    "grouped_agg_bench": ["2048"], "string_bench": ["2048"],
    "adaptive_overtime": ["2048", "0.1"], "q18_stream": ["--sf", "0.01"],
    "route_sweep": ["agg", "--rows", "2048", "--domains", "64", "--hot",
                    "1"],
}


def reference_tool(name):
    """tools/<name>.py of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_query_stream_equals_reference(seed):
    ref = reference_tool("fuzz_differential")
    r_rng, p_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    r_data, p_data = ref.make_data(r_rng, 2000), fd.make_data(p_rng, 2000)
    for k in r_data:
        assert np.array_equal(r_data[k], p_data[k]), k
    want = [ref.gen_query(r_rng) for _ in range(200)]
    got = [fd.gen_query(p_rng) for _ in range(200)]
    assert got == want
    # `run` draws the same table and queries: make_data at N_ROWS, then
    # the queries from the same generator
    rng = np.random.default_rng(seed)
    want_data = ref.make_data(rng, fd.N_ROWS)
    want = [ref.gen_query(rng) for _ in range(200)]
    data, queries = fd.stream(200, seed)
    assert queries == want
    for k in want_data:
        assert np.array_equal(data[k], want_data[k]), k


@pytest.fixture(scope="module")
def oracle7():
    """sqlite's answers for seed 7, shared by both configs."""
    oracle = fd.SqliteOracle(fd.stream(0, 7)[0])
    yield oracle
    oracle.lite.close()


@pytest.mark.parametrize("route", ["default", "device", "host"])
def test_fuzz_differential_no_divergence(oracle7, route):
    from adacom_tpu_torch.exec import executor

    gate = executor.dense_agg_on_host
    res = fd.run(50, 7, "cpu", fd.ROUTES[route], oracle7)
    assert res["queries"] == 50
    assert res["divergences"] == []
    assert res["routes"]["device_scan"] > 0
    # each dense GROUP BY wider than the fused tiers take is routed as on a
    # card: on the host aggregate under the host route and the defaults
    # (20,000 rows < device_agg_min_rows), on the generic path under the
    # device route; the engine's own gate is back after the run
    assert executor.dense_agg_on_host is gate
    on_host = route != "device"
    assert res["routes"]["host_agg" if on_host else "generic_agg"] > 0
    assert res["routes"]["generic_agg" if on_host else "host_agg"] == 0
    if route == "device":
        # every query reads the table through the device path: the generic
        # path or a fused tier (a negative bound folds into B1/B2's range)
        fused = sum(res["routes"]["dist_stats"].get(k, 0) for k in (
            "pallas_scan_agg", "pallas_grouped_agg", "pallas_multi_agg"))
        assert res["routes"]["device_scan"] + fused >= 50
    # a CPU run launches no kernel
    assert [res["routes"][k] for k in ("B1", "B2", "B3")] == [0, 0, 0]


@pytest.mark.parametrize("route", ["default", "device", "host"])
@pytest.mark.parametrize("durable", [False, True])
def test_fuzz_dml_matches_sqlite(route, durable):
    res = fuzz_dml.run(80, 1, durable, "cpu", fd.ROUTES[route])
    assert res["mismatch"] is None
    assert res["durable"] is durable and res["rows"] > 0
    assert res["routes"]["device_scan"] > 0  # DML WHERE on the device scan


def test_fuzz_dml_reopen_replays_the_wal(tmp_path, monkeypatch):
    """The crash stand-in skips the closing checkpoint: the reopen finds
    no checkpoint and rebuilds the table from the WAL alone."""
    import adacom_tpu_torch as att

    seen = {}
    real = att.Database.__init__

    def spy(self, path=None, *a, **k):
        if path is not None and "db" in seen:
            seen["current_on_reopen"] = os.path.exists(
                os.path.join(path, "CURRENT"))
            seen["wal_bytes"] = os.path.getsize(os.path.join(path,
                                                             "wal.log"))
        seen["db"] = True
        real(self, path, *a, **k)

    monkeypatch.setattr(att.Database, "__init__", spy)
    assert fuzz_dml.run(60, 4, True, "cpu")["mismatch"] is None
    assert seen["current_on_reopen"] is False and seen["wal_bytes"] > 0


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_on_cuda_without_a_card_raises(tool, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"adacom_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(SMALL_ARGS[tool] + ["--platform", "cuda"])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("tool", ["fuzz_differential", "fuzz_dml",
                                  "record_suites", "grouped_agg_bench",
                                  "string_bench", "adaptive_overtime",
                                  "route_sweep"])
def test_tool_writes_no_file_without_a_path(tool, tmp_path, monkeypatch):
    """Run from a directory, a tool given no output path leaves it empty
    (the reference tools write their records into the current directory;
    tests/test_torch_tools_bench.py checks the TPC-H tools and
    q18_stream)."""
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"adacom_tpu_torch.tools.{tool}")
    assert mod.main(SMALL_ARGS[tool] + ["--platform", "cpu"]) == 0
    assert os.listdir(tmp_path) == []


def test_warmup_does_nothing_on_the_cpu():
    import adacom_tpu_torch as att
    from adacom_tpu_torch.utils import warmup

    before = dict(warmup._threads)
    warmup.warm_in_background(torch.device("cpu"))
    assert warmup.ensure_transfer_warm("cpu") is None
    db = att.Database(platform="cpu")
    db.close()
    assert warmup._threads == before
    assert not [t for t in threading.enumerate()
                if t.name == "adacom-warmup"]


def test_warmup_error_reaches_the_caller(monkeypatch):
    """An exception on the warm-up thread is kept and raised by
    ensure_transfer_warm (here a CUDA device that is not there)."""
    from adacom_tpu_torch.utils import warmup

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(warmup, "_threads", {})
    monkeypatch.setattr(warmup, "_errors", {})
    monkeypatch.setattr(warmup, "_seconds", {})
    warmup.warm_in_background(dev)
    with pytest.raises((RuntimeError, AssertionError)):
        warmup.ensure_transfer_warm(dev)
    assert dev in warmup._errors
