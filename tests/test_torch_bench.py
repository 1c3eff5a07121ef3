"""The port's benchmark surface against the JAX package's, on the CPU:
the Zipf sampler (native and NumPy paths), the runner's registry and CLI,
every [succinct] class at a small scale with the footprints of five held
byte for byte against the JAX package's, the TPC-H registry, the bench.py
twin (bench/headline.py) and the roofline's exactness checks. Sizes and
sample values are exact comparisons; there is no tolerance."""

import io
import json

import numpy as np
import pytest
import torch

from adacom_tpu.bench import runner as jrunner
from adacom_tpu.bench import zipf as jzipf
from adacom_tpu_torch.bench import runner, zipf

SCALE = 0.001
# the adaptive classes and the skew sweep run at a fifth of SCALE
SMALL = {"ZipfOverTime": 0.0002, "DistributionChanging": 0.0002,
         "ZipfDistributionDiffSkews": 0.0002}
# classes whose sizeInBytes / MemoryAllocationInBytes must equal the JAX
# package's (each runs one hot run on both packages)
FOOTPRINTS = ("SuccinctZipfDistribution", "SuccinctPaddedZipfDistribution",
              "SuccinctZipfScanOOM", "NonSuccinctZipfScanOOM", "FBWorkload")
# bench.py's JSON keys, "tpu_scan" renamed and "device" added
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"tier", "hot_runs_s", "device_scan", "memory", "scale",
               "wall_total_s", "device"}
SCAN_KEYS = {"query", "time_s", "packed_gbps", "grows_per_s",
             "vs_reference_scan"}
MEMORY_KEYS = {"succinct_bytes", "non_succinct_bytes", "reduction"}


def _registered():
    runner.main([])
    jrunner.main([])
    return runner.REGISTRY, jrunner.REGISTRY


def _succinct_names():
    from adacom_tpu_torch.bench import succinct_benchmarks  # noqa: F401

    return [n for n, c in runner.REGISTRY.items()
            if c.__module__.endswith("succinct_benchmarks")]


@pytest.mark.parametrize("n,q,seed", [(1000, 1.0, 7), (10**8, 1.0, 7),
                                      (150_000, 2.0, 23), (5000, 0.4, 41)])
@pytest.mark.parametrize("native_path", [True, False])
def test_zipf_sampler_matches_reference(monkeypatch, n, q, seed, native_path):
    from adacom_tpu import native as jnative
    from adacom_tpu_torch import native as tnative

    if not native_path:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert tnative.available() and jnative.available()
    got = zipf.ZipfSampler(n, q, seed=seed).sample(3000)
    want = jzipf.ZipfSampler(n, q, seed=seed).sample(3000)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.min() >= 1 and got.max() <= n


def test_registry_names_equal_reference():
    port, ref = _registered()
    assert sorted(port) == sorted(ref)
    assert len(port) == 18 + 22 + 43


def test_runner_cli_no_match_returns_1(capsys):
    assert runner.main(["NoSuch"]) == 1
    assert "no benchmark matches" in capsys.readouterr().err


def test_runner_lists_registry(capsys):
    assert runner.main([]) == 0
    names = capsys.readouterr().out.split()
    assert "SuccinctZipfDistribution" in names and "ClickBench_Q43" in names


@pytest.mark.parametrize("name", [
    "SuccinctZipfDistribution", "SuccinctPaddedZipfDistribution",
    "NonSuccinctZipfDistribution", "SuccinctNormalDistribution",
    "NonSuccinctNormalDistribution", "SuccinctRandomDistribution",
    "NonSuccinctRandomDistribution", "SuccinctSequentialInsert",
    "SuccinctPaddedSequentialInsert", "NonSuccinctSequentialInsert",
    "SuccinctScanOOM", "NonSuccinctScanOOM", "SuccinctZipfScanOOM",
    "NonSuccinctZipfScanOOM", "ZipfOverTime", "ZipfDistributionDiffSkews",
    "DistributionChanging", "FBWorkload"])
def test_succinct_benchmark_runs(name):
    """Each class loads, runs and verifies on the CPU; the five FOOTPRINTS
    classes run one hot run on both packages and report the same bytes.
    The others run their cold run only (verified, no TSV row)."""
    assert set(_succinct_names()) >= {name}
    _registered()
    scale = SMALL.get(name, SCALE)
    log = io.StringIO()
    nruns = 1 if name in FOOTPRINTS else 0
    recs = runner.run_benchmark(runner.REGISTRY[name], scale=scale,
                                nruns=nruns, log=log, platform="cpu")
    assert len(recs) == nruns
    if name not in FOOTPRINTS:
        return
    row = log.getvalue().strip().split("\t")
    assert row[0] == name and row[1] == "1" and len(row) == 5
    want = jrunner.run_benchmark(jrunner.REGISTRY[name], scale=scale,
                                 nruns=1, log=io.StringIO())
    for key in ("sizeInBytes", "MemoryAllocationInBytes"):
        assert recs[0][key] == want[0][key] > 0, (key, recs, want)


def test_succinct_group_is_complete():
    names = _succinct_names()
    assert len(names) == 18
    assert set(names) == {n for n, c in jrunner.REGISTRY.items()
                          if c.__module__.endswith("succinct_benchmarks")}


def test_background_compaction_stops_on_failure(monkeypatch):
    """A run that fails still stops the adaptive classes' thread."""
    from adacom_tpu_torch.bench import succinct_benchmarks as sb

    stopped = []
    orig = sb.ZipfOverTime.cleanup

    def cleanup(self, state):
        stopped.append(True)
        orig(self, state)

    def fail(self, state):
        raise RuntimeError("boom")

    monkeypatch.setattr(sb.ZipfOverTime, "cleanup", cleanup)
    monkeypatch.setattr(sb.ZipfOverTime, "run", fail)
    with pytest.raises(RuntimeError):
        runner.run_benchmark(sb.ZipfOverTime, scale=0.0001, nruns=0,
                             log=io.StringIO(), platform="cpu")
    assert stopped == [True]


def test_tpch_q06_through_runner():
    _registered()
    log = io.StringIO()
    recs = runner.run_benchmark(runner.REGISTRY["TPCH_Q06"], scale=0.01,
                                nruns=1, log=log, platform="cpu")
    assert len(recs) == 1 and recs[0]["name"] == "TPCH_Q06"
    assert recs[0]["sizeInBytes"] > 0


def test_headline_json(monkeypatch):
    from adacom_tpu.bench.succinct_benchmarks import (
        NonSuccinctZipfDistribution, SuccinctZipfDistribution)
    from adacom_tpu_torch.bench import headline

    monkeypatch.setenv("ADACOM_BENCH_SCALE", str(SCALE))
    monkeypatch.setenv("ADACOM_BENCH_RUNS", "1")
    monkeypatch.setenv("ADACOM_BENCH_PLATFORM", "cpu")
    out = io.StringIO()
    result, checks = headline.main(out)
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == json.loads(json.dumps(result))
    assert set(got) == HEADLINE_KEYS
    assert set(got["detail"]) == DETAIL_KEYS
    assert set(got["detail"]["device_scan"]) == SCAN_KEYS
    assert set(got["detail"]["memory"]) == MEMORY_KEYS
    assert got["detail"]["device"] == "cpu"
    assert got["unit"] == "s" and len(got["detail"]["hot_runs_s"]) == 1
    n = int(100e6 * SCALE)
    assert checks["verified_runs"] == 2
    assert checks["scan_answer"] == checks["scan_expected"] == (
        n, n * (n - 1) // 2)
    # the footprints equal the JAX package's at this scale
    for cls, key in ((SuccinctZipfDistribution, "succinct_bytes"),
                     (NonSuccinctZipfDistribution, "non_succinct_bytes")):
        b, state = cls(SCALE), {}
        b.load(state)
        size = state["db"].catalog.get_column_segment_catalog() \
            .get_total_data_size()
        b.cleanup(state)
        assert got["detail"]["memory"][key] == size > 0
    assert got["detail"]["memory"]["reduction"] > 0


def test_roofline_cpu_exact():
    from adacom_tpu_torch.tools import roofline

    r = roofline.measure(torch.device("cpu"), rows=1 << 17, width=16, runs=2)
    assert r["rows"] == 1 << 17 and r["segments"] == 2
    assert r["packed_bytes"] == 2 * 16 * 2048 * 4
    assert r["read"]["bytes"] == 4 << 17 and r["copy"]["bytes"] == 8 << 17
    for rec in (r["read"], r["copy"], r["torch_decode"],
                r["b1"]["lean"]["wrapper"], r["b1"]["pred"]["wrapper"]):
        assert rec["events_ms"] is None and rec["wall_ms"] > 0


def test_roofline_checks_answers(monkeypatch):
    """measure() fails when the scan's answer is wrong."""
    from adacom_tpu_torch.ops import fused_scan
    from adacom_tpu_torch.tools import roofline

    real = fused_scan.scan_table

    def off_by_one(*a, **kw):
        out = real(*a, **kw)
        return out if kw.get("device_out") else (out[0] + 1,) + tuple(out[1:])

    monkeypatch.setattr(fused_scan, "scan_table", off_by_one)
    with pytest.raises(AssertionError):
        roofline.measure(torch.device("cpu"), rows=1 << 16, width=9, runs=2)
