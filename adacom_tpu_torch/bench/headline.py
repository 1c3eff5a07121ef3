"""Headline benchmark of the port: SuccinctZipfDistribution (reference
benchmark/micro/succinct/zipf_distribution.cpp — 100M-row sequential
UINTEGER table, compacted to the succinct representation, 10k Zipf(k=1)
point lookups; methodology = 1 discarded cold run + 5 hot runs, mean).

Port of bench.py, run as ``python3 -m adacom_tpu_torch.bench.headline``.
Prints ONE JSON line with bench.py's keys: {"metric", "value", "unit",
"vs_baseline", "detail"}, where vs_baseline = ours/theirs against the
reference's 17.49 s per hot run on the authors' CPU server
(benchmarks.csv:32-36; BASELINE.md), and two changes in "detail":
"device_scan" in place of "tpu_scan", and "device", the card's
{"name", "power_limit"} from nvidia-smi or "cpu".

What each number measures:
- the point-lookup timing exercises the HOST LATENCY TIER (zonemap pruning
  + native eq-scan of the one candidate segment);
- "device_scan" exercises the device tier: kernel B1 (csrc/table_scan.cu)
  streaming the whole packed table (SELECT count(*), sum(i) FROM t1), the
  reference's ScanOOM-style workload (~4.1 s/100 scans there,
  benchmarks.csv:57-61), answer checked on every run;
- "memory": succinct vs plain footprint of the same data.

Environment: ADACOM_BENCH_SCALE (default 1.0 = the full 100M rows),
ADACOM_BENCH_RUNS (default 5 hot runs), ADACOM_BENCH_PLATFORM ("cuda",
the default, or "cpu")."""

import json
import os
import subprocess
import sys
import time

BASELINE_S = 17.49  # benchmarks.csv:32-36 mean, 5 hot runs
N_SCAN = 20


def device_info(platform: str):
    """The card's {"name", "power_limit"} as nvidia-smi reports them, or
    "cpu"."""
    if platform == "cpu":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = (s.strip() for s in smi.splitlines()[0].split(",", 1))
    return {"name": name, "power_limit": limit}


def run(scale: float, nruns: int, platform: str, out=None):
    """The benchmark; prints the JSON line on `out` (default stdout) and
    returns (result, checks): checks holds what the line leaves out, the
    runs verified, the scan's answer and expected answer, and the B1
    launches of the timed scans."""
    out = sys.stdout if out is None else out
    t_start = time.time()

    def mark(phase):
        print(f"[bench +{time.time() - t_start:7.1f}s] {phase}",
              file=sys.stderr, flush=True)

    from adacom_tpu_torch.bench.succinct_benchmarks import (
        NonSuccinctZipfDistribution, SuccinctZipfDistribution)
    from adacom_tpu_torch.ops import fused_scan

    device = device_info(platform)
    # ---- headline: Zipf point lookups over the compacted table ----
    mark("load start")
    b = SuccinctZipfDistribution(scale, platform)
    state = {}
    b.load(state)
    try:
        mark("load done")
        cat = state["db"].catalog.get_column_segment_catalog()
        succinct_bytes = cat.get_total_data_size()
        records = []
        for k in range(nruns + 1):
            t0 = time.perf_counter()
            b.run(state)
            timing = time.perf_counter() - t0
            err = b.verify(state)
            if err:
                raise AssertionError(f"verification failed: {err}")
            if k == 0:
                continue  # discarded cold run
            records.append(timing)
            print(f"SuccinctZipfDistribution\t{k}\t{timing:.6f}\t"
                  f"{succinct_bytes}\t{cat.get_total_data_size()}",
                  file=sys.stderr, flush=True)
        mark("lookup runs done")
        mean_s = sum(records) / len(records)

        # ---- device tier: fused full-table compressed scan (kernel B1) ----
        con = state["con"]
        n = state["n"]
        scan_sql = "SELECT count(*), sum(i) FROM t1"
        want = (n, n * (n - 1) // 2)
        res = con.query(scan_sql).fetchone()
        if (int(res[0]), int(res[1])) != want:
            raise AssertionError(f"scan: {res} != {want}")
        launches = fused_scan.KERNEL_LAUNCHES
        scan_s = 0.0
        for _ in range(N_SCAN):
            t0 = time.perf_counter()
            res = con.query(scan_sql).fetchone()
            scan_s += (time.perf_counter() - t0) / N_SCAN
            if (int(res[0]), int(res[1])) != want:
                raise AssertionError(f"scan: {res} != {want}")
        launches = fused_scan.KERNEL_LAUNCHES - launches
        mark("device scans done")
    finally:
        b.cleanup(state)
    # reference SuccinctScanOOM: 100 such scans over 150M rows in ~4.10 s
    # (benchmarks.csv:57-61) -> per-scan time scaled to our row count
    ref_scan_s = 4.10 / 100 * (n / 150e6)
    device_scan = {
        "query": scan_sql,
        "time_s": round(scan_s, 5),
        "packed_gbps": round(succinct_bytes / scan_s / 1e9, 1),
        "grows_per_s": round(n / scan_s / 1e9, 2),
        "vs_reference_scan": round(scan_s / ref_scan_s, 4),
    }
    checks = {"verified_runs": nruns + 1,
              "scan_answer": (int(res[0]), int(res[1])),
              "scan_expected": want, "b1_launches": launches}
    mark("cleanup done")

    # ---- memory story: plain (non-succinct) footprint of the same data ----
    b2 = NonSuccinctZipfDistribution(scale, platform)
    state2 = {}
    b2.load(state2)
    try:
        plain_bytes = state2["db"].catalog.get_column_segment_catalog() \
            .get_total_data_size()
    finally:
        b2.cleanup(state2)
    mark("non-succinct load done")

    result = {
        "metric": "SuccinctZipfDistribution (10k Zipf point lookups, "
                  f"{int(100e6 * scale)} rows)",
        "value": round(mean_s, 4),
        "unit": "s",
        "vs_baseline": round(mean_s / BASELINE_S, 4),
        "detail": {
            "tier": "host latency tier (zonemap + native eq-scan); "
                    "device_scan below is the device tier (kernel B1)",
            "hot_runs_s": [round(r, 4) for r in records],
            "device_scan": device_scan,
            "memory": {
                "succinct_bytes": succinct_bytes,
                "non_succinct_bytes": plain_bytes,
                "reduction": round(1 - succinct_bytes / plain_bytes, 4)
                if plain_bytes else None,
            },
            "scale": scale,
            "wall_total_s": round(time.time() - t_start, 1),
            "device": device,
        },
    }
    print(json.dumps(result), file=out, flush=True)
    return result, checks


def main(out=None):
    """run() at ADACOM_BENCH_SCALE, ADACOM_BENCH_RUNS and
    ADACOM_BENCH_PLATFORM."""
    return run(float(os.environ.get("ADACOM_BENCH_SCALE", "1.0")),
               int(os.environ.get("ADACOM_BENCH_RUNS", "5")),
               os.environ.get("ADACOM_BENCH_PLATFORM", "cuda"), out)


if __name__ == "__main__":
    main()
    sys.exit(0)
