"""Benchmark runner with the reference's methodology and output schema.

Reference (benchmark/benchmark_runner.cpp:106-167, RunSuccinctBenchmark):
1 discarded cold run + `nruns` timed hot runs; per run a TSV row
`name\trun\ttiming\tsizeInBytes\tMemoryAllocationInBytes` where
sizeInBytes is the catalog's total data size before the queries and
MemoryAllocationInBytes after.

Port of adacom_tpu/bench/runner.py. Every benchmark builds its database on
an explicit platform ("cuda", the default, or "cpu"):

    python3 -m adacom_tpu_torch.bench.runner                 # list
    python3 -m adacom_tpu_torch.bench.runner Zipf --scale 0.01 --platform cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

PLATFORMS = ("cuda", "cpu")


class Benchmark:
    name: str = ""
    group: str = "[succinct]"
    nruns: int = 5

    def __init__(self, scale: float = 1.0, platform: str = "cuda"):
        self.scale = scale
        self.platform = platform

    def load(self, state: dict) -> None:  # build DB + workload
        raise NotImplementedError

    def run(self, state: dict) -> None:  # one timed iteration
        raise NotImplementedError

    def verify(self, state: dict) -> Optional[str]:
        return None

    def cleanup(self, state: dict) -> None:
        db = state.get("db")
        if db is not None:
            db.close()


REGISTRY: Dict[str, type] = {}


def register(cls):
    REGISTRY[cls.name] = cls
    return cls


def run_benchmark(cls, scale: float = 1.0, nruns: Optional[int] = None,
                  log=sys.stderr, platform: str = "cuda") -> List[dict]:
    """Run one benchmark; returns the per-run records (hot runs only)."""
    b = cls(scale, platform)
    state: dict = {}
    b.load(state)
    try:
        db = state.get("db")
        size_before = 0
        if db is not None:
            size_before = db.catalog.get_column_segment_catalog().get_total_data_size()
        records = []
        total = (nruns if nruns is not None else b.nruns) + 1
        for run in range(total):
            t0 = time.perf_counter()
            b.run(state)
            timing = time.perf_counter() - t0
            err = b.verify(state)
            if err:
                raise AssertionError(f"{b.name}: verification failed: {err}")
            size_after = 0
            if db is not None:
                size_after = db.catalog.get_column_segment_catalog().get_total_data_size()
            if run == 0:
                continue  # discarded cold run (reference benchmark_runner.cpp:131)
            rec = {
                "name": b.name,
                "run": run,
                "timing": timing,
                "sizeInBytes": size_before,
                "MemoryAllocationInBytes": size_after,
            }
            records.append(rec)
            print(
                f"{rec['name']}\t{run}\t{timing:.6f}\t{size_before}\t{size_after}",
                file=log, flush=True,
            )
    finally:
        # stops a background compaction thread even when a run failed
        b.cleanup(state)
    return records


def main(argv=None):
    from adacom_tpu_torch.bench import clickbench  # noqa: F401 registers
    from adacom_tpu_torch.bench import succinct_benchmarks, tpch  # noqa: F401 registers

    ap = argparse.ArgumentParser(description="adacom_tpu_torch benchmark runner")
    ap.add_argument("pattern", nargs="?", default=None,
                    help="benchmark name or substring (default: list)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale factor vs the reference's sizes")
    ap.add_argument("--nruns", type=int, default=None)
    ap.add_argument("--platform", choices=PLATFORMS, default="cuda",
                    help="device of every benchmark's database")
    args = ap.parse_args(argv)
    if args.pattern is None:
        for name in REGISTRY:
            print(name)
        return 0
    matched = [c for n, c in REGISTRY.items() if args.pattern.lower() in n.lower()]
    if not matched:
        print(f"no benchmark matches {args.pattern!r}", file=sys.stderr)
        return 1
    for cls in matched:
        run_benchmark(cls, scale=args.scale, nruns=args.nruns,
                      platform=args.platform)
    return 0


if __name__ == "__main__":
    # delegate to the canonical module: under `python -m`, this file runs
    # as `__main__`, but benchmark classes register themselves against the
    # `adacom_tpu_torch.bench.runner` instance — using the local REGISTRY
    # here would read an empty duplicate
    from adacom_tpu_torch.bench.runner import main as _main

    sys.exit(_main())
