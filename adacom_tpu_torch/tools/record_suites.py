"""Record every [succinct] benchmark class in the bench runner's TSV schema
(the reference system's runSuccinctBenchmarks.sh -> benchmarks.csv).

Port of tools/record_suites.py as a function, ``run``, over the port's
`bench.runner.run_benchmark` on an explicit platform.

    python3 -m adacom_tpu_torch.tools.record_suites [--scale S] [--nruns N] \\
        [--pattern P] [--platform cuda|cpu] [--out PATH]

--scale defaults to 0.02 (the JAX package's record), --nruns to 2. The TSV
is written to --out; without it, to standard output."""

from __future__ import annotations

import argparse
import io
import sys
from typing import Optional


def run(scale: float = 0.02, nruns: int = 2, pattern: Optional[str] = None,
        platform: str = "cuda", log=sys.stderr) -> list:
    """Run each [succinct] class whose name contains `pattern` (all without
    one) at `scale`, `nruns` hot runs each. Returns the TSV's lines: a
    comment line, then one row per hot run."""
    from adacom_tpu_torch.bench import succinct_benchmarks  # noqa: F401
    from adacom_tpu_torch.bench.runner import REGISTRY, run_benchmark

    rows = [f"# all [succinct] benchmark classes at scale {scale} "
            f"({nruns} hot runs), platform {platform}"]
    for name, cls in REGISTRY.items():
        if getattr(cls, "group", "") != "[succinct]":
            continue
        if pattern and pattern.lower() not in name.lower():
            continue
        print(f"== {name}", file=log, flush=True)
        for rec in run_benchmark(cls, scale=scale, nruns=nruns,
                                 log=io.StringIO(), platform=platform):
            rows.append(f"{rec['name']}\t{rec['run']}\t"
                        f"{rec['timing']:.6f}\t{rec['sizeInBytes']}\t"
                        f"{rec['MemoryAllocationInBytes']}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--nruns", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="TSV path (default: standard output)")
    ap.add_argument("--pattern", default=None,
                    help="only classes whose name contains this")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.scale, args.nruns, args.pattern, args.platform)
    text = "\n".join(rows) + "\n"
    if args.out is None:
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
