"""Run one cell once, traced, with the program's spans laid over the
benchmark's own, and print its result line with a `program` key:

    python3 benchmark/breakdown.py --workload <cell> --seed <n> --seconds <s>

The run is `harness.run_cell` with `--trace 1`, its `trace.Spans` and
`trace.DeviceTrace` replaced by `program_spans.ProgramSpans` and
`program_spans.LaunchTrace` for this process. So the breakdown's idle gaps
name the program span each client was in, and `program` adds:

- `kernels_by_span`: the window's kernels by the innermost program span
  open on the launching thread at the launch (device seconds, count, and
  host seconds inside their launch calls), and `named_pct`, the share of
  the kernel time that a program span names;
- `decode_device_ms`, `scatter_device_ms`: device time per query of the
  kernels launched in scan.decode or scan.filter, and in agg.partials;
- `spans_ms`: per query, each span name's wall and off-CPU ms, and the
  operators' self time;
- `execute_cover_pct`: how much of execute's wall time the spans of the
  work under the operators (scan.*, agg.*) cover, on average;
- `alignment`: where the marker kernel's launch record and its start lie
  after the host mark, on the profiler's wall clock (the marker is warmed
  before the window, which the harness's own trace does not do).

Per query means the profiled SELECTs whose root span ends inside the
window. Needs a CUDA card and a program that records spans."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

PROCESS_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spans_ms(profiles: list) -> dict:
    """Per statement: each span name's mean wall and off-CPU ms (summed
    within a statement), and `self op.X`, an operator's wall less its
    children's."""
    wall, off = defaultdict(int), defaultdict(int)
    for p in profiles:
        spans = p["spans"]
        child = defaultdict(int)
        for sp in spans:
            if sp["end_ns"] is None:
                continue
            w = sp["end_ns"] - sp["start_ns"]
            wall[sp["name"]] += w
            off[sp["name"]] += w - (sp["cpu_end_ns"] - sp["cpu_start_ns"])
            if sp["parent"] is not None:
                child[sp["parent"]] += w
        for sp in spans:
            if sp["name"].startswith("op.") and sp["end_ns"] is not None:
                wall["self " + sp["name"]] += sp["end_ns"] - sp["start_ns"] - child[sp["id"]]
    n = max(1, len(profiles))
    return {k: {"wall": wall[k] / n / 1e6, "off_cpu": off.get(k, 0) / n / 1e6}
            for k in sorted(wall)}


def execute_cover_pct(profiles: list) -> float | None:
    """Mean over statements of the share of execute's wall time covered by
    the outermost spans below it that are not operators."""
    shares = []
    for p in profiles:
        spans = p["spans"]
        by_id = {sp["id"]: sp for sp in spans}
        for ex in spans:
            if ex["name"] != "execute" or ex["end_ns"] is None:
                continue
            covered = 0
            for sp in spans:
                up = by_id.get(sp["parent"])
                if (sp["end_ns"] is None or sp["name"].startswith("op.")
                        or up is None or not (up["name"].startswith("op.") or up is ex)):
                    continue
                while up is not None and up is not ex:
                    up = by_id.get(up["parent"])
                if up is ex:
                    covered += sp["end_ns"] - sp["start_ns"]
            shares.append(covered / max(1, ex["end_ns"] - ex["start_ns"]))
    return 100.0 * sum(shares) / len(shares) if shares else None


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import run  # noqa: F401  (the run's cache paths, set on import)
    from benchmark import harness, program_spans, registry, trace

    if not torch.cuda.is_available():
        print("breakdown: needs a CUDA card", file=sys.stderr)
        return 3
    made = {}

    def spans_for(n):
        made["spans"] = program_spans.ProgramSpans(n)
        return made["spans"]

    def device_trace_for(device):
        made["device"] = program_spans.LaunchTrace(device)
        return made["device"]

    trace.Spans, trace.DeviceTrace = spans_for, device_trace_for
    spec = registry.load_spec()
    result = harness.run_cell(spec, registry.cell(spec, args.workload), args.seed,
                              args.seconds, True, "cuda", PROCESS_START)
    dev, spans = made["device"], made["spans"]
    t0, t1 = dev.mark_host, dev.mark_host + args.seconds
    profiles = program_spans.program_profiles()
    window = [p for p in profiles if p.get("statement") == "SelectStmt" and p["spans"]
              and p["spans"][0]["end_ns"] is not None
              and t0 * 1e9 <= p["spans"][0]["end_ns"] <= t1 * 1e9]
    by_span = program_spans.attribute(dev.kernels, dev.launches, spans, profiles, t0, t1)
    device_s = {k: v["device_s"] for k, v in by_span.items()}
    total = sum(device_s.values())
    n = max(1, len(window))
    unnamed = device_s.get("(no launch record)", 0.0) + device_s.get("(no program span)", 0.0)
    result["program"] = {
        "queries": len(window),
        "kernels_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]["device_s"])),
        "named_pct": 100.0 * (total - unnamed) / total if total else None,
        "decode_device_ms": 1e3 * sum(device_s.get(k, 0.0) for k in program_spans.DECODE) / n,
        "scatter_device_ms": 1e3 * sum(device_s.get(k, 0.0) for k in program_spans.SCATTER) / n,
        "execute_cover_pct": execute_cover_pct(window),
        "spans_ms": spans_ms(window),
        "alignment": dev.alignment,
        "launch_records": len(dev.launches),
        "kernels": len(dev.kernels),
    }
    harness.log(f"alignment {dev.alignment}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
