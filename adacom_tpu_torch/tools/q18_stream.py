"""The streamed join -> aggregate pipeline on TPC-H Q18 and Q21: wall time
and peak memory with the aggregate sink fused into the probe loop (ON)
against the streamed join with a materializing aggregate (OFF), each mode
in a fresh process.

Port of tools/q18_stream.py as a function, ``run``. The child imports
this checkout's package by path and runs on the given platform; on the
card it also reports the peak device memory above what the loaded
database held. A child that fails fails the run.

    python3 -m adacom_tpu_torch.tools.q18_stream [--sf SF] \\
        [--platform cuda|cpu] [--out PATH]

SF defaults to 1.0. The markdown table is written only to --out."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHILD = """
import json, resource, sys, threading, time
sys.path.insert(0, sys.argv[1])
import torch
import adacom_tpu_torch as att
from adacom_tpu_torch.bench import tpch


class PeakRss:
    # the peak of this process's resident set, sampled every 5 ms from
    # /proc/self/status (ru_maxrss, and on some kernels VmHWM, keep the
    # peak of the parent that started this process)
    def __init__(self):
        self.mb = 0.0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.poll, daemon=True)
        self.thread.start()

    def read(self):
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    self.mb = max(self.mb, int(line.split()[1]) / 1024)
        return self.mb

    def poll(self):
        while not self.stop.wait(0.005):
            self.read()


try:
    peak = PeakRss()
    peak.read()
except OSError:  # no /proc: the parent's peak may show through
    peak = None


def peak_rss_mb():
    if peak is None:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    return peak.read()


stream, sf, platform = sys.argv[2] == "on", float(sys.argv[3]), sys.argv[4]
data = tpch.generate(sf=sf)
db = att.Database(platform=platform)
db.config.pallas_scan_enabled = False
db.config.streaming_agg_sink_enabled = stream
con = db.connect()
tpch.load_into_engine(con, data)
db.catalog.get_column_segment_catalog().compact_all_segments()
del data
base_rss = peak_rss_mb()
cuda = db.device.type == "cuda"
if cuda:
    torch.cuda.synchronize()
    mark = torch.cuda.memory_allocated(db.device)
    torch.cuda.reset_peak_memory_stats(db.device)
out = {}
for qid in (18, 21):
    con.query(tpch.QUERIES[qid]).fetchall()  # cold
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        con.query(tpch.QUERIES[qid]).fetchall()
        ts.append(time.perf_counter() - t0)
    out[qid] = ts
out["rss_mb"] = peak_rss_mb()
out["base_rss_mb"] = base_rss
out["peak_extra_device_bytes"] = (
    torch.cuda.max_memory_allocated(db.device) - mark if cuda else None)
out["streamed"] = db.dist_stats.get("streamed_join_agg", 0)
db.close()
print("RESULT " + json.dumps(out))
"""


def child(mode: str, sf: float, platform: str) -> dict:
    """One mode ("on" or "off") in a fresh process; raises if it fails."""
    r = subprocess.run([sys.executable, "-c", CHILD, ROOT, mode, str(sf),
                        platform], capture_output=True, text=True)
    for line in r.stdout.splitlines():
        if line.startswith("RESULT ") and r.returncode == 0:
            return json.loads(line[7:])
    raise RuntimeError(f"q18_stream child ({mode}) failed with exit code "
                       f"{r.returncode}:\n{r.stdout[-2000:]}\n"
                       f"{r.stderr[-2000:]}")


def table(on: dict, off: dict, sf: float, device: str) -> list:
    """The markdown table's lines."""
    lines = [f"# Streamed join->aggregate sink: TPC-H Q18/Q21 (SF {sf:g}, "
             f"{device})",
             "",
             "5 hot runs each, fresh process per mode; peak RSS of the",
             "child, sampled every 5 ms, after the timed runs (after the",
             "load shown for scale).",
             "", "| metric | agg sink fused (ON) | streamed join, "
             "materializing agg (OFF) |", "|---|---|---|"]
    for qid in ("18", "21"):
        a, b_ = on[qid], off[qid]
        lines.append(f"| Q{qid} mean (s) | {np.mean(a):.3f} | "
                     f"{np.mean(b_):.3f} |")
        lines.append(f"| Q{qid} min..max | {min(a):.3f}..{max(a):.3f} "
                     f"| {min(b_):.3f}..{max(b_):.3f} |")
    lines.append(f"| peak RSS (MB) | {on['rss_mb']:.0f} | "
                 f"{off['rss_mb']:.0f} |")
    lines.append(f"| RSS after load (MB) | {on['base_rss_mb']:.0f} "
                 f"| {off['base_rss_mb']:.0f} |")
    if on["peak_extra_device_bytes"] is not None:
        lines.append(f"| peak extra device memory (B) | "
                     f"{on['peak_extra_device_bytes']} | "
                     f"{off['peak_extra_device_bytes']} |")
    lines.append(f"| streamed_join_agg hits | {on['streamed']} | "
                 f"{off['streamed']} |")
    return lines


def run(sf: float = 1.0, platform: str = "cuda",
        out: Optional[str] = None) -> dict:
    """Both modes, each in its own process. Returns {"on", "off" (each
    child's record: per query the 5 hot seconds, rss_mb, base_rss_mb,
    peak_extra_device_bytes, streamed), "lines" (the markdown)}; writes
    the markdown to `out` if given."""
    from adacom_tpu_torch.main.database import resolve_device
    from adacom_tpu_torch.tools import device_name

    resolve_device(platform)  # no card: raise before starting a child
    on = child("on", sf, platform)
    off = child("off", sf, platform)
    lines = table(on, off, sf, device_name(platform))
    if out is not None:
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return {"on": on, "off": off, "lines": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None,
                    help="markdown path (default: none)")
    args = ap.parse_args(argv)
    print("\n".join(run(args.sf, args.platform, args.out)["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
