#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adacom_tpu_torch) once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and a C++ compiler, and
imports nothing of JAX. Phases, one line each, any failure exits non-zero:

1. device: the card's name and power limit, CUDA present;
2. build: the table-scan kernel (csrc/table_scan.cu, nvcc for sm_90a) and
   the native host library, from the checkout's sources;
3. kernel == plain version on the card: every width 1..32 x {plain,
   predicate, min/max, validity plane}, ragged lanes and counts, signed
   minima, empty ranges; the kernel's (sum, count, vmin, vmax) must equal
   scan_table_reference exactly;
4. main path at the reference's scale (zipf_distribution.cpp: 100M
   UINTEGER rows): appender ingest in 8M-row chunks, compaction,
   SELECT count(*), sum(i), a filtered count/sum/min/max, 1,000 Zipf(k=1)
   point lookups, all checked; hot end-to-end scan time;
5. NULLs: count/sum over a 1M-row INTEGER column with a validity mask;
6. timing: the kernel and its plain version at the main path's shape
   (CUDA events), after the launch count of phases 4-5 was read.

The last two lines are the kernels' JSON record and the result line.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

N_ROWS = 100_000_000
CHUNK = 8 << 20
N_LOOKUPS = 1000
NULL_ROWS = 1_000_000
HOT_RUNS = 10


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, t0, detail):
    print(f"[{name}] {detail} ({time.perf_counter() - t0:.2f} s)", flush=True)


def cuda_ms(fn, iters):
    """Mean device milliseconds per call of fn (CUDA events, after warmup)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_vs_plain(dev):
    """Phase 3: every width x variant, kernel against the plain version on
    the same CUDA tensors. Returns (comparisons, max_abs_err)."""
    import numpy as np
    import torch

    from adacom_tpu_torch.ops import bitpack, fused_scan

    rng = np.random.default_rng(0xC0FFEE)
    seg_rows = [65536, 65536, 65536, 40000, 65536 - 13, 777]  # ragged tails
    mins = [0, -4000, 123, -(1 << 31), 1 << 30, -7]           # signed minima
    L = bitpack.lanes_for(max(seg_rows))
    lanes = [bitpack.lanes_for(n) for n in seg_rows]
    n_cmp, max_err = 0, 0
    for width in range(1, 33):
        words = np.zeros((len(seg_rows), width, L), np.uint32)
        valids = np.zeros((len(seg_rows), 1, L), np.uint32)
        for s, n in enumerate(seg_rows):
            codes = (rng.integers(0, 1 << 32, n, dtype=np.uint64)
                     & ((1 << width) - 1)).astype(np.uint32)
            words[s, :, :lanes[s]] = bitpack.pack_numpy(codes, width)
            v = rng.random(n) > (0.0 if s == 1 else 0.3)
            valids[s, :, :lanes[s]] = bitpack.pack_numpy(v.astype(np.uint32), 1)
        w_t = torch.from_numpy(words.view(np.int32)).to(dev)
        v_t = torch.from_numpy(valids.view(np.int32)).to(dev)
        top = (1 << width) - 1
        ranges = [(-3000, 123 + top // 2), (10**12, 10**13),
                  (-(1 << 31) + top // 3, -3500)]
        variants = [("plain", None, None, False, None)]
        variants += [("pred", lo, hi, False, None) for lo, hi in ranges]
        variants += [("minmax", None, None, True, None)]
        variants += [("valid", None, None, False, v_t)]
        variants += [("all", lo, hi, True, v_t) for lo, hi in ranges]
        for name, lo, hi, minmax, vv in variants:
            got = fused_scan.scan_table(w_t, seg_rows, mins, lo, hi,
                                        lanes=lanes, minmax=minmax, valids=vv)
            torch.cuda.synchronize()
            ref = fused_scan.scan_table_reference(
                w_t, seg_rows, mins, lo, hi, lanes=lanes, minmax=minmax,
                valids=vv)
            err = max(abs(a - b) for a, b in zip(got, ref))
            max_err = max(max_err, err)
            n_cmp += 1
            check(got == ref, f"width {width} {name} [{lo}, {hi}]: kernel "
                              f"{got} != plain {ref}")
    return n_cmp, max_err


def main_path(db, con, n_rows, hot_runs, n_lookups):
    """Phase 4: ingest, compact, aggregate, lookups; returns the segments."""
    import numpy as np

    from adacom_tpu_torch import native
    from adacom_tpu_torch.ops import fused_scan

    t0 = time.perf_counter()
    con.query("CREATE TABLE t1(i UINTEGER)")
    app = con.appender("t1")
    for start in range(0, n_rows, CHUNK):
        app.append_column("i", np.arange(start, min(start + CHUNK, n_rows),
                                         dtype=np.uint32))
    app.close()
    t_ingest = time.perf_counter() - t0
    db.catalog.get_column_segment_catalog().compact_all_segments()
    segs = db.catalog.get_table("t1").columns["i"].segments
    packed_bytes = sum(s.footprint_bytes() for s in segs)
    phase("ingest", t0, f"{n_rows} rows in {len(segs)} segments, ingest "
          f"{t_ingest:.2f} s; packed {packed_bytes} B vs plain "
          f"{4 * n_rows} B")

    t0 = time.perf_counter()
    before = fused_scan.KERNEL_LAUNCHES
    sql = "SELECT count(*), sum(i) FROM t1"
    t = time.perf_counter()
    got = con.query(sql).fetchall()
    t_cold = time.perf_counter() - t
    want = [(n_rows, n_rows * (n_rows - 1) // 2)]
    check(got == want, f"{sql}: {got} != {want}")
    check(fused_scan.KERNEL_LAUNCHES > before, f"{sql} skipped the kernel")
    hot = []
    for _ in range(hot_runs):
        t = time.perf_counter()
        got = con.query(sql).fetchall()
        hot.append(time.perf_counter() - t)
        check(got == want, f"{sql} (hot): {got} != {want}")
    t_hot = statistics.median(hot)
    phase("count/sum", t0, f"{tuple(int(x) for x in got[0])} == "
          f"(n, n(n-1)/2); cold (packs "
          f"{len(segs)} segments) {t_cold * 1e3:.1f} ms; hot median of "
          f"{hot_runs} {t_hot * 1e3:.3f} ms = "
          f"{packed_bytes / t_hot / 1e9:.2f} GB/s of packed bytes")

    t0 = time.perf_counter()
    lo, hi = n_rows // 8 + 3, n_rows - n_rows // 8 - 5
    got = con.query(f"SELECT count(i), sum(i), min(i), max(i) FROM t1 "
                    f"WHERE i BETWEEN {lo} AND {hi}").fetchall()
    sel = np.arange(lo, hi + 1, dtype=np.int64)
    want = [(len(sel), int(sel.sum()), lo, hi)]
    check(got == want, f"filtered aggregate: {got} != {want}")
    got = con.query("SELECT count(*), sum(i) FROM t1 WHERE i > 4000000000"
                    ).fetchall()
    check(got[0][0] == 0 and got[0][1] is None, f"empty range: {got}")
    phase("filtered", t0, f"BETWEEN {lo} AND {hi} == numpy; empty range ok")

    t0 = time.perf_counter()
    seed = int(np.random.default_rng(7).integers(0, 1 << 62))
    keys = native.zipf_sample(n_rows, 1.0, seed, n_lookups)
    for v in keys:
        got = con.query(f"SELECT i FROM t1 WHERE i == {int(v)}").fetchall()
        want = [(int(v),)] if v < n_rows else []
        check(got == want, f"lookup {v}: {got}")
    dt = time.perf_counter() - t0
    phase("lookups", t0, f"{n_lookups} Zipf(k=1, seed 7) lookups all hit, "
          f"{dt / n_lookups * 1e3:.3f} ms each")
    return segs


def nulls(db, con, n_rows):
    """Phase 5: count/sum over an INTEGER column with a validity mask."""
    import numpy as np

    from adacom_tpu_torch.ops import fused_scan

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    vals = rng.integers(-(10**6), 10**6, n_rows).astype(np.int32)
    valid = rng.random(n_rows) > 0.1
    con.query("CREATE TABLE t2(i INTEGER)")
    app = con.appender("t2")
    app.append_column("i", vals, valid)
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    before = fused_scan.KERNEL_LAUNCHES
    got = con.query("SELECT count(i), sum(i), count(*) FROM t2").fetchall()
    want = [(int(valid.sum()), int(vals[valid].astype(np.int64).sum()),
             n_rows)]
    check(got == want, f"NULL aggregate: {got} != {want}")
    check(fused_scan.KERNEL_LAUNCHES > before, "NULL query skipped the kernel")
    phase("nulls", t0, f"{tuple(int(x) for x in got[0])} == numpy")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import adacom_tpu_torch as att
    from adacom_tpu_torch import build, native
    from adacom_tpu_torch.ops import fused_scan

    # ---- 1. device ------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    print(smi, flush=True)
    phase("device", t0, f"torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {kind}; {count} device(s)")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.kernels()
    t_kern = time.perf_counter() - t0
    check(native.available(), "native host library did not build")
    t_all = time.perf_counter() - t0
    log_path = [os.path.join(build.BUILD_DIR, f) for f in
                os.listdir(build.BUILD_DIR)
                if f.startswith("libadacom_kernels") and f.endswith(".log")]
    regs, spills = [], []
    for p in log_path:
        with open(p) as f:
            text = f.read()
        regs += [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills += [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
    phase("build", t0, f"kernels {t_kern:.1f} s, native "
          f"{t_all - t_kern:.1f} s; threads/block "
          f"{lib.adacom_table_scan_threads()}; ptxas max registers "
          f"{max(regs) if regs else 'n/a'}, spill stores "
          f"{sum(spills) if spills else 'n/a'} B over {len(regs)} kernels")

    # ---- 3. kernel against its plain version ----------------------------
    t0 = time.perf_counter()
    n_cmp, max_err = kernel_vs_plain(dev)
    phase("kernel==plain", t0, f"{n_cmp} comparisons over widths 1..32, "
          f"all exact (max_abs_err {max_err})")

    # ---- 4./5. main path at 100M rows, then NULLs ------------------------
    db = att.Database(platform="cuda")
    con = db.connect()
    fused_scan.KERNEL_LAUNCHES = 0  # count the main path's launches only
    segs = main_path(db, con, N_ROWS, HOT_RUNS, N_LOOKUPS)
    nulls(db, con, NULL_ROWS)
    launches = fused_scan.KERNEL_LAUNCHES  # the main path's count, read now

    # ---- 6. kernel and plain version at the main path's shape -----------
    t0 = time.perf_counter()
    entries = [(s.reader_arrays()[1][0], s.count, s.packed().min_factor,
                s.packed().n_lanes) for s in segs]
    L = max(e[3] for e in entries)
    words = torch.stack([torch.nn.functional.pad(e[0], (0, L - e[0].shape[1]))
                         for e in entries]).contiguous()
    counts = [e[1] for e in entries]
    mins = [e[2] for e in entries]
    lanes = [e[3] for e in entries]
    got = fused_scan.scan_table(words, counts, mins, lanes=lanes)
    ref = fused_scan.scan_table_reference(words, counts, mins, lanes=lanes)
    check(got == ref, f"main-path shape: kernel {got} != plain {ref}")
    max_err = max(max_err, max(abs(a - b) for a, b in zip(got, ref)))
    # the kernel alone: one launch on the stacked table
    scal, _ = fused_scan._scalars(len(counts), L, counts, mins, None, None,
                                  lanes)
    sc = torch.from_numpy(scal.view(np.int32)).to(dev)
    threads = lib.adacom_table_scan_threads()
    blocks_y = -(-L // threads)
    part = torch.empty((len(counts), blocks_y, 4), dtype=torch.int64,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = lib.adacom_table_scan(words.data_ptr(), sc.data_ptr(), None,
                                   part.data_ptr(), len(counts),
                                   words.shape[1], L, blocks_y, stream)
        check(rc == 0, f"kernel launch failed: CUDA error {rc}")

    ms = cuda_ms(launch, 50)
    wrapper_ms = cuda_ms(lambda: fused_scan.scan_table(
        words, counts, mins, lanes=lanes, device_out=True), 50)
    plain_ms = cuda_ms(lambda: fused_scan.scan_table_reference(
        words, counts, mins, lanes=lanes, device_out=True), 5)
    nbytes = words.numel() * 4
    phase("timing", t0, f"shape {tuple(words.shape)} ({nbytes} B): kernel "
          f"{ms:.4f} ms = {nbytes / ms / 1e6:.1f} GB/s; wrapper (kernel + "
          f"epilogue) {wrapper_ms:.4f} ms; plain version {plain_ms:.3f} ms")
    db.close()

    print(json.dumps({"kernels": [{
        "name": "table_scan",
        "route": "cuda",
        "source": "adacom_tpu_torch/csrc/table_scan.cu",
        "replaces": "adacom_tpu/ops/pallas_scan.py:227",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
