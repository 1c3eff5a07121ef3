#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adacom_tpu_torch) once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and a C++ compiler, and
imports nothing of JAX. Phases, one line each, any failure exits non-zero:

1. device: the card's name and power limit, CUDA present;
2. build: the kernels (csrc/*.cu, one nvcc per source, for sm_90a) and
   the native host library, from the checkout's sources; then phase 17;
3. kernels == plain versions on the card, every comparison exact:
   - table scan (B1): every width 1..32 x {plain, predicate, min/max,
     validity plane}, ragged lanes and counts, signed minima, empty ranges;
   - grouped scan (B2): group widths 1..32 x value widths {1, 7, 16, 31,
     32} and value widths 1..32 x group widths {1, 3, 4}, ragged counts
     and lanes, signed minima, group ids outside the domain, ranges empty
     for all or some segments;
   - multi grouped scan (B3): 0..6 group planes with mixed strides, 1..8
     value planes with width-0 and width-32 planes, monomials of degree
     1..3, 1/6/16 groups, predicates on 0..8 planes, emptied segments;
   - the edges of the kernel's design, for both: every kept row of a warp
     in one group, 16 groups across a warp, terms of 0xFFFFFFFF on every
     row (sums far past 2^32), 16 groups x 33 outputs (the warp-aggregated
     accumulation; both accumulation modes must run), 300 segments of
     ragged lanes (not a multiple of the 128-lane tile or of the grid), a
     stack narrower than the others, a single segment;
4. main path at the reference's scale (zipf_distribution.cpp: 100M
   UINTEGER rows): appender ingest in 8M-row chunks, compaction,
   SELECT count(*), sum(i), a filtered count/sum/min/max, 1,000 Zipf(k=1)
   point lookups, all checked; hot end-to-end scan time; then NULLs:
   count/sum over a 1M-row INTEGER column with a validity mask (B1);
5. TPC-H Q1 and Q6 at scale factor 10 (B3): the 7 lineitem columns the
   two queries read (~60M rows), compaction, cold and hot times, each
   answer held against the host tier and against numpy;
6. grouped aggregate (B2): 100M rows of t3(g INTEGER, v INTEGER), 12
   groups, a plain and a filtered GROUP BY held against numpy;
   b. SQL NULL semantics of GROUP BY: t3's NULL-free count/sum/avg still
   launches B2 and equals numpy; t5(g INTEGER, v INTEGER), 50M rows from a seed, 12 keys
   plus 5% NULL keys, one key whose v is all NULL and 10% NULL v elsewhere;
   GROUP BY g with count(*), count(v), sum, min, max and avg against numpy
   on the generic device path (50M rows), the host aggregate and 4
   virtual shards of the card (an 8M-row prefix each), each route printed
   as dist_stats and the launch counters show it;
7. timing: each kernel alone, its wrapper and its plain version at its
   main path's shape (CUDA events), after the launch counts were read,
   with its bound (the bytes it must move at 3.35 TB/s) and its share of
   the read bandwidth phase 10a measured. No single PyTorch
   call unpacks the vertical-lane layout, so `library_ms` is null;
8. the generic device path (PyTorch tensor ops, no kernel of its own):
   a. every codec (constant, rle, delta, dictionary, alp) decodes on the
      card to the host values bit for bit at 1, 4,097, 65,535 and 65,536
      rows (whole segment, gather, a pool of two);
   b. t4: 50M rows of (k BIGINT, r INTEGER, d INTEGER, f DOUBLE,
      c INTEGER) compacted with compression_codec='auto' (delta, rle,
      dictionary, alp, succinct on every segment); the ungrouped
      aggregate over all five columns, a 1,000-group GROUP BY (also on the
      host aggregate, one run), a filtered aggregate, a device scan
      (host_materialize=false) against the host tier, DELETE ... WHERE
      and the aggregate again, all against numpy;
   c. t1 (phase 4's table) after one adaptive policy step: count/sum over
      plain and packed segments.
   Each query prints its hot latency (median of 10 after a cold run), the
   device time and kernels of one hot run (torch.profiler), its peak
   extra device memory over the cold and hot runs, pool cache included
   (at most 4 GiB), and the generic-path counter (device_scan.RUNS, set
   to 0 before the cold run; it must be > 0). After t4's queries the pool
   cache holds at most t4's encoded bytes;
9. the relational path at the reference's TPC-H scale: all eight tables
   of bench/tpch.py at scale factor 1 (~8.6M rows) in a database on the
   card, and the same data in sqlite3 (with indexes) in a subprocess
   started at the top of the phase, which computes every oracle answer
   once while the engine loads and queries. All 22 queries on plain
   segments, compacted with host_materialize=true (the host copies feed
   the joins) and with host_materialize=false (the device scan feeds
   them), each equal to sqlite's; for the two compacted runs each query
   prints its cold time, one hot run, the device time and kernels of
   another hot run and its routes (the streamed join, streamed aggregate
   and index join counters, the generic path's runs, the B1/B2/B3
   launches); Q1 and Q6 must launch B3. Then a
   window query over orders, UNION/EXCEPT/INTERSECT, DISTINCT, FROM-less
   SELECTs, (VALUES ...) joined to nation and samples, against sqlite; a
   join and sorts under a memory_limit that makes them spill, against
   their answers in RAM; the pool cache's bytes and the phase's peak
   extra device memory (at most 4 GiB each);
10. the benchmark surface:
   a. roofline (tools/roofline.py), run after phase 3 so that the B1
      timing line can give its share: the card's read and copy bandwidth
      over 2 GiB, B1 at 64M rows of width 16 (lean and with a predicate,
      alone and through scan_table) and the torch decode path, every
      answer against NumPy;
   b. bench/headline.py (the bench.py twin) at 100M rows: its JSON line,
      every lookup run verified, the scan's answer, B1 launched >= 20 times;
   c. the 18 [succinct] classes through the bench runner at scale 0.01,
      one hot run each, each verified; then ZipfOverTime's lookups each
      checked while its background compaction runs, the thread stopped;
   d. ClickBench's 43 queries (tools/clickbench_run.py) at CB_SCALE, each
      answer equal to sqlite's, computed in a subprocess; per query its
      cold time, one hot run and the cold run's launches.
   The sqlite oracles of phases 9 and 10d start after B1's timing and
   after phase 8 respectively, so they compute while phases 5-10c run;
11. durable databases and the client surface, right after phase 9, on
   phase 9's generated tables and sqlite answers, in a temporary directory
   removed at the end:
   a. Database(path=...) on the card: the eight tables through the
      appender, every batch logged; load seconds, WAL bytes and the
      checkpoints the 64 MiB threshold set off;
   b. compaction and CHECKPOINT: seconds, bytes of ckpt-<n>/, a WAL of 0 B;
   c. close() (one more checkpoint) and a reopen on the card: seconds;
      every segment's state, codec, rows and bytes equal b's;
   d. the 22 queries, one cold and one hot run each, equal to sqlite; Q1
      and Q6 launch B3; a filtered count/min/max over l_shipdate launches
      B1, equal to numpy; peak extra device memory at most 4 GiB;
   e. committed transactions (100,000 appended rows and a DELETE; an
      UPDATE; a 3-row INSERT) and a rolled-back one; a copy of the open
      directory (a crash) reopens to the live answers (count, Q1, Q6, Q3)
      without the rolled-back change; with the last record torn it
      reopens to the state before the INSERT; an aborted checkpoint raises
      CheckpointAbort and a reopen gives the live answers;
   f. COPY (SELECT ...) TO csv, read_csv into a table (a Q6-style
      aggregate equal to lineitem's), read_json, dbapi.connect on the copy
      (Q6), `python3 -m adacom_tpu_torch` on a second copy with Q6 piped
      in, and Q6 under PRAGMA tpu_profile_start/stop, in this process
      (11d) and in a fresh one (the shell with SQL arguments on a copy
      made in 11d): each trace's device events and whether B3's kernel is
      named in it.

12. the multi-device layer, right after phase 11, on phase 9's tables and
   sqlite answers:
   a. adacom_tpu_torch.graft_entry: dryrun_multichip(4) on 4 virtual
      shards of the card (SQL on Database(mesh=...), the scan-aggregate,
      the all_to_all group-by, the combiner, the shuffle join, top-k and
      the hash, each against NumPy), and entry() (B1) against its plain
      version;
   b. Database(mesh=make_virtual_mesh(4, card)), default config: the
      eight tables at SF 1, compacted, the 22 queries (a cold and a hot
      run each) equal to sqlite's; the distributed scan-aggregate and the
      shuffle join ran (dist_stats), B1-B3 launched 0 times (the JAX
      package declines them under a mesh); the peak extra device memory
      under 16 GiB; each query's hot ms beside phase 9's. The times are
      four shards' loop and copies on one card, not scaling.

13. the tools (adacom_tpu_torch/tools, utils/warmup.py), after phase 10d,
   at cut sizes (PERF.md section 4):
   a. Database() on the card in a fresh process starts the warm-up thread;
      ensure_transfer_warm() returns with the kernel library loaded;
   b. fuzz_differential, 300 random SELECTs (seed 0) on the host route
      and on the device route, each against sqlite (answers computed by a
      subprocess started before phase 10), on the NULL-free table and on
      one with 10% of each column NULL (--nulls 0.1): 0 divergences, the
      device route through the generic path, and every dense GROUP BY
      wider than the fused tiers' on the host aggregate on the host route
      and on the generic path on the device route;
   c. fuzz_dml, 200 random DML ops (seed 0) in memory on both routes and
      durable with a crash and a reopen: the final state equals sqlite's;
   d. verify_sf1 and tpch_sf1 at TPC-H SF 0.05: 22/22 equal to sqlite, Q1
      and Q6 launch B3;
   e. grouped_agg_bench at 8M rows (B2), string_bench at 200,000 strings,
      adaptive_overtime at 4M rows for 6 s (at least one policy round, the
      thread stopped), record_suites for the ZipfScanOOM classes at scale
      0.001 (each run verified) and q18_stream at SF 0.05 (the streamed
      counter > 0 with the sink, 0 without).

14. the port's repairs of wrong answers of the JAX package (ROADMAP's
   record of the faults the port repairs; PERF.md section 6):
   a. after phase 6b, on t1 and t3: a filtered aggregate whose lower
      bound is a negative literal launches B1 (t1) resp. B2 (t3) exactly
      once and equals numpy, as the same query with a bound of 0 does;
   b. after phase 13: a 5M-row table (k INTEGER, s VARCHAR, p
      DECIMAL(12,2)): UPDATE ... SET s = 'x', p = p + 0.01 WHERE k % 7 = 0
      with its WHERE on the device path equals numpy; an UPDATE violating
      a UNIQUE index raises and changes neither the table nor the index;
   c. lineitem at SF 0.05 written with COPY TO and read back with COPY FROM
      into the DECIMAL schema: its values equal the generated ones, and
      Q1 and Q6 (B3) equal the appender-loaded table's exactly;
   d. a correlated NOT IN over 1M outer rows with NULLs on both sides
      equals sqlite.

15. committed writes under concurrency (adacom_tpu_torch/tools/
   txn_stress.py at its defaults), after phase 14: a durable database on
   the card checkpointing itself every 32 MiB of WAL; four threads append
   5M rows into w(id BIGINT, v INTEGER) through autocommit appenders in
   batches of 100,000, one runs 50 UPDATEs over a 1M-row u, one runs 20
   transactions on x (100,000 rows appended and a tenth of x deleted each,
   COMMIT and ROLLBACK in turn) while another connection's autocommit
   INSERT into x must raise, one runs CHECKPOINT and counts the refusals;
   then `crash(db)` and a reopen: each table's count(*) and sum(v) equal a
   numpy model of the acknowledged operations, at least one automatic
   checkpoint ran while the writers did, and after compaction count(*),
   sum(v) over w launches B1.

16. the routing defaults (adacom_tpu_torch/tools/route_sweep.py), after
   phase 15, at cut sizes (the full sweep is its own command): the dense
   GROUP BY over 262,144, 1M and 8M rows (device_agg_min_rows, 524,288,
   lies between the first two), domains of 1,024 and 100,000 keys, on the
   host aggregate and the generic device path; t1 (100M UINTEGER rows)
   scanned over 1, 8 and 64 whole segments with host_materialize=false on
   the host tier and the device scan, and under the defaults; every answer
   equal to numpy, each route the one forced, one line per point with the
   route each default takes.

17. the native host library (native/adacom_native.cpp, built for this
   host with -march=native), right after phase 2: every function of
   adacom_tpu_torch/native.py against its NumPy path on the same inputs of
   NATIVE_ROWS elements (adacom_tpu_torch/tools/native_check.py): pack and
   unpack at six widths, gather, the equality filters on plain and packed
   words, groupby, grouped sums, the radix argsort, the hash join, the
   range filters, the row gather and an FSST round trip. Any difference
   fails the run.

The depths of phases 6b, 8b, 9, 10d, 13d-e, 14b-c and 15 were cut so
that the command keeps a margin under its time limit (PERF.md section 4).
Each main path (4, 5, 6, 6b, 9, 10b-d, 11, 12b, 13, 14a, 14b-d, 15, 16) runs with the launch counts
set to 0 just before it and read just after. The last two lines are the
kernels' JSON record and the result line. `python3 chip_smoke.py
--tpch-oracle SF`, `--clickbench-oracle SCALE` and `--fuzz-oracle SEED`
are the sqlite subprocesses (no card needed).
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
TPCH_SF = 10
T3_ROWS = 100_000_000
T3_GROUPS = 12
T4_ROWS = 50_000_000
T4_GROUPS = 1000
CODEC_COUNTS = (1, 4097, 65535, 65536)
PEAK_EXTRA_LIMIT = 4 << 30  # the generic path's extra device memory
# the lineitem columns TPC-H Q1 and Q6 read
Q16_COLUMNS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
               "l_returnflag", "l_linestatus", "l_shipdate"]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


T_START = time.perf_counter()


def phase(name, t0, detail):
    now = time.perf_counter()
    print(f"[{name}] {detail} ({now - t0:.2f} s; {now - T_START:.0f} s into "
          f"the command)", flush=True)


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


def _pack_stack(codes_per_seg, width, L):
    """(n_seg, width, L) uint32 words of per-segment code arrays."""
    import numpy as np

    from adacom_tpu_torch.ops import bitpack

    out = np.zeros((len(codes_per_seg), width, L), np.uint32)
    for s, codes in enumerate(codes_per_seg):
        out[s, :, :bitpack.lanes_for(len(codes))] = \
            bitpack.pack_numpy(codes, width)
    return out


def _group_codes(rng, seg_rows, width, n_groups):
    """Codes mostly inside [0, n_groups] plus 5% at random full width
    (ids far outside the domain)."""
    import numpy as np

    top = (1 << width) - 1
    segs = []
    for n in seg_rows:
        c = rng.integers(0, min(top, n_groups + 1), n, endpoint=True,
                         dtype=np.uint64)
        wide = rng.random(n) < 0.05
        c[wide] = rng.integers(0, top, int(wide.sum()), endpoint=True,
                               dtype=np.uint64)
        segs.append(c.astype(np.uint32))
    return segs


def _value_codes(rng, seg_rows, width):
    import numpy as np

    return [rng.integers(0, 1 << width, n, dtype=np.uint64).astype(np.uint32)
            for n in seg_rows]


def _ragged_rows(rng, n_seg):
    """Row counts of n_seg segments, most of them not a multiple of a
    128-lane tile (lanes = ceil(rows / 32))."""
    return [int(x) for x in rng.integers(1, 65536, n_seg, endpoint=True)]


def _grouped_edges(rng):
    """B2 cases at the edges of the kernel's accumulation and geometry:
    (label, seg_rows, gw, group codes, vw, value codes, gmins, vmins,
    n_groups, ranges)."""
    import numpy as np

    M32 = 0xFFFFFFFF
    full = [65536] * 3
    yield ("one group, codes 0xFFFFFFFF, every row kept", full, 2,
           [np.full(n, 3, np.uint32) for n in full], 32,
           [np.full(n, M32, np.uint32) for n in full], [0, 0, 0],
           [0, -(1 << 31), 1 << 30], 16, [(None, None)])
    rows = [65536, 40000, 777]
    yield ("16 groups across a warp", rows, 4,
           [(np.arange(n) % 16).astype(np.uint32) for n in rows], 21,
           _value_codes(rng, rows, 21), [0, 0, 0], [-(10**6)] * 3, 16,
           [(None, None), (-1000, 10**6)])
    rows = _ragged_rows(rng, 300)
    yield ("300 ragged segments", rows, 4, _group_codes(rng, rows, 4, 12), 21,
           _value_codes(rng, rows, 21), [0] * len(rows),
           [-(10**6)] * len(rows), 12,
           [(None, None), (125_000, 400_000)])
    rows = [50001]
    yield ("a single segment", rows, 4, _group_codes(rng, rows, 4, 12), 21,
           _value_codes(rng, rows, 21), [0], [-(10**6)], 12,
           [(None, None), (-5, 5000)])


def grouped_vs_plain(dev, seg_rows=(65536, 65536, 40000, 65536 - 13, 777)):
    """Phase 3, B2: the grouped scan against its plain version on the same
    CUDA tensors: a sweep of widths, then the edge cases. Returns
    (comparisons, max_abs_err, accumulator modes run)."""
    import numpy as np
    import torch

    from adacom_tpu_torch.ops import bitpack, grouped_scan

    rng = np.random.default_rng(0xB2)
    lanes = [bitpack.lanes_for(n) for n in seg_rows]
    L = max(lanes)
    gmins = [0, 2, -1, 0, 5][:len(seg_rows)]      # rebased; -1 drops code 0
    vmins = [0, -4000, 123, -(1 << 31), 1 << 30][:len(seg_rows)]
    combos = [(gw, vw) for gw in range(1, 33) for vw in (1, 7, 16, 31, 32)]
    combos += [(gw, vw) for vw in range(1, 33) for gw in (1, 3, 4)]
    cases = []
    for k, (gw, vw) in enumerate(combos):
        top = (1 << vw) - 1
        n_groups = (1, 6, 12, 16)[k % 4]
        cases.append((f"gw {gw} vw {vw}", list(seg_rows), gw,
                      _group_codes(rng, seg_rows, gw, n_groups), vw,
                      _value_codes(rng, seg_rows, vw), gmins, vmins,
                      n_groups, [(None, None), (-3000, 123 + top // 2),
                                 (10**12, 10**13),
                                 (-(1 << 31) + top // 3, -3500)]))
    n_cmp, max_err, modes = 0, 0, set()
    for case in cases + list(_grouped_edges(rng)):
        label, rows, gw, gc, vw, vc, gm, vm, n_groups, ranges = case
        lanes = [bitpack.lanes_for(n) for n in rows]
        L = max(lanes)
        g_t = torch.from_numpy(_pack_stack(gc, gw, L).view(np.int32)).to(dev)
        v_t = torch.from_numpy(_pack_stack(vc, vw, L).view(np.int32)).to(dev)
        modes.add(grouped_scan.prepare_grouped(
            g_t, v_t, rows, gm, vm, n_groups, lanes=lanes)[0].private)
        for lo, hi in ranges:
            args = (g_t, v_t, rows, gm, vm, n_groups, lo, hi, lanes)
            got = grouped_scan.grouped_scan_table(*args)
            torch.cuda.synchronize()
            ref = grouped_scan.grouped_scan_table_reference(*args)
            max_err = max(max_err, int(np.abs(got - ref).max()))
            n_cmp += 1
            check(np.array_equal(got, ref),
                  f"B2 {label} G {n_groups} [{lo}, {hi}]: kernel "
                  f"{got.tolist()} != plain {ref.tolist()}")
    return n_cmp, max_err, modes


def _multi_case(rng, k, seg_rows, L):
    """One B3 shape of the sweep: cycles group planes 0..6, value planes
    1..8, groups {1, 6, 16}; widths include 0 and 32."""
    import numpy as np

    from adacom_tpu_torch.ops import bitpack, grouped_scan

    n_gp, n_vp = k % 7, 1 + k % 8
    n_groups = (1, 6, 16)[k % 3]
    gws = [int(rng.choice([0, 1, 2, 3, 32], p=[.15, .3, .3, .2, .05]))
           for _ in range(n_gp)]
    vws = [int(rng.choice([0, 1, 5, 13, 20, 32])) for _ in range(n_vp)]
    vws[k % n_vp] = 32 if k % 2 else 0
    strides = [int(rng.integers(0, 9)) for _ in range(n_gp)]
    monos = [tuple(int(p) for p in rng.integers(0, n_vp, int(rng.integers(1, 4))))
             for _ in range(int(rng.integers(0, 6)))]
    n_pred = 8 if k % 5 == 0 else int(rng.integers(0, n_vp + 1))
    preds = [int(p) for p in rng.permutation(max(n_vp, n_pred))[:n_pred]
             % n_vp]
    n_seg = len(seg_rows)
    scal = np.zeros((n_seg, grouped_scan.SCAL_COLS), np.uint32)
    scal[:, grouped_scan._SC_COUNT] = seg_rows
    scal[:, grouped_scan._SC_LORIG] = [bitpack.lanes_for(n) for n in seg_rows]
    gst, vst = [], []
    for j, w in enumerate(gws):
        scal[:, grouped_scan._SC_GMIN + j] = rng.integers(0, 3, n_seg)
        gst.append(_pack_stack(_group_codes(rng, seg_rows, w, 3), w, L)
                   if w else None)
    for p, w in enumerate(vws):
        scal[:, grouped_scan._SC_VMIN + p] = rng.choice(
            [0, 7, 999, (1 << 31) + 5], n_seg)
        vst.append(_pack_stack(_value_codes(rng, seg_rows, w), w, L)
                   if w else None)
    for q, p in enumerate(preds):
        top = (1 << max(vws[p], 1)) - 1
        scal[:, grouped_scan._SC_PRED + 2 * q] = rng.integers(0, top // 3 + 1,
                                                               n_seg)
        scal[:, grouped_scan._SC_PRED + 2 * q + 1] = rng.integers(
            top // 2, top, n_seg, endpoint=True)
    if not any(w for w in gws + vws):
        vws[0] = 5
        vst[0] = _pack_stack(_value_codes(rng, seg_rows, 5), 5, L)
    return gst, vst, scal, n_groups, strides, monos, preds


def _multi_edge(rng, seg_rows, gplanes, vplanes, n_groups, monos, preds,
                g_lanes=None):
    """One B3 case from per-plane (width, codes per segment, minimum) lists:
    strides make a dense id over the group planes; each predicate keeps
    most codes of its plane. A group stack may be cut to g_lanes lanes
    (narrower than the value stacks: its missing lanes read as code 0)."""
    import numpy as np

    from adacom_tpu_torch.ops import bitpack, grouped_scan

    L = max(bitpack.lanes_for(n) for n in seg_rows)
    scal = np.zeros((len(seg_rows), grouped_scan.SCAL_COLS), np.uint32)
    scal[:, grouped_scan._SC_COUNT] = seg_rows
    scal[:, grouped_scan._SC_LORIG] = [bitpack.lanes_for(n) for n in seg_rows]
    gst, strides, radix = [], [], 1
    for j, (w, codes, gmin) in enumerate(gplanes):
        scal[:, grouped_scan._SC_GMIN + j] = gmin
        stack = _pack_stack(codes, w, L)
        gst.append(stack[:, :, :g_lanes] if g_lanes else stack)
        strides.append(radix)
        radix *= 1 + max(int(c.max()) for c in codes) + gmin
    vst = []
    for p, (w, codes, vmin) in enumerate(vplanes):
        scal[:, grouped_scan._SC_VMIN + p] = vmin
        vst.append(_pack_stack(codes, w, L))
    for q, p in enumerate(preds):
        top = (1 << vplanes[p][0]) - 1
        scal[:, grouped_scan._SC_PRED + 2 * q] = int(rng.integers(0, top // 8 + 1))
        scal[:, grouped_scan._SC_PRED + 2 * q + 1] = top - top // 8
    return gst, vst, scal, n_groups, strides, monos, preds


def _multi_edges(rng):
    """(label, B3 case) at the edges of the kernel's accumulation and
    geometry; the 16-group, 32-monomial shapes run the warp-aggregated
    mode, the others private slots."""
    import numpy as np

    M32 = 0xFFFFFFFF
    full = [65536] * 2
    one = [(2, [np.full(n, 1, np.uint32) for n in full], 2)]  # group id 3
    top = [(32, [np.full(n, M32, np.uint32) for n in full], 0)] * 3
    small = ((0,), (0, 1), (0, 1, 2), (2,))
    wide = tuple(((0,), (0, 1), (0, 1, 2))[k % 3] for k in range(32))
    yield ("one group, terms 0xFFFFFFFF, every row kept",
           _multi_edge(rng, full, one, top, 4, small, ()))
    yield ("one group, terms 0xFFFFFFFF, every row kept, 16 x 33",
           _multi_edge(rng, full, one, top, 16, wide, ()))
    rows = [65536, 40000, 777]
    spread = [(4, [(np.arange(n) % 16).astype(np.uint32) for n in rows], 0)]
    vals = [(w, _value_codes(rng, rows, w), vmin)
            for w, vmin in ((32, 0), (5, 7), (13, 999), (20, 1), (1, 0),
                            (32, 5), (7, 0), (3, 1))]
    yield ("16 groups across a warp",
           _multi_edge(rng, rows, spread, vals[:2], 16, ((0,), (0, 1)), (1,)))
    monos = tuple(tuple(int(p) for p in rng.integers(0, 8, 1 + k % 3))
                  for k in range(32))
    yield ("16 groups across a warp, 16 x 33",
           _multi_edge(rng, rows, spread, vals, 16, monos, (1, 2, 4)))
    q1_monos = ((0,), (1,), (1, 2), (1, 3), (1, 2, 3), (2,))
    for label, rows, g_lanes in (
            ("300 ragged segments, a narrower group stack",
             _ragged_rows(rng, 300), 1900),
            ("a single segment", [50001], None)):
        gp = [(2, [rng.integers(0, 3, n).astype(np.uint32) for n in rows], 0),
              (1, [rng.integers(0, 2, n).astype(np.uint32) for n in rows], 0)]
        vp = [(w, _value_codes(rng, rows, w), vmin)
              for w, vmin in ((6, 1), (20, 90000), (4, 0), (4, 0), (12, 8000))]
        yield (label, _multi_edge(rng, rows, gp, vp, 6, q1_monos, (4,),
                                  g_lanes))


def multi_vs_plain(dev, n_cases=56,
                   seg_rows=(65536, 40000, 777, 65536 - 13)):
    """Phase 3, B3: the multi grouped scan against its plain version on the
    same CUDA tensors: a sweep of shapes, each also with a segment emptied
    (count 0, as the executor saturates an empty range), then the edge
    cases. Returns (comparisons, max_abs_err, accumulator modes run)."""
    import numpy as np
    import torch

    from adacom_tpu_torch.ops import bitpack, grouped_scan

    rng = np.random.default_rng(0xB3)
    L = max(bitpack.lanes_for(n) for n in seg_rows)
    cases = [(f"case {k}", _multi_case(rng, k, seg_rows, L))
             for k in range(n_cases)]
    n_sweep = len(cases)
    cases += list(_multi_edges(rng))
    n_cmp, max_err, kept, modes = 0, 0, 0, set()
    for i, (label, case) in enumerate(cases):
        gst, vst, scal, n_groups, strides, monos, preds = case
        g_t = [None if a is None else torch.from_numpy(a.view(np.int32)).to(dev)
               for a in gst]
        v_t = [None if a is None else torch.from_numpy(a.view(np.int32)).to(dev)
               for a in vst]
        modes.add(grouped_scan.prepare_multi(g_t, v_t, scal, n_groups, strides,
                                             monos, preds).private)
        variants = [scal]
        if i < n_sweep:
            emptied = scal.copy()
            emptied[1, grouped_scan._SC_COUNT] = 0
            emptied[1, grouped_scan._SC_PRED:] = 0
            variants.append(emptied)
        for sc in variants:
            args = (g_t, v_t, sc, n_groups, strides, monos, preds)
            got = grouped_scan.multi_grouped_scan_table(*args)
            torch.cuda.synchronize()
            ref = grouped_scan.multi_grouped_scan_table_reference(*args)
            max_err = max(max_err, int(np.abs(got - ref).max()))
            kept += int(ref[:, -1].sum())
            n_cmp += 1
            check(np.array_equal(got, ref),
                  f"B3 {label} (groups {[None if a is None else a.shape[1] for a in gst]}"
                  f" strides {strides} values "
                  f"{[None if a is None else a.shape[1] for a in vst]} monos "
                  f"{monos} preds {preds} G {n_groups}): kernel "
                  f"{got.tolist()} != plain {ref.tolist()}")
            if i >= n_sweep:
                check(ref[:, -1].sum() > 0, f"B3 {label}: no row kept")
    check(kept > 0, "B3 sweep: no row passed any predicate")
    return n_cmp, max_err, modes


class Recorder:
    """Wraps a module-level entry point and keeps the arguments of each
    call while on (the call itself goes through unchanged)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls = []
        self.on = False

        def record(*args, **kw):
            if self.on:
                self.calls.append((args, kw))
            return self.real(*args, **kw)

        setattr(module, name, record)

    def restore(self):
        setattr(self.module, self.name, self.real)


def _close(a, b, rel):
    return abs(a - b) <= rel * max(1.0, abs(b))


def _same_rows(got, want, what):
    """Integers and counts identical; floats within 1e-9 relative."""
    check(len(got) == len(want), f"{what}: {len(got)} rows != {len(want)}")
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(x, float):
                check(_close(x, y, 1e-9), f"{what}: {g} != {w}")
            else:
                check(x == y, f"{what}: {g} != {w}")


def _tpch_oracle(li):
    """TPC-H Q1 and Q6 in numpy over the generated arrays: Q1 as
    {(rf, ls): (sum_qty, sum_base, sum_disc_price, sum_charge, count)}
    in scaled integers (scales 2, 2, 4, 6), Q6 as the scaled (4) sum."""
    import numpy as np

    from adacom_tpu_torch.sql.binder import days_from_iso

    qty, price = li["l_quantity"], li["l_extendedprice"]
    disc, tax, ship = li["l_discount"], li["l_tax"], li["l_shipdate"]
    rf = np.frombuffer(li["l_returnflag"].astype("S1"), np.uint8)
    ls = np.frombuffer(li["l_linestatus"].astype("S1"), np.uint8)
    m = ship <= days_from_iso("1998-09-02")
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    q1 = {}
    for f in sorted(set(np.unique(rf[m]).tolist())):
        for s_ in sorted(set(np.unique(ls[m]).tolist())):
            sel = m & (rf == f) & (ls == s_)
            if sel.any():
                q1[(chr(f), chr(s_))] = (
                    int(qty[sel].sum()), int(price[sel].sum()),
                    int(disc_price[sel].sum()), int(charge[sel].sum()),
                    int(sel.sum()))
    m6 = ((ship >= days_from_iso("1994-01-01"))
          & (ship < days_from_iso("1995-01-01"))
          & (disc >= 5) & (disc <= 7) & (qty < 2400))
    return q1, int((price[m6] * disc[m6]).sum())


def tpch_path(hot_runs):
    """Phase 5: lineitem at SF 10 (7 columns), compaction, Q1 and Q6 cold
    and hot, held against the host tier and numpy. Returns the timings and
    the B3 calls of one hot Q1 and one hot Q6."""
    import numpy as np

    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import tpch
    from adacom_tpu_torch.ops import grouped_scan

    t0 = time.perf_counter()
    li = tpch.generate_lineitem(TPCH_SF)
    li = {c: li[c] for c in Q16_COLUMNS}
    n = len(li["l_quantity"])
    t_gen = time.perf_counter() - t0
    db = att.Database(platform="cuda")
    con = db.connect()
    ddl = tpch.DDL["lineitem"]
    cols_sql = ", ".join(
        part for part in ddl[ddl.index("(") + 1:-1].split(", ")
        if part.split()[0] in Q16_COLUMNS)
    con.query(f"CREATE TABLE lineitem({cols_sql})")
    app = con.appender("lineitem")
    for start in range(0, n, CHUNK):
        app.append_columns({c: a[start:start + CHUNK] for c, a in li.items()})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    table = db.catalog.get_table("lineitem")
    n_seg = len(table.columns["l_quantity"].segments)
    phase("tpch-load", t0, f"SF {TPCH_SF} lineitem: {n} rows, {n_seg} "
          f"segments per column, columns {Q16_COLUMNS} (the 8 that neither "
          f"Q1 nor Q6 reads are not loaded); generate {t_gen:.1f} s")

    q1_want, q6_want = _tpch_oracle(li)
    rec = Recorder(grouped_scan, "multi_grouped_scan_table")
    out = {}
    try:
        for q in (1, 6):
            t0 = time.perf_counter()
            sql = tpch.QUERIES[q]
            before = grouped_scan.MULTI_LAUNCHES
            t = time.perf_counter()
            got = con.query(sql).fetchall()
            t_cold = time.perf_counter() - t
            check(grouped_scan.MULTI_LAUNCHES > before,
                  f"TPC-H Q{q} skipped the B3 kernel")
            hot = []
            for i in range(hot_runs):
                rec.on = i == 0
                t = time.perf_counter()
                again = con.query(sql).fetchall()
                hot.append(time.perf_counter() - t)
                rec.on = False
                check(again == got, f"Q{q} hot run {i} differs from cold")
            out[q] = dict(cold=t_cold, hot=statistics.median(hot),
                          calls=list(rec.calls))
            rec.calls.clear()
            db.config.pallas_scan_enabled = False
            t = time.perf_counter()
            host = db.connect().query(sql).fetchall()
            t_host = time.perf_counter() - t
            db.config.pallas_scan_enabled = True
            _same_rows(got, host, f"Q{q} B3 vs host tier")
            if q == 1:
                check(len(got) == len(q1_want),
                      f"Q1: {len(got)} groups != numpy {len(q1_want)}")
                for row in got:
                    w = q1_want[(row[0], row[1])]
                    for x, y, sc in zip(row[2:6], w[:4], (2, 2, 4, 6)):
                        check(_close(float(x), y / 10 ** sc, 1e-12),
                              f"Q1 {row[:2]}: {x} != numpy {y / 10 ** sc}")
                    check(row[-1] == w[4], f"Q1 {row[:2]} count {row[-1]} "
                                           f"!= numpy {w[4]}")
                    check(_close(float(row[6]), w[0] / 100 / w[4], 1e-12),
                          f"Q1 {row[:2]} avg_qty {row[6]}")
                detail = f"{len(got)} groups, counts {[r[-1] for r in got]}"
            else:
                check(_close(float(got[0][0]), q6_want / 10**4, 1e-12),
                      f"Q6: {got[0][0]} != numpy {q6_want / 10**4}")
                detail = f"revenue {got[0][0]}"
            phase(f"tpch-q{q}", t0, f"{detail} == host tier == numpy; "
                  f"{len(out[q]['calls'])} B3 launch(es) per query; cold "
                  f"{t_cold * 1e3:.1f} ms; host tier {t_host * 1e3:.1f} ms")
            print(f"[tpch-q{q}] cold {t_cold * 1e3:.3f} ms", flush=True)
            print(f"[tpch-q{q}] hot median of {hot_runs} "
                  f"{out[q]['hot'] * 1e3:.3f} ms", flush=True)
    finally:
        rec.restore()
    packed = sum(s.footprint_bytes() for c in table.columns.values()
                 for s in c.segments)
    out["packed_bytes"], out["plain_bytes"] = packed, sum(
        n * table.columns[c].ltype.np_dtype.itemsize for c in Q16_COLUMNS)
    out["db"] = db
    return out


def b2_path(hot_runs, n_rows=T3_ROWS):
    """Phase 6: t3(g INTEGER, v INTEGER), 12 groups, v uniform in
    [-10^6, 10^6); a plain and a filtered GROUP BY against numpy. Returns
    the timings and the B2 calls of one hot plain query."""
    import numpy as np

    import adacom_tpu_torch as att
    from adacom_tpu_torch.ops import grouped_scan

    t0 = time.perf_counter()
    rng = np.random.default_rng(0x7E3)
    g = rng.integers(0, T3_GROUPS, n_rows).astype(np.int32)
    v = rng.integers(-10**6, 10**6, n_rows).astype(np.int32)
    db = att.Database(platform="cuda")
    con = db.connect()
    con.query("CREATE TABLE t3(g INTEGER, v INTEGER)")
    app = con.appender("t3")
    for start in range(0, n_rows, CHUNK):
        app.append_columns({"g": g[start:start + CHUNK],
                            "v": v[start:start + CHUNK]})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    phase("t3-load", t0, f"{n_rows} rows, {T3_GROUPS} groups")

    def want(lo=None, hi=None):
        keep = np.ones(n_rows, bool) if lo is None else (v >= lo) & (v < hi)
        cnt = np.bincount(g[keep], minlength=T3_GROUPS)
        sm = np.zeros(T3_GROUPS, np.int64)
        np.add.at(sm, g[keep], v[keep].astype(np.int64))
        return cnt, sm

    rec = Recorder(grouped_scan, "grouped_scan_table")
    try:
        t0 = time.perf_counter()
        sql = "SELECT g, sum(v), count(*), avg(v) FROM t3 GROUP BY g ORDER BY g"
        before = grouped_scan.GROUPED_LAUNCHES
        t = time.perf_counter()
        got = con.query(sql).fetchall()
        t_cold = time.perf_counter() - t
        check(grouped_scan.GROUPED_LAUNCHES > before, "t3 skipped the B2 kernel")
        cnt, sm = want()
        full = (cnt, sm)
        check([int(r[0]) for r in got] == list(range(T3_GROUPS)),
              f"t3 groups {[r[0] for r in got]}")
        for r in got:
            gi = int(r[0])
            check(int(r[1]) == int(sm[gi]) and int(r[2]) == int(cnt[gi]),
                  f"t3 group {gi}: {r} != numpy ({sm[gi]}, {cnt[gi]})")
            check(_close(float(r[3]), sm[gi] / cnt[gi], 1e-12),
                  f"t3 group {gi} avg {r[3]}")
        hot = []
        for i in range(hot_runs):
            rec.on = i == 0
            t = time.perf_counter()
            again = con.query(sql).fetchall()
            hot.append(time.perf_counter() - t)
            rec.on = False
            check(again == got, f"t3 hot run {i} differs")
        lo, hi = 125_000, 400_000  # a negative literal does not fold
        fsql = (f"SELECT g, count(*), sum(v) FROM t3 WHERE v >= {lo} AND "
                f"v < {hi} GROUP BY g ORDER BY g")
        before = grouped_scan.GROUPED_LAUNCHES
        fgot = con.query(fsql).fetchall()
        check(grouped_scan.GROUPED_LAUNCHES > before,
              "filtered t3 skipped the B2 kernel")
        cnt, sm = want(lo, hi)
        check([(int(r[0]), int(r[1]), int(r[2])) for r in fgot]
              == [(i, int(cnt[i]), int(sm[i])) for i in range(T3_GROUPS)],
              f"filtered t3: {fgot} != numpy")
    finally:
        rec.restore()
    t_hot = statistics.median(hot)
    phase("t3-groupby", t0, f"GROUP BY g and WHERE v in [{lo}, {hi}) == "
          f"numpy; cold {t_cold * 1e3:.1f} ms; hot median of {hot_runs} "
          f"{t_hot * 1e3:.3f} ms")
    return dict(cold=t_cold, hot=t_hot, calls=list(rec.calls), db=db,
                want=full, g=g, v=v)


T5_ROWS = 50_000_000
T5_PREFIX = 8 << 20  # the host aggregate's and the mesh's rows
T5_GROUPS = 12
T5_STRIDE = 3  # keys 0, 3, ..., 33: a 35-slot domain with the NULL slot
T5_ALL_NULL = 6  # the key whose v is all NULL
T5_SQL = ("SELECT g, count(*), count(v), sum(v), min(v), max(v), avg(v) "
          "FROM t5 GROUP BY g")


def _t5_data(n_rows):
    """t5's columns from a seed: 12 keys plus 5% NULL keys; key 6's v all
    NULL, 10% of the other v NULL."""
    import numpy as np

    rng = np.random.default_rng(0x75)
    g = (rng.integers(0, T5_GROUPS, n_rows) * T5_STRIDE).astype(np.int32)
    v = rng.integers(-10**6, 10**6, n_rows).astype(np.int32)
    g_ok = rng.random(n_rows) >= 0.05
    v_ok = (rng.random(n_rows) >= 0.1) & (g != T5_ALL_NULL)
    return g, v, g_ok, v_ok


def _t5_want(g, v, g_ok, v_ok):
    """T5_SQL's rows by numpy (bincount over the arrays), keyed by g (None:
    the NULL key): (count(*), count(v), sum(v), min(v), max(v))."""
    import numpy as np

    slot = np.where(g_ok, g // T5_STRIDE, T5_GROUPS)
    cnt = np.bincount(slot, minlength=T5_GROUPS + 1)
    vcnt = np.bincount(slot, weights=v_ok, minlength=T5_GROUPS + 1)
    vsum = np.bincount(slot[v_ok], weights=v[v_ok].astype(np.float64),
                       minlength=T5_GROUPS + 1)
    want = {}
    for k in range(T5_GROUPS + 1):
        sel = v[(slot == k) & v_ok]
        key = None if k == T5_GROUPS else k * T5_STRIDE
        want[key] = (int(cnt[k]), int(vcnt[k]), int(vsum[k]),
                     int(sel.min()) if len(sel) else None,
                     int(sel.max()) if len(sel) else None)
    check(int(vsum.max()) < 2**53 and int(vsum.min()) > -2**53,
          "t5 sums past float64's integers")
    return want


def _t5_check(got, want, what):
    check(len(got) == len(want), f"{what}: {len(got)} groups != "
                                 f"{len(want)}")
    for row in got:
        key = None if row[0] is None else int(row[0])
        check(key in want, f"{what}: unexpected group {row[0]}")
        c, vc, sm, mn, mx = want[key]
        vals = [int(x) if x is not None else None for x in row[1:6]]
        check(vals == [c, vc, sm if vc else None, mn, mx],
              f"{what}: group {key}: {row} != numpy {want[key]}")
        if vc:
            check(_close(float(row[6]), sm / vc, 1e-12),
                  f"{what}: group {key} avg {row[6]}")
        else:
            check(row[6] is None, f"{what}: group {key} avg {row[6]}")
    check(any(r[0] is None for r in got) and
          any(r[3] is None for r in got), f"{what}: no NULL group")


def _t5_db(g, v, g_ok, v_ok, platform, mesh=None):
    import adacom_tpu_torch as att

    db = att.Database(platform=platform, mesh=mesh)
    con = db.connect()
    con.query("CREATE TABLE t5(g INTEGER, v INTEGER)")
    app = con.appender("t5")
    for start in range(0, len(g), CHUNK):
        sl = slice(start, start + CHUNK)
        app.append_columns({"g": g[sl], "v": v[sl]},
                           {"g": g_ok[sl], "v": v_ok[sl]})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    return db, con


def _default_routing(con):
    """SET the routing knobs back to the DBConfig defaults."""
    from adacom_tpu_torch.tools import route_sweep

    route_sweep.set_config(con, route_sweep.defaults())


def _t5_run(db, con, what, want, hot_runs):
    """T5_SQL cold and hot on one route, against numpy; returns the cold
    run's route (dist_stats' increments and the launches) and times."""
    before_stats, before = dict(db.dist_stats), _launches()
    t = time.perf_counter()
    got = con.query(T5_SQL).fetchall()
    cold = time.perf_counter() - t
    route = {k: v - before_stats.get(k, 0) for k, v in db.dist_stats.items()
             if v != before_stats.get(k, 0)}
    route.update(zip(("B1", "B2", "B3", "device_scan"),
                     (a - b for a, b in zip(_launches(), before))))
    _t5_check(got, want, what)
    hot = []
    for _ in range(hot_runs):
        t = time.perf_counter()
        again = con.query(T5_SQL).fetchall()
        hot.append(time.perf_counter() - t)
        check(again == got, f"{what}: a hot run differs")
    return route, cold, statistics.median(hot) if hot else None


def t5_path(t3_con, t3_want, hot_runs=3, n_rows=T5_ROWS, prefix=T5_PREFIX,
            platform="cuda"):
    """Phase 6b: SQL NULL semantics of GROUP BY at T5_ROWS rows. t5(g, v):
    12 keys plus 5% NULL keys, one key whose v is all NULL, 10% NULL v
    elsewhere; T5_SQL on the generic device path (the default config at
    T5_ROWS rows), the host aggregate over the host copies (an 8M-row prefix,
    device_agg_min_rows above it, host_materialize=true) and 4 virtual
    shards of the card (the same prefix), each against numpy; the
    NULL-free twin on t3 still launches B2 and equals numpy (t3_want:
    phase 6's per-group counts and sums)."""
    from adacom_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    b2 = _launches()[1]
    twin = t3_con.query("SELECT g, count(*), count(v), sum(v), avg(v) FROM "
                        "t3 GROUP BY g").fetchall()
    b2 = _launches()[1] - b2
    check(b2 > 0 or platform != "cuda", f"t3's NULL-free twin: {b2} B2 "
          "launches")
    cnt, sm = t3_want
    twin = sorted(twin, key=lambda r: int(r[0]))
    check([tuple(int(x) for x in r[:4]) for r in twin]
          == [(i, int(cnt[i]), int(cnt[i]), int(sm[i]))
              for i in range(T3_GROUPS)],
          f"t3's NULL-free twin: {twin} != numpy")
    for r in twin:
        check(_close(float(r[4]), sm[int(r[0])] / cnt[int(r[0])], 1e-12),
              f"t3's NULL-free twin: group {r[0]} avg {r[4]}")
    g, v, g_ok, v_ok = _t5_data(n_rows)
    want = _t5_want(g, v, g_ok, v_ok)
    db, con = _t5_db(g, v, g_ok, v_ok, platform)
    phase("t5-load", t0, f"{n_rows} rows, {T5_GROUPS} keys + "
          f"{int((~g_ok).sum())} NULL keys, key {T5_ALL_NULL}'s v all NULL, "
          f"{int((~v_ok).sum())} NULL v; numpy's answer ready; t3's "
          f"NULL-free twin == numpy, launched B2 {b2} time(s)")
    lines = []
    try:
        t0 = time.perf_counter()
        route, cold, hot = _t5_run(db, con, "t5 generic", want, hot_runs)
        check(route["device_scan"] > 0 and not route["B2"] and
              not route["B3"], f"t5 generic route: {route}")
        lines.append(f"generic path {n_rows} rows: cold {cold * 1e3:.1f} ms, "
                     f"hot median of {hot_runs} {hot * 1e3:.3f} ms, route "
                     f"{route}")
    finally:
        db.close()
    del db, con
    pg, pv, pgo, pvo = g[:prefix], v[:prefix], g_ok[:prefix], v_ok[:prefix]
    want = _t5_want(pg, pv, pgo, pvo)
    for name, mesh in (("host aggregate", None),
                       ("4 virtual shards",
                        pmesh.make_virtual_mesh(4, platform))):
        db, con = _t5_db(pg, pv, pgo, pvo, platform, mesh)
        if mesh is None:  # the host aggregate over the host copies
            con.query(f"SET device_agg_min_rows = {prefix + 1}")
            con.query("SET host_materialize = true")
        try:
            route, cold, hot = _t5_run(db, con, f"t5 {name}", want, 1)
        finally:
            db.close()
        if mesh is None:
            check(route["device_scan"] == 0 and sum(
                route[k] for k in ("B1", "B2", "B3")) == 0 and
                not route.get("scan_agg"), f"t5 host route: {route}")
        else:
            check(route.get("scan_agg", 0) > 0,
                  f"t5 mesh route: {route}")
        lines.append(f"{name} {prefix} rows: cold {cold * 1e3:.1f} ms, hot "
                     f"{hot * 1e3:.3f} ms, route {route}")
    phase("t5 GROUP BY with NULLs", t0, "== numpy on every route; " +
          "; ".join(lines))


def time_grouped(calls, ms_iters=20, plain_iters=3):
    """B2 alone / wrapper / plain version over recorded calls (ms per
    query), after checking the kernel against the plain version there."""
    import numpy as np

    from adacom_tpu_torch.ops import grouped_scan

    err = 0
    for a, kw in calls:
        got = grouped_scan.grouped_scan_table(*a, **kw)
        ref = grouped_scan.grouped_scan_table_reference(*a, **kw)
        check(np.array_equal(got, ref), f"B2 at the main path's shape: "
                                        f"{got.tolist()} != {ref.tolist()}")
        err = max(err, int(np.abs(got - ref).max()))
    lps = [grouped_scan.prepare_grouped(*a, **kw)[0] for a, kw in calls]
    ms = cuda_ms(lambda: [grouped_scan._launch(lp) for lp in lps], ms_iters)
    wrapper = cuda_ms(lambda: [grouped_scan.grouped_scan_table(*a, **kw)
                               for a, kw in calls], ms_iters)
    plain = cuda_ms(lambda: [grouped_scan.grouped_scan_table_reference(
        *a, **kw) for a, kw in calls], plain_iters)
    return ms, wrapper, plain, err


def time_multi(calls, ms_iters=20, plain_iters=3):
    """B3 alone / wrapper / plain version over recorded calls (ms per
    query), after checking the kernel against the plain version there."""
    import numpy as np

    from adacom_tpu_torch.ops import grouped_scan

    err = 0
    for a, kw in calls:
        got = grouped_scan.multi_grouped_scan_table(*a, **kw)
        ref = grouped_scan.multi_grouped_scan_table_reference(*a, **kw)
        check(np.array_equal(got, ref), f"B3 at the main path's shape: "
                                        f"{got.tolist()} != {ref.tolist()}")
        err = max(err, int(np.abs(got - ref).max()))
    lps = [grouped_scan.prepare_multi(*a, **kw) for a, kw in calls]
    ms = cuda_ms(lambda: [grouped_scan._launch(lp) for lp in lps], ms_iters)
    wrapper = cuda_ms(lambda: [grouped_scan.multi_grouped_scan_table(*a, **kw)
                               for a, kw in calls], ms_iters)
    plain = cuda_ms(lambda: [grouped_scan.multi_grouped_scan_table_reference(
        *a, **kw) for a, kw in calls], plain_iters)
    return ms, wrapper, plain, err


def _packed_bytes(calls, kind):
    """Packed bytes one query's launches read."""
    total = 0
    for args, _kw in calls:
        stacks = list(args[:2]) if kind == "B2" else list(args[0]) + list(args[1])
        total += sum(t.numel() * 4 for t in stacks if t is not None)
    return total


def _bound_bytes(calls, kind):
    """Bytes the function must move for one query: its packed words, the
    (n_seg, 32) uint32 scalar table and the (n_groups, n_out) int64 result."""
    total = _packed_bytes(calls, kind)
    for args, _kw in calls:
        n_seg = int(args[0].shape[0]) if kind == "B2" else int(args[2].shape[0])
        n_out = 2 if kind == "B2" else len(args[5]) + 1
        total += n_seg * 32 * 4 + int(args[5 if kind == "B2" else 3]) * n_out * 8
    return total


def _bound_line(nbytes, ms):
    b = bound_ms(nbytes)
    return (f"bound {b:.4f} ms (bytes, {nbytes} B at 3.35 TB/s), "
            f"{nbytes / ms / 1e9 / 3.35 * 100:.1f}% of 3.35 TB/s")


def ptxas_entries(log):
    """(kernel, registers, spill-store bytes) for each entry function in an
    `nvcc -Xptxas=-v` log; a grouped_scan instantiation is named
    grouped_scan<readers, private|warp>."""
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk[:chunk.index("'")]
        m = re.search(r"grouped_scan_kernelILi(\d+)ELb([01])E", name)
        if m:
            name = (f"grouped_scan<{m.group(1)}, "
                    f"{'private' if m.group(2) == '1' else 'warp'}>")
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((name, int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else 0))
    return out


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published


def bound_ms(nbytes):
    """Least time to move nbytes at the card's published HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---- 8. the generic device path ---------------------------------------------


def _codec_cases(n, rng):
    """(label, codec, type name, values) of n rows for phase 8a."""
    import numpy as np

    i64_max = np.iinfo(np.int64).max
    wrap = (np.arange(n, dtype=np.uint64) + np.uint64(i64_max - n // 2))
    distinct = rng.integers(-10**9, 10**9, min(4096, n)).astype(np.int32)
    return [
        ("constant i32", "constant", "INTEGER", np.full(n, -7, np.int32)),
        ("constant f64", "constant", "DOUBLE", np.full(n, 2.5)),
        ("rle one run", "rle", "BIGINT", np.full(n, -(1 << 40), np.int64)),
        ("rle run per row", "rle", "INTEGER", np.arange(n, dtype=np.int32) * 3),
        ("delta across the int64 wrap", "delta", "BIGINT", wrap.view(np.int64)),
        ("delta int32 walk", "delta", "INTEGER",
         np.cumsum(rng.integers(-1000, 1000, n)).astype(np.int32)),
        ("dictionary 2", "dictionary", "BIGINT",
         rng.choice(np.asarray([-(1 << 50), 1 << 50], np.int64), n)),
        ("dictionary 4096", "dictionary", "INTEGER", np.concatenate(
            [distinct, rng.choice(distinct, n - len(distinct))])),
        ("alp e=0", "alp", "DOUBLE",
         rng.integers(-(1 << 40), 1 << 40, n).astype(np.float64)),
        ("alp e=14 negative", "alp", "DOUBLE",
         -rng.integers(1, 10**6, n) / 1e14),
        ("alp float32", "alp", "FLOAT",
         (rng.integers(-10**4, 10**4, n) / 100.0).astype(np.float32)),
    ]


def codecs_on_card(dev):
    """Phase 8a: every codec decodes on the card to the host values, bit
    for bit, at 1, 4,097, 65,535 and 65,536 rows: the whole segment, random
    rows (gather), and a pool of two segments stacked; the host decode
    (the same codec on the CPU) agrees. Returns the comparisons made."""
    import numpy as np
    import torch

    import adacom_tpu_torch as att
    from adacom_tpu_torch import types as tt
    from adacom_tpu_torch.ops import codecs

    cfg = att.DBConfig()
    rng = np.random.default_rng(0xC0DEC)
    n_cmp = 0
    for n in CODEC_COUNTS:
        for label, codec, tname, vals in _codec_cases(n, rng):
            what = f"{label} at {n} rows"
            ltype = getattr(tt, tname)
            enc = codecs.encode(codec, vals, ltype, cfg, dev)
            got = codecs.decode_full(enc, vals.dtype).cpu().numpy()
            check(got.tobytes() == vals.tobytes(), f"{what}: card decode "
                                                   f"!= host values")
            host = codecs.encode(codec, vals, ltype, cfg, "cpu")
            check(codecs.decode_full(host, vals.dtype).numpy().tobytes()
                  == got.tobytes(), f"{what}: host decode != card decode")
            idx = rng.integers(0, n, 257)
            rows = codecs.gather(enc, torch.from_numpy(idx).to(dev))
            check(np.array_equal(rows.cpu().numpy().astype(vals.dtype),
                                 vals[idx]), f"{what}: gather")
            pool = codecs.make_decoder(enc.meta, vals.dtype)(tuple(
                torch.stack([a, a]) for a in enc.arrays))
            check(all(np.array_equal(r[:n].cpu().numpy(), vals.astype(
                r.cpu().numpy().dtype)) for r in pool), f"{what}: pool decode")
            n_cmp += 4
    return n_cmp


def _t4_chunk(start, stop, rng, d_values):
    import numpy as np

    row = np.arange(start, stop, dtype=np.int64)
    return {"k": row, "r": ((row // 4096) % T4_GROUPS).astype(np.int32),
            "d": d_values[rng.integers(0, 16, stop - start)].astype(np.int32),
            "f": np.round(rng.random(stop - start) * 1e5, 2),
            "c": np.full(stop - start, 42, np.int32)}


class _T4Oracle:
    """numpy answers over t4, accumulated chunk by chunk at ingest."""

    COLS = ("k", "r", "d", "f", "c")

    def __init__(self, v):
        import numpy as np

        self.v = v
        self.totals = {}       # all rows
        self.kept = {}         # rows with k % 97 != 0
        self.cnt = np.zeros(T4_GROUPS, np.int64)
        self.sum_k = np.zeros(T4_GROUPS, np.int64)
        self.sum_f = np.zeros(T4_GROUPS)
        self.min_d = np.full(T4_GROUPS, np.iinfo(np.int32).max, np.int64)
        self.max_f = np.full(T4_GROUPS, -np.inf)
        self.filtered = [0, 0.0]
        self.rows = ([], [])

    @staticmethod
    def _fold(acc, cols):
        for c, x in cols.items():
            s = int(x.sum()) if x.dtype.kind in "iu" else float(x.sum())
            mn, mx = x.min(), x.max()
            if c not in acc:
                acc[c] = [len(x), s, mn, mx]
            else:
                a = acc[c]
                a[0] += len(x)
                a[1] += s
                a[2], a[3] = min(a[2], mn), max(a[3], mx)

    def add(self, cols):
        import numpy as np

        self._fold(self.totals, cols)
        keep = cols["k"] % 97 != 0
        self._fold(self.kept, {c: x[keep] for c, x in cols.items()})
        r = cols["r"]
        self.cnt += np.bincount(r, minlength=T4_GROUPS)
        self.sum_k += np.bincount(r, weights=cols["k"],
                                  minlength=T4_GROUPS).astype(np.int64)
        self.sum_f += np.bincount(r, weights=cols["f"], minlength=T4_GROUPS)
        # r is constant on 4096-row blocks: reduce blocks, then groups
        full = len(r) // 4096 * 4096
        g = r[::4096]
        for x, acc, fn, at in ((cols["d"], self.min_d, np.min, np.minimum),
                               (cols["f"], self.max_f, np.max, np.maximum)):
            blocks = fn(x[:full].reshape(-1, 4096), axis=1)
            if full < len(x):
                blocks = np.append(blocks, fn(x[full:]))
            at.at(acc, g, blocks)
        m = ((cols["d"] == self.v) & (cols["k"] >= 10**7)
             & (cols["k"] <= 6 * 10**7))
        self.filtered[0] += int(m.sum())
        self.filtered[1] += float(cols["f"][m].sum())
        m = (r == 7) & (cols["d"] == self.v)
        self.rows[0].append(cols["k"][m])
        self.rows[1].append(cols["f"][m])

    def ungrouped(self, kept=False):
        acc = self.kept if kept else self.totals
        out = [acc["k"][0]]
        for c in self.COLS:
            out += acc[c][1:]
        return out


def _device_profile(con, sql):
    """Device ms, kernels and copies of one run (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        con.query(sql).fetchall()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return ms, len(dev) - len(copies), len(copies)


def _cache_bytes(db, table):
    """The bytes of a table's pool cache (the stacked decoder arguments the
    device tiers keep between queries)."""
    cache = getattr(db.catalog.get_table(table), "_pool_cache", None)
    return 0 if cache is None else cache.nbytes


def _memory_mark(db, table):
    """Before a query: the device bytes the database holds outside the
    table's pool cache, and the bytes of resident segments; resets the
    peak."""
    import torch

    torch.cuda.synchronize()
    cache = _cache_bytes(db, table)
    mark = (torch.cuda.memory_allocated() - cache,
            db.buffer_manager.device_bytes)
    torch.cuda.reset_peak_memory_stats()
    return mark


def _memory_read(db, table, mark):
    """After the query's runs: (peak extra bytes: the peak above the mark,
    so it holds the whole pool cache, earlier queries' entries included,
    and the segments the cold run made resident; of which those segments;
    the pool cache's bytes now)."""
    import torch

    torch.cuda.synchronize()
    cache = _cache_bytes(db, table)
    return (torch.cuda.max_memory_allocated() - mark[0],
            db.buffer_manager.device_bytes - mark[1], cache)


def generic_query(con, name, sql, hot_runs, verify, table):
    """One query of phase 8: a cold run, then the median of hot_runs hot
    runs, the device time and kernels of one hot run, the peak extra device
    memory over the cold and hot runs with the pool cache's share, and the
    generic-path counter of the cold run (set to 0 just before it, read
    just after; it must be > 0). Every run's answer goes through verify.
    Returns the hot median in ms."""
    from adacom_tpu_torch.exec import device_scan

    mark = _memory_mark(con.db, table)
    t0 = time.perf_counter()
    device_scan.RUNS = 0
    got = con.query(sql).fetchall()
    t_cold = time.perf_counter() - t0
    runs = device_scan.RUNS
    check(runs > 0, f"{name}: the generic device path did not run")
    verify(got)
    hot = []
    for _ in range(hot_runs):
        t = time.perf_counter()
        got = con.query(sql).fetchall()
        hot.append(time.perf_counter() - t)
        verify(got)
    peak, resident, cache = _memory_read(con.db, table, mark)
    check(peak <= PEAK_EXTRA_LIMIT, f"{name}: peak extra device memory "
                                    f"{peak} B > {PEAK_EXTRA_LIMIT} B")
    dev_ms, n_kern, n_copy = _device_profile(con, sql)
    t_hot = statistics.median(hot)
    phase(f"generic {name}", t0,
          f"== numpy; generic runs {runs}; cold {t_cold * 1e3:.3f} ms; hot "
          f"median of {hot_runs} {t_hot * 1e3:.3f} ms; one hot run: device "
          f"{dev_ms:.3f} ms in {n_kern} kernels + {n_copy} copies "
          f"(torch.profiler); peak extra device memory over the cold and "
          f"hot runs {peak} B, holding the pool cache ({cache} B after the "
          f"runs) and {resident} B of segments the cold run made resident")
    return t_hot * 1e3


def t4_path(hot_runs, n_rows=T4_ROWS, platform="cuda"):
    """Phase 8b: t4 at T4_ROWS rows under compression_codec='auto' (k delta,
    r rle, d dictionary, f alp, c succinct), its aggregates, a device scan
    and a DELETE ... WHERE, every answer held against numpy."""
    import numpy as np

    import adacom_tpu_torch as att

    t0 = time.perf_counter()
    d_values = np.random.default_rng(11).integers(-10**9, 10**9, 16)
    v = int(d_values[3])
    oracle = _T4Oracle(v)
    rng = np.random.default_rng(12)
    db = att.Database(platform=platform)
    con = db.connect()
    con.query("CREATE TABLE t4(k BIGINT, r INTEGER, d INTEGER, f DOUBLE, "
              "c INTEGER)")
    app = con.appender("t4")
    for start in range(0, n_rows, CHUNK):
        cols = _t4_chunk(start, min(start + CHUNK, n_rows), rng, d_values)
        oracle.add(cols)
        app.append_columns(cols)
    app.close()
    t_ingest = time.perf_counter() - t0
    t = time.perf_counter()
    con.query("SET compression_codec='auto'")
    db.catalog.get_column_segment_catalog().compact_all_segments()
    t_compact = time.perf_counter() - t
    info = con.query("PRAGMA compression_info('t4')").fetchall()
    want_codec = {"k": "delta", "r": "rle", "d": "dictionary", "f": "alp",
                  "c": "succinct"}
    seen = {}
    for _t, col, _i, codec, state, _rows, nbytes, _reads in info:
        seen.setdefault(col, set()).add((codec, state))
    for col, codec in want_codec.items():
        check(seen[col] == {(codec, "packed")},
              f"t4.{col}: codecs {seen[col]} != {{{codec}}}")
    n_seg = sum(1 for r in info if r[1] == "k")
    packed = sum(r[6] for r in info)
    phase("generic t4-load", t0,
          f"{n_rows} rows x 5 columns in {n_seg} segments each; ingest "
          f"{t_ingest:.1f} s, compaction (auto) {t_compact:.1f} s; every "
          f"segment: {want_codec}; {packed} B encoded vs "
          f"{n_rows * 28} B plain")

    ungrouped = ("SELECT count(*), " + ", ".join(
        f"sum({c}), min({c}), max({c})" for c in _T4Oracle.COLS) +
        " FROM t4")

    def verify_ungrouped(got, kept=False):
        want = oracle.ungrouped(kept)
        check(len(got) == 1 and len(got[0]) == len(want),
              f"ungrouped: {got}")
        for i, (x, y) in enumerate(zip(got[0], want)):
            if i == 10:  # sum(f): the summation order differs
                check(_close(float(x), float(y), 1e-12),
                      f"ungrouped sum(f): {x} != numpy {y}")
            else:  # integers, and the float min/max, are exact
                check(x == y, f"ungrouped [{i}]: {x} != numpy {y}")

    generic_query(con, "t4 ungrouped", ungrouped, hot_runs, verify_ungrouped,
                  "t4")

    group_sql = ("SELECT r, count(*), sum(k), min(d), max(f), avg(f) "
                 "FROM t4 GROUP BY r ORDER BY r")

    def verify_grouped(got):
        check(len(got) == np.count_nonzero(oracle.cnt),
              f"GROUP BY r: {len(got)} groups")
        for row in got:
            g = int(row[0])
            check(int(row[1]) == oracle.cnt[g]
                  and int(row[2]) == oracle.sum_k[g]
                  and int(row[3]) == oracle.min_d[g]
                  and float(row[4]) == oracle.max_f[g],
                  f"GROUP BY r, group {g}: {row}")
            check(_close(float(row[5]), oracle.sum_f[g] / oracle.cnt[g],
                         1e-12), f"GROUP BY r, group {g}: avg {row[5]}")

    device_ms = generic_query(con, "t4 GROUP BY r (1000 groups)", group_sql,
                              hot_runs, verify_grouped, "t4")
    # the same query on the host aggregate over the host copies
    # (device_agg_min_rows above the row count)
    t = time.perf_counter()
    con.query(f"SET device_agg_min_rows={n_rows + 1}")
    con.query("SET host_materialize=true")
    t1 = time.perf_counter()
    host = con.query(group_sql).fetchall()
    host_ms = (time.perf_counter() - t1) * 1e3
    verify_grouped(host)
    _default_routing(con)
    phase("generic t4 GROUP BY r on the host aggregate", t,
          f"== numpy; one run {host_ms:.3f} ms against {device_ms:.3f} ms "
          f"on the generic device path")

    filt_sql = (f"SELECT count(*), sum(f) FROM t4 WHERE d = {v} "
                f"AND k BETWEEN 10000000 AND 60000000")

    def verify_filtered(got):
        n, s = got[0]
        check(n == oracle.filtered[0] and (
            s is None if n == 0 else _close(s, oracle.filtered[1], 1e-12)),
            f"filtered: {got} != {oracle.filtered}")

    generic_query(con, "t4 filtered", filt_sql, hot_runs, verify_filtered,
                  "t4")

    scan_sql = f"SELECT k, f FROM t4 WHERE r = 7 AND d = {v}"
    want_rows = list(zip(np.concatenate(oracle.rows[0]).tolist(),
                         np.concatenate(oracle.rows[1]).tolist()))
    con.query("SET host_materialize=true")
    host_rows = con.query(scan_sql).fetchall()
    check([(int(a), float(b)) for a, b in host_rows] == want_rows,
          "host-tier scan != numpy")

    def verify_scan(got):
        check(got == host_rows, f"device scan: {len(got)} rows != host "
                                f"tier's {len(host_rows)}")

    con.query("SET host_materialize=false")
    generic_query(con, "t4 device scan", scan_sql, hot_runs, verify_scan,
                  "t4")
    _default_routing(con)

    from adacom_tpu_torch.exec import device_scan

    t = time.perf_counter()
    device_scan.RUNS = 0
    con.query("DELETE FROM t4 WHERE k % 97 = 0")
    check(device_scan.RUNS > 0, "DELETE ... WHERE skipped the device scan")
    t_del = time.perf_counter() - t
    phase("generic t4 DELETE WHERE k % 97 = 0", t,
          f"{t_del * 1e3:.1f} ms (device scan of 5 columns)")
    generic_query(con, "t4 ungrouped after DELETE", ungrouped, hot_runs,
                  lambda got: verify_ungrouped(got, kept=True), "t4")
    cache = _cache_bytes(db, "t4")
    check(0 < cache <= packed, f"t4's pool cache holds {cache} B, more than "
                               f"t4's {packed} B encoded")
    check(db.buffer_manager.cache_bytes == cache,
          f"the buffer manager counts {db.buffer_manager.cache_bytes} B of "
          f"pool cache, the table holds {cache} B")
    print(f"[generic t4 pool cache] {cache} B after the five queries, "
          f"at most t4's {packed} B encoded", flush=True)
    return db


def adaptive_mix(db, con, n_rows, hot_runs):
    """Phase 8c: one adaptive policy step on t1 (phase 4's table), then the
    main path's aggregate over plain and packed segments."""
    cat = db.catalog.get_column_segment_catalog()
    t0 = time.perf_counter()
    n_c, n_u = cat.compress_lowest_k_segments(0.9)
    segs = db.catalog.get_table("t1").columns["i"].segments
    n_plain = sum(1 for s in segs if not s.is_compacted())
    check(0 < n_plain < len(segs), f"t1 after one policy step: {n_plain} "
                                   f"plain of {len(segs)}")
    phase("generic t1 policy step", t0,
          f"compress_lowest_k_segments(0.9): {n_c} compacted, {n_u} "
          f"uncompacted; t1: {n_plain} plain and {len(segs) - n_plain} "
          f"packed segments")
    want = [(n_rows, n_rows * (n_rows - 1) // 2)]

    def verify(got):
        check(got == want, f"t1 mixed count/sum: {got} != {want}")

    generic_query(con, "t1 count/sum over plain + packed",
                  "SELECT count(*), sum(i) FROM t1", hot_runs, verify,
                  "t1")


# ---- 9. the relational path: TPC-H at scale factor 1 ------------------------

TPCH9_SF = 1.0
TPCH9_HOT = 1
# the oracle's indexes: tools/verify_sf1.py's and o_custkey
SQLITE_INDEXES = ("lineitem(l_orderkey)", "lineitem(l_partkey)",
                  "lineitem(l_suppkey)", "orders(o_orderkey)",
                  "orders(o_custkey)", "partsupp(ps_partkey)")
_WINDOW = ("SELECT r, count(*), sum(s) FROM (SELECT rank() OVER "
           "(PARTITION BY o_custkey ORDER BY o_totalprice DESC, o_orderkey) "
           "AS r, sum(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY "
           "o_totalprice DESC, o_orderkey) AS s FROM orders) w WHERE r <= 5 "
           "GROUP BY r ORDER BY r")
# name -> (engine SQL, sqlite SQL): phase 9's queries beside TPC-H's
RELATIONAL_EXTRA = {
    "window over orders": (_WINDOW, _WINDOW),
    "UNION": ("SELECT c_nationkey FROM customer WHERE c_acctbal > 9900 UNION "
              "SELECT s_nationkey FROM supplier WHERE s_acctbal < -900",) * 2,
    "EXCEPT": ("SELECT c_nationkey FROM customer WHERE c_acctbal > 9990 "
               "EXCEPT SELECT s_nationkey FROM supplier WHERE s_acctbal > "
               "9000",) * 2,
    "INTERSECT": ("SELECT c_nationkey FROM customer WHERE c_acctbal > 9990 "
                  "INTERSECT SELECT s_nationkey FROM supplier WHERE "
                  "s_acctbal > 9000",) * 2,
    "DISTINCT": ("SELECT DISTINCT l_returnflag, l_linestatus, l_shipmode "
                 "FROM lineitem",) * 2,
    "FROM-less SELECT": ("SELECT 1, 'x'",) * 2,
    "FROM-less scalar subquery": ("SELECT count(*) FROM lineitem WHERE "
                                  "l_quantity > (SELECT 45)",) * 2,
    "(VALUES ...) joined to nation": (
        "SELECT n_name, v.col1 FROM (VALUES (0, 'a'), (7, 'b'), (24, 'c')) v "
        "JOIN nation ON n_nationkey = v.col0",
        "SELECT n_name, v.w FROM (SELECT 0 AS n, 'a' AS w UNION ALL SELECT "
        "7, 'b' UNION ALL SELECT 24, 'c') v JOIN nation ON n_nationkey = v.n"),
}
# sample -> (table, rows it keeps of the table's rows n)
SAMPLES = {
    "SELECT count(*) FROM lineitem USING SAMPLE 10%":
        ("lineitem", lambda n: int(round(n * 0.1))),
    "SELECT count(*) FROM orders TABLESAMPLE 2 PERCENT":
        ("orders", lambda n: int(round(n * 0.02))),
    "SELECT count(*) FROM lineitem USING SAMPLE 1000 ROWS":
        ("lineitem", lambda n: min(n, 1000)),
}


def _rows(rows):
    """Rows as plain Python values (the comparison of tests/test_tpch.py)."""
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None or isinstance(v, (bool, int, float, str)):
                nr.append(int(v) if isinstance(v, bool) else v)
            elif hasattr(v, "dtype") and v.dtype.kind == "f":
                nr.append(float(v))
            elif hasattr(v, "dtype") and v.dtype.kind in "iub":
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(nr)
    return out


def _sql_equal(got, exp, ordered):
    """Floats within rel_tol=1e-9, abs_tol=1e-6 (sqlite sums REALs), all
    else exact; rows sorted unless the query orders them."""
    import math

    if not ordered:
        got, exp = sorted(got, key=repr), sorted(exp, key=repr)
    if len(got) != len(exp):
        return False
    for g, e in zip(got, exp):
        if len(g) != len(e):
            return False
        for a, b in zip(g, e):
            if isinstance(a, float) or isinstance(b, float):
                if a is None or b is None or not math.isclose(
                        float(a), float(b), rel_tol=1e-9, abs_tol=1e-6):
                    return False
            elif a != b:
                return False
    return True


def tpch_oracle(sf):
    """Phase 9's sqlite3 oracle (`python3 chip_smoke.py --tpch-oracle SF`,
    a subprocess): the same tables from bench/tpch.py's seed, loaded into
    sqlite with indexes; prints every answer once as one JSON object."""
    import sqlite3

    from adacom_tpu_torch.bench import tpch

    t0 = time.perf_counter()
    data = tpch.generate(sf)
    lite = sqlite3.connect(":memory:")
    tpch.load_into_sqlite(lite, data)
    for i, spec in enumerate(SQLITE_INDEXES):
        lite.execute(f"CREATE INDEX i{i} ON {spec}")
    t_load = time.perf_counter() - t0
    out = {"tpch": {}, "extra": {}, "seconds": {}, "counts": {
        t: lite.execute(f"SELECT count(*) FROM {t}").fetchone()[0]
        for t in ("lineitem", "orders")}}
    for qid in sorted(tpch.QUERIES):
        t = time.perf_counter()
        out["tpch"][qid] = _rows(lite.execute(tpch.oracle_sql(qid)).fetchall())
        out["seconds"][f"Q{qid}"] = time.perf_counter() - t
    for name, (_sql, lite_sql) in RELATIONAL_EXTRA.items():
        out["extra"][name] = _rows(lite.execute(lite_sql).fetchall())
    out["seconds"]["load"] = t_load
    out["seconds"]["total"] = time.perf_counter() - t0
    print(json.dumps(out))


def _launches():
    from adacom_tpu_torch.exec import device_scan
    from adacom_tpu_torch.ops import fused_scan, grouped_scan

    return (fused_scan.KERNEL_LAUNCHES, grouped_scan.GROUPED_LAUNCHES,
            grouped_scan.MULTI_LAUNCHES, device_scan.RUNS)


def _routes(db, before_stats, before_launches):
    """What one run took: the join counters' increments, the generic
    path's runs and the B1/B2/B3 launches."""
    after = _launches()
    d = {k: db.dist_stats.get(k, 0) - before_stats.get(k, 0)
         for k in ("streamed_join", "streamed_join_agg", "index_join")}
    b1, b2, b3, runs = (a - b for a, b in zip(after, before_launches))
    d.update(device_scan_runs=runs, B1=b1, B2=b2, B3=b3)
    return d


def start_oracle(flag, scale):
    """One of the sqlite oracles (`python3 chip_smoke.py FLAG SCALE`) in a
    subprocess; its JSON comes back through communicate()."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(scale)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def stop(proc):
    """Kill a subprocess that is still running and reap it."""
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


def relational_path(hot_runs, sf=TPCH9_SF, platform="cuda", oracle=None):
    """Phase 9: TPC-H at scale factor sf on the card, every answer held
    against sqlite in a subprocess (`oracle`, started here unless the
    caller started it earlier). Returns the per-query records."""
    import numpy as np
    import torch

    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import tpch
    from adacom_tpu_torch.exec import spill

    if oracle is None:
        oracle = start_oracle("--tpch-oracle", sf)
    try:
        torch.cuda.synchronize()
        mark = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        data = tpch.generate(sf)
        t_gen = time.perf_counter() - t0
        db = att.Database(platform=platform)
        con = db.connect()
        tpch.load_into_engine(con, data)
        n_rows = sum(len(next(iter(c.values()))) for c in data.values())
        phase("relational load", t0, f"TPC-H SF {sf}: 8 tables, {n_rows} "
              f"rows, generate {t_gen:.1f} s; sqlite oracle running in "
              f"pid {oracle.pid}")

        got = {}
        t0 = time.perf_counter()
        for qid in sorted(tpch.QUERIES):
            got[("plain", qid)] = _rows(con.query(tpch.QUERIES[qid]).fetchall())
        phase("relational plain", t0, "22 queries on plain segments")

        t0 = time.perf_counter()
        con.query("PRAGMA compact_all_segments")
        phase("relational compact", t0, "PRAGMA compact_all_segments")
        records = {}
        for mode in ("compacted", "device scan"):
            # host materialization, then the device scan feeding the joins
            con.query(f"SET host_materialize={mode == 'compacted'}")
            t_mode = time.perf_counter()
            for qid in sorted(tpch.QUERIES):
                sql = tpch.QUERIES[qid]
                stats, launches = dict(db.dist_stats), _launches()
                t = time.perf_counter()
                got[(mode, qid)] = _rows(con.query(sql).fetchall())
                cold = time.perf_counter() - t
                routes = _routes(db, stats, launches)
                hot = []
                for _ in range(hot_runs):
                    t = time.perf_counter()
                    again = _rows(con.query(sql).fetchall())
                    hot.append(time.perf_counter() - t)
                    check(again == got[(mode, qid)],
                          f"Q{qid} [{mode}] hot run differs from cold")
                stats, launches = dict(db.dist_stats), _launches()
                dev_ms, n_kern, n_copy = _device_profile(con, sql)
                profiled = _routes(db, stats, launches)
                if n_kern + n_copy == 0 and any(
                        profiled[k] for k in ("B1", "B2", "B3",
                                              "device_scan_runs")):
                    dev_ms = None  # the card ran, the profiler saw nothing
                if qid in (1, 6):
                    check(routes["B3"] > 0 and profiled["B3"] > 0,
                          f"Q{qid} [{mode}] skipped B3")
                rec = records[(mode, qid)] = dict(
                    cold_ms=cold * 1e3, hot_ms=statistics.median(hot) * 1e3,
                    device_ms=dev_ms, kernels=n_kern, copies=n_copy, **routes)
                device = ("not recorded by torch.profiler" if dev_ms is None
                          else f"{dev_ms:.3f} ms in {n_kern} kernels + "
                               f"{n_copy} copies")
                print(f"[relational Q{qid} {mode}] cold {rec['cold_ms']:.3f} "
                      f"ms; hot median of {hot_runs} {rec['hot_ms']:.3f} ms; "
                      f"one hot run: device {device} (its routes "
                      + ", ".join(f"{k} {v}" for k, v in profiled.items()
                                  if v) + "); cold run's routes "
                      + ", ".join(f"{k} {v}" for k, v in routes.items()),
                      flush=True)
            phase(f"relational {mode}", t_mode, "22 queries: cold, hot, "
                  "device time and routes")
        con.query("SET host_materialize=true")

        t0 = time.perf_counter()
        for name, (sql, _lite_sql) in RELATIONAL_EXTRA.items():
            got[("extra", name)] = _rows(con.query(sql).fetchall())
        sampled = {sql: int(con.query(sql).fetchall()[0][0])
                   for sql in SAMPLES}
        phase("relational extra", t0, f"{len(RELATIONAL_EXTRA)} queries "
              f"(window, set operations, DISTINCT, FROM-less, VALUES) and "
              f"{len(SAMPLES)} samples")

        # spills: a memory_limit under the join's pairs and the sorts' keys
        # (16 B per lineitem row: 96 MB at SF 1)
        t0 = time.perf_counter()
        limit = 16 * db.catalog.get_table("lineitem").row_count()
        spill_sql = {
            "join": ("SELECT count(*), sum(l_quantity), sum(o_totalprice) "
                     "FROM lineitem JOIN orders ON l_orderkey = o_orderkey",
                     "partitioned_join_pairs"),
            "ORDER BY": ("SELECT l_orderkey FROM lineitem ORDER BY "
                         "l_extendedprice, l_orderkey, l_linenumber",
                         "external_sort_indices"),
            "top-N": ("SELECT l_orderkey, l_linenumber, l_extendedprice FROM "
                      "lineitem ORDER BY l_extendedprice DESC, l_orderkey, "
                      "l_linenumber LIMIT 20", "external_sort_indices"),
        }
        con.query("SET streaming_join_enabled=false")  # the materializing join
        spilled = []
        for name, (sql, routine) in spill_sql.items():
            ram = con.query(sql)
            ram = ram.column(0) if name == "ORDER BY" else _rows(ram.fetchall())
            rec_spill = Recorder(spill, routine)
            rec_spill.on = True
            try:
                con.query(f"PRAGMA memory_limit='{limit}'")
                out = con.query(sql)
                out = (out.column(0) if name == "ORDER BY"
                       else _rows(out.fetchall()))
            finally:
                con.query("PRAGMA memory_limit='none'")
                rec_spill.restore()
            check(rec_spill.calls, f"spill {name}: {routine} did not run")
            same = (np.array_equal(out, ram) if name == "ORDER BY"
                    else out == ram)
            check(same, f"spill {name}: spilled answer != in-RAM answer")
            spilled.append(f"{name} ({routine})")
        con.query("SET streaming_join_enabled=true")
        phase("relational spill", t0, f"memory_limit {limit} B: {spilled} "
              f"spilled, each == its in-RAM answer")

        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - mark
        cache = db.buffer_manager.cache_bytes

        t0 = time.perf_counter()
        out, err = oracle.communicate(timeout=900)
        check(oracle.returncode == 0, f"sqlite oracle failed: {err[-2000:]}")
        want = json.loads(out)
        for (mode, key), rows in got.items():
            if mode == "extra":
                exp = want["extra"][key]
                ordered = "ORDER BY" in RELATIONAL_EXTRA[key][0]
            else:
                exp = want["tpch"][str(key)]
                ordered = "ORDER BY" in tpch.QUERIES[key]
            check(_sql_equal(rows, exp, ordered),
                  f"{key} [{mode}]: {rows[:3]} != sqlite {exp[:3]}")
        for sql, n in sampled.items():
            table, keep = SAMPLES[sql]
            exp = keep(want["counts"][table])
            check(n == exp, f"{sql}: {n} rows != {exp}")
        phase("relational == sqlite", t0,
              f"22 queries x (plain, compacted, device scan), "
              f"{len(RELATIONAL_EXTRA)} others and {len(SAMPLES)} sample "
              f"counts equal sqlite's; sqlite took "
              f"{want['seconds']['total']:.1f} s (load "
              f"{want['seconds']['load']:.1f} s, slowest query "
              f"{max((v, k) for k, v in want['seconds'].items() if k.startswith('Q'))})")
        check(peak <= PEAK_EXTRA_LIMIT and cache <= PEAK_EXTRA_LIMIT,
              f"phase 9 device memory: peak extra {peak} B, pool cache "
              f"{cache} B (limit {PEAK_EXTRA_LIMIT} B)")
        print(f"[relational memory] pool caches {cache} B; peak extra device "
              f"memory over the phase {peak} B; resident segments "
              f"{db.buffer_manager.device_bytes} B", flush=True)
        for mode in ("compacted", "device scan"):
            tot = sum(r["hot_ms"] for (m, _q), r in records.items() if m == mode)
            dev = [r["device_ms"] for (m, _q), r in records.items()
                   if m == mode]
            print(f"[relational {mode} total] 22 hot medians {tot:.3f} ms, "
                  f"device {sum(d for d in dev if d is not None):.3f} ms "
                  f"over the {sum(d is not None for d in dev)} queries the "
                  f"profiler recorded", flush=True)
        db.close()
        return records, data, want
    finally:
        stop(oracle)


# ---- 11. durable databases and the client surface -----------------------------

# disk the phase needs: the WAL of the load (~1.5-2.5 GB at SF 1), two
# checkpoints and two copies of the directory
DURABLE_DISK_MIN = 12 << 30
T1_ROWS = 100_000


def _li_values(keys):
    """INSERT values of lineitem rows with these order keys: outside Q1's
    and Q6's dates and without an order, so only count(*) sees them."""
    return ", ".join(
        f"({k}, 1, 1, 1, 49.00, 4900.00, 0.10, 0.02, 'N', 'O', DATE "
        f"'1998-11-30', DATE '1998-11-30', DATE '1998-12-01', 'NONE', "
        f"'AIR')" for k in keys)

B1_QUERY = ("SELECT count(*), count(l_shipdate), min(l_shipdate), "
            "max(l_shipdate) FROM lineitem WHERE l_shipdate >= DATE "
            "'1995-01-01'")
COPY_SELECT = ("SELECT l_quantity, l_extendedprice, l_discount, l_shipdate "
               "FROM lineitem WHERE l_shipdate >= DATE '1994-01-01' AND "
               "l_shipdate < DATE '1995-01-01'")
Q6_STYLE = ("SELECT count(*), sum(l_extendedprice * l_discount) FROM {} "
            "WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < DATE "
            "'1995-01-01' AND l_discount BETWEEN 0.05 AND 0.07 AND "
            "l_quantity < 24")


def _shell(platform, path, *sql, stdin=None):
    """`python3 -m adacom_tpu_torch` on a database directory, in a
    subprocess: SQL given as arguments, else the script on `stdin`."""
    return subprocess.Popen(
        [sys.executable, "-m", "adacom_tpu_torch", "--platform", platform,
         path, *sql], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdin=stdin, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def crash(db):
    """Drop a durable database as a crash would: its closing checkpoint is
    skipped and the WAL stays as it is on disk."""
    db.wal.close()
    db.catalog.shutdown()
    db._closed = True


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _d, fs in os.walk(path) for f in fs)


def _layout(con):
    """PRAGMA compression_info without the read counts: per segment its
    table, column, index, codec, state, rows and bytes."""
    return [tuple(r[:7]) for r in _rows(
        con.query("PRAGMA compression_info").fetchall())]


def _durable_answers(con):
    """count(*), Q1, Q6 and Q3: what 11e holds a reopened copy to."""
    from adacom_tpu_torch.bench import tpch

    out = {"count": _rows(con.query("SELECT count(*) FROM lineitem")
                          .fetchall())}
    for q in (1, 6, 3):
        out[f"Q{q}"] = _rows(con.query(tpch.QUERIES[q]).fetchall())
    return out


def _same_answers(got, want, what):
    for k, rows in want.items():
        check(_sql_equal(got[k], rows, ordered=True),
              f"{what}: {k} {got[k][:3]} != {rows[:3]}")


def _b1_expected(li):
    """B1_QUERY's answer in numpy over the generated lineitem."""
    import datetime

    import numpy as np

    ship = np.asarray(li["l_shipdate"])
    days = ship[ship >= (datetime.date(1995, 1, 1)
                         - datetime.date(1970, 1, 1)).days]
    iso = [str(datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d)))
           for d in (days.min(), days.max())]
    return [[len(days), len(days), iso[0], iso[1]]]


def _trace_events(path):
    """(device events, names of the kernels, events per category) of a
    torch.profiler Chrome trace; device events are its kernel, memcpy and
    memset events."""
    import collections

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    cats = collections.Counter(str(e.get("cat")) for e in events)
    return (dev, {e.get("name", "") for e in dev if e.get("cat") == "kernel"},
            dict(cats.most_common(6)))


def durable_path(data, want, hot_runs=1, platform="cuda"):
    """Phase 11: the TPC-H tables of phase 9 (`data`, and `want`, phase 9's
    sqlite answers) in a durable database on the card: load through the
    appender with every batch logged, compaction and CHECKPOINT, close and
    reopen, the 22 queries cold and hot, committed, torn and rolled-back
    transactions read back from a copy of the directory, an aborted
    checkpoint, and the client surface (COPY, read_csv, read_json, the
    DB-API, the shell, the trace PRAGMAs). Returns its record."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import adacom_tpu_torch as att
    from adacom_tpu_torch import dbapi
    from adacom_tpu_torch.bench import tpch
    from adacom_tpu_torch.main.connection import TRACE_FILE
    from adacom_tpu_torch.main.database import CheckpointAbort
    from adacom_tpu_torch.ops import fused_scan, grouped_scan

    rec = {}
    root = tempfile.mkdtemp(prefix="adacom_durable_")
    shell = traced = None
    try:
        free = shutil.disk_usage(root).free
        check(free >= DURABLE_DISK_MIN, f"durable: {free} B free under "
              f"{root}, {DURABLE_DISK_MIN} B needed")
        d = os.path.join(root, "db")

        # ---- 11a. load through the appender, every batch logged --------
        t0 = time.perf_counter()
        db = att.Database(path=d, platform=platform)
        con = db.connect()
        tpch.load_into_engine(con, data)
        rec["load_s"] = time.perf_counter() - t0
        rec["wal_bytes"] = db.wal.size()
        rec["load_checkpoints"] = db._ckpt_seq
        phase("durable load", t0, f"8 tables through the appender in "
              f"{rec['load_s']:.2f} s; WAL {rec['wal_bytes']} B; "
              f"{db._ckpt_seq} checkpoint(s) set off by the "
              f"{db.config.wal_autocheckpoint} B threshold; {free} B free "
              f"under {root}")

        # ---- 11b. compact, CHECKPOINT ------------------------------------
        t0 = time.perf_counter()
        con.query("PRAGMA compact_all_segments")
        t_compact = time.perf_counter() - t0
        t = time.perf_counter()
        con.query("CHECKPOINT")
        rec["checkpoint_s"] = time.perf_counter() - t
        rec["checkpoint_bytes"] = _dir_bytes(
            os.path.join(d, db._read_current()))
        check(db.wal.size() == 0, f"WAL {db.wal.size()} B after CHECKPOINT")
        layout = _layout(con)
        states = {}
        for r in layout:
            states[(r[4], r[3])] = states.get((r[4], r[3]), 0) + 1
        phase("durable checkpoint", t0, f"compaction {t_compact:.2f} s; "
              f"CHECKPOINT {rec['checkpoint_s']:.2f} s, "
              f"{rec['checkpoint_bytes']} B in {db._read_current()}/; WAL "
              f"0 B after it; segments by (state, codec): {states}")

        # ---- 11c. close, reopen on the card -----------------------------
        t0 = time.perf_counter()
        db.close()  # checkpoints once more
        rec["close_s"] = time.perf_counter() - t0
        del db, con
        torch.cuda.synchronize()
        mark = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        db = att.Database(path=d, platform=platform)
        con = db.connect()
        rec["reopen_s"] = time.perf_counter() - t
        check(_layout(con) == layout,
              "reopened states, codecs or row counts differ from 11b's")
        phase("durable reopen", t0, f"close (its checkpoint) "
              f"{rec['close_s']:.2f} s; reopen {rec['reopen_s']:.2f} s; "
              f"{len(layout)} segments with 11b's states, codecs, rows "
              f"and bytes")

        # ---- 11d. the 22 queries, cold and hot ----------------------------
        t0 = time.perf_counter()
        rec["queries"] = {}
        for qid in sorted(tpch.QUERIES):
            sql = tpch.QUERIES[qid]
            b3 = grouped_scan.MULTI_LAUNCHES
            t = time.perf_counter()
            got = _rows(con.query(sql).fetchall())
            cold = time.perf_counter() - t
            b3_cold = grouped_scan.MULTI_LAUNCHES - b3
            hot = []
            for _ in range(hot_runs):
                t = time.perf_counter()
                again = _rows(con.query(sql).fetchall())
                hot.append(time.perf_counter() - t)
                check(again == got, f"Q{qid} after reopen: hot != cold")
            check(_sql_equal(got, want["tpch"][str(qid)],
                             "ORDER BY" in sql),
                  f"Q{qid} after reopen: {got[:3]} != sqlite "
                  f"{want['tpch'][str(qid)][:3]}")
            if qid in (1, 6):
                check(b3_cold > 0 and grouped_scan.MULTI_LAUNCHES - b3
                      > b3_cold, f"Q{qid} after reopen skipped B3")
            rec["queries"][qid] = (cold * 1e3, statistics.median(hot) * 1e3)
            print(f"[durable Q{qid}] cold {cold * 1e3:.3f} ms; hot "
                  f"{statistics.median(hot) * 1e3:.3f} ms; B3 launches "
                  f"{grouped_scan.MULTI_LAUNCHES - b3}; == sqlite",
                  flush=True)
        b1 = fused_scan.KERNEL_LAUNCHES
        got = _rows(con.query(B1_QUERY).fetchall())
        check(fused_scan.KERNEL_LAUNCHES > b1, "B1_QUERY skipped B1")
        check(got == _b1_expected(data["lineitem"]),
              f"B1_QUERY {got} != numpy {_b1_expected(data['lineitem'])}")
        # Q6 under the trace PRAGMAs (before 11e's deletes, so B3 runs)
        trace_dir = os.path.join(root, "trace")
        con.query(f"PRAGMA tpu_profile_start('{trace_dir}')")
        b3 = grouped_scan.MULTI_LAUNCHES
        con.query(tpch.QUERIES[6]).fetchall()
        b3 = grouped_scan.MULTI_LAUNCHES - b3
        out = con.query("PRAGMA tpu_profile_stop").fetchall()
        check(out == [(trace_dir,)] and b3 > 0, f"trace PRAGMAs: {out}, "
              f"B3 {b3}")
        dev, kernels, cats = _trace_events(
            os.path.join(trace_dir, TRACE_FILE))
        rec["trace_device_events"] = len(dev)
        rec["trace_b3"] = any("grouped_scan_kernel" in k for k in kernels)
        # the same PRAGMAs in a fresh process (the shell, on a copy of the
        # directory), where no earlier profiler session ran; read in 11f
        fresh, fresh_trace = (os.path.join(root, n) for n in ("fresh",
                                                              "trace2"))
        shutil.copytree(d, fresh)
        traced = _shell(platform, fresh,
                        f"PRAGMA tpu_profile_start('{fresh_trace}')",
                        tpch.QUERIES[6], "PRAGMA tpu_profile_stop")
        torch.cuda.synchronize()
        rec["peak_extra"] = torch.cuda.max_memory_allocated() - mark
        check(rec["peak_extra"] <= PEAK_EXTRA_LIMIT,
              f"durable queries: peak extra device memory "
              f"{rec['peak_extra']} B")
        cold = sum(c for c, _h in rec["queries"].values())
        hot = sum(h for _c, h in rec["queries"].values())
        phase("durable queries", t0, f"22 queries after the reopen == "
              f"sqlite: cold sum {cold:.3f} ms, hot sum {hot:.3f} ms; B1 "
              f"over l_shipdate == numpy; peak extra device memory "
              f"{rec['peak_extra']} B; Q6 under tpu_profile_start/stop "
              f"launched B3 {b3} time(s), its trace holds {len(dev)} device "
              f"events, B3's kernel "
              f"{'named' if rec['trace_b3'] else 'absent'} (kernels "
              f"{sorted(kernels)[:6]}; events by category {cats})")

        # ---- 11e. transactions, a crash copy, a torn tail, an abort -------
        t0 = time.perf_counter()
        li = data["lineitem"]
        new = {c: np.asarray(v[:T1_ROWS]).copy() for c, v in li.items()}
        new["l_orderkey"] = new["l_orderkey"] + 100_000_000
        con.query("BEGIN")
        app = con.appender("lineitem")
        app.append_columns(new)
        app.close()
        con.query("DELETE FROM lineitem WHERE l_orderkey % 97 = 0")
        con.query("COMMIT")
        n_upd = con.query("SELECT count(*) FROM lineitem WHERE l_shipdate "
                          ">= DATE '1998-08-01'").fetchall()[0][0]
        con.query("BEGIN")
        con.query("UPDATE lineitem SET l_discount = l_discount + 0.01 "
                  "WHERE l_shipdate >= DATE '1998-08-01'")
        con.query("COMMIT")
        before_t3 = _durable_answers(con)
        seq_t3 = db._ckpt_seq
        con.query("BEGIN")
        con.query("INSERT INTO lineitem VALUES "
                  + _li_values(range(900_000_001, 900_000_004)))
        con.query("COMMIT")
        live = _durable_answers(con)
        check(live["count"][0][0] == before_t3["count"][0][0] + 3,
              f"T3: {live['count']} after {before_t3['count']}")
        con.query("BEGIN")
        con.query("DELETE FROM lineitem WHERE l_quantity < 10")
        con.query("INSERT INTO lineitem VALUES " + _li_values([-7]))
        con.query("ROLLBACK")
        check(_durable_answers(con) == live, "ROLLBACK left a change")
        wal_t3 = db.wal.size()
        copy = os.path.join(root, "copy")
        shutil.copytree(d, copy)  # the database stays open: a crash copy
        t = time.perf_counter()
        dbc = att.Database(path=copy, platform=platform)
        t_copy = time.perf_counter() - t
        got = _durable_answers(dbc.connect())
        _same_answers(got, live, "crash copy")
        check(dbc.connect().query("SELECT count(*) FROM lineitem WHERE "
                                  "l_orderkey < 0").fetchall()[0][0] == 0,
              "the rolled-back rows reached the copy")
        crash(dbc)
        del dbc
        # a torn tail: T3's record loses its last bytes
        check(seq_t3 == db._ckpt_seq and wal_t3 > 16,
              f"T3 set off a checkpoint ({seq_t3} -> {db._ckpt_seq})")
        with open(os.path.join(copy, "wal.log"), "r+b") as f:
            f.truncate(wal_t3 - 5)
        t = time.perf_counter()
        dbt = att.Database(path=copy, platform=platform)
        t_torn = time.perf_counter() - t
        _same_answers(_durable_answers(dbt.connect()), before_t3,
                      "torn tail")
        crash(dbt)
        del dbt
        # an aborted checkpoint leaves CURRENT and the WAL as they were
        con.query("SET checkpoint_abort='before_header'")
        current = db._read_current()
        t = time.perf_counter()
        try:
            con.query("CHECKPOINT")
            check(False, "CHECKPOINT with checkpoint_abort did not raise")
        except CheckpointAbort:
            pass
        t_abort = time.perf_counter() - t
        check(db._read_current() == current and db.wal.size() == wal_t3,
              "the aborted checkpoint moved CURRENT or the WAL")
        crash(db)
        del db, con
        t = time.perf_counter()
        db = att.Database(path=d, platform=platform)
        con = db.connect()
        t_reabort = time.perf_counter() - t
        _same_answers(_durable_answers(con), live, "after the abort")
        rec.update(copy_open_s=t_copy, torn_open_s=t_torn,
                   abort_s=t_abort, abort_reopen_s=t_reabort)
        phase("durable crash", t0, f"T1 appended {T1_ROWS} rows and "
              f"deleted l_orderkey % 97 = 0; T2 updated {n_upd} rows (its "
              f"COMMIT left {seq_t3} checkpoint(s) in all); T3 inserted 3 "
              f"rows; T4 rolled back. The copy opened in {t_copy:.2f} s "
              f"== live (count, Q1, Q6, Q3), no rolled-back row; torn "
              f"tail opened in {t_torn:.2f} s == the state before T3; "
              f"checkpoint_abort raised after {t_abort:.2f} s, the reopen "
              f"({t_reabort:.2f} s) == live")

        # ---- 11f. the client surface on the card --------------------------
        t0 = time.perf_counter()
        copy2 = os.path.join(root, "copy2")
        shutil.copytree(copy, copy2)
        q6 = tpch.QUERIES[6]
        script = os.path.join(root, "q6.sql")
        with open(script, "w") as f:
            f.write(q6.rstrip().rstrip(";") + ";\n")
        with open(script) as f:  # piped in: the shell reads its stdin
            shell = _shell(platform, copy2, stdin=f)
        csv_path = os.path.join(root, "x.csv")
        n_csv = con.query(f"COPY ({COPY_SELECT}) TO '{csv_path}'").fetchall()
        con.query(f"CREATE TABLE l2 AS SELECT * FROM read_csv('{csv_path}')")
        got = _rows(con.query(Q6_STYLE.format("l2")).fetchall())
        exp = _rows(con.query(Q6_STYLE.format("lineitem")).fetchall())
        check(_sql_equal(got, exp, True), f"read_csv: {got} != {exp}")
        json_path = os.path.join(root, "x.ndjson")
        with open(json_path, "w") as f:
            for k in range(1000):
                f.write(json.dumps({"a": k, "s": None if k % 7 else f"s{k}",
                                    "f": k / 4}) + "\n")
        got = _rows(con.query(f"SELECT count(*), sum(a), count(s), sum(f) "
                              f"FROM read_json('{json_path}')").fetchall())
        check(got == [[1000, 499500, 143, 124875.0]], f"read_json: {got}")
        t = time.perf_counter()
        dcon = dbapi.connect(path=copy, platform=platform)
        got = _rows(dcon.execute(q6).fetchall())
        dcon.close()
        t_dbapi = time.perf_counter() - t
        check(_sql_equal(got, before_t3["Q6"], True),
              f"dbapi Q6 {got} != {before_t3['Q6']}")
        out, err = shell.communicate(timeout=600)
        check(shell.returncode == 0, f"shell failed: {err[-2000:]}")
        last = out.strip().splitlines()[-1]
        check(_sql_equal([[float(last)]], before_t3["Q6"], True),
              f"shell printed {out[-300:]!r}, Q6 is {before_t3['Q6']}")
        out, err = traced.communicate(timeout=600)
        check(traced.returncode == 0, f"traced shell failed: {err[-2000:]}")
        lines = out.strip().splitlines()
        check(lines[2:] == ["trace_dir", fresh_trace] and _sql_equal(
            [[float(lines[1])]], want["tpch"]["6"], True),
            f"traced shell printed {out[-300:]!r}")
        dev2, kernels2, cats2 = _trace_events(
            os.path.join(fresh_trace, TRACE_FILE))
        rec["fresh_trace_device_events"] = len(dev2)
        rec["fresh_trace_b3"] = any("grouped_scan_kernel" in k
                                    for k in kernels2)
        phase("durable client", t0, f"COPY TO wrote {n_csv[0][0]} rows; "
              f"read_csv -> l2: the Q6-style aggregate == lineitem's; "
              f"read_json == python; dbapi.connect on the copy: Q6 == "
              f"before T3 ({t_dbapi:.2f} s with its closing checkpoint); "
              f"the shell on a second copy printed Q6 ({last}); Q6 under "
              f"the trace PRAGMAs in a fresh process (the shell on an 11d "
              f"copy): {len(dev2)} device events, B3's kernel "
              f"{'named' if rec['fresh_trace_b3'] else 'absent'} (kernels "
              f"{sorted(k[:50] for k in kernels2)[:6]}; events by category "
              f"{cats2})")
        crash(db)
        return rec
    finally:
        stop(shell)
        stop(traced)
        shutil.rmtree(root, ignore_errors=True)


# ---- 10. the benchmark surface ------------------------------------------------

# ---- 12. the multi-device layer on the card ---------------------------------

MESH_SHARDS = 4
MESH_HOT = 1
MESH_PEAK_LIMIT = 16 << 30  # the shuffle join's bins at SF 1 (PERF.md §6)


def mesh_dryrun(platform="cuda"):
    """Phase 12a: the port's graft entry: dryrun_multichip(4) on 4 virtual
    shards of the card, and entry(), B1, against its plain version."""
    from adacom_tpu_torch import graft_entry
    from adacom_tpu_torch.ops import fused_scan

    t0 = time.perf_counter()
    line = graft_entry.dryrun_multichip(MESH_SHARDS, platform)
    check("virtual shards" in line or platform != "cuda",
          f"dryrun_multichip(4) on one card did not say so: {line}")
    fn, args = graft_entry.entry(platform)
    got, ref = fn(*args), fused_scan.scan_table_reference(*args)
    check(tuple(got) == tuple(ref), f"entry(): {got} != plain {ref}")
    # no fallback hides the device: too few cards, or a mesh of another
    # device type than the database's, raise
    import torch

    import adacom_tpu_torch as att
    from adacom_tpu_torch.parallel import mesh as pmesh

    def refused(what, make):
        try:
            make()
        except ValueError as e:
            return f"{what}: {e}"
        raise SmokeFailure(f"{what} was taken")

    other = "cpu" if platform == "cuda" else "cuda"
    refusals = [refused(f"a {other} mesh on a {platform} database",
                        lambda: att.Database(platform=platform, mesh=(
                            pmesh.make_virtual_mesh(2, other))))]
    n_cards = torch.cuda.device_count()
    if n_cards < MESH_SHARDS:
        refusals.append(refused(
            f"make_mesh({MESH_SHARDS}) on {n_cards} card(s)",
            lambda: pmesh.make_mesh(MESH_SHARDS)))
    phase("mesh dryrun", t0, f"{line}; entry() == plain version {got}; "
          f"refused: {'; '.join(refusals)}")


class Timer:
    """Wraps an attribute of a module or class and adds each call's
    seconds, the card synchronized after it, to `seconds` (the call itself
    goes through unchanged)."""

    def __init__(self, owner, name):
        import torch

        self.owner, self.name = owner, name
        self.real = getattr(owner, name)
        self.seconds = 0.0

        def timed(*args, **kw):
            t = time.perf_counter()
            try:
                return self.real(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t

        setattr(owner, name, timed)

    def restore(self):
        setattr(self.owner, self.name, self.real)


def mesh_path(data, want, single, hot_runs=MESH_HOT, platform="cuda"):
    """Phase 12b: TPC-H SF 1 (phase 9's tables and sqlite answers) on
    Database(mesh=make_virtual_mesh(4, card)), default config: the load,
    compaction, the 22 queries (a cold and hot_runs hot runs), each equal
    to sqlite's; the distributed scan-aggregate and shuffle join ran, B1-B3
    did not (the JAX package's routing under a mesh); the peak extra
    device memory; each query's hot ms beside phase 9's (`single`), and
    the hot run's seconds in the shuffle joins and the distributed
    scan-aggregates."""
    import torch

    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import tpch
    from adacom_tpu_torch.exec import device_scan, join
    from adacom_tpu_torch.parallel import mesh as pmesh

    _zero_counts()
    torch.cuda.synchronize()
    mark = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = pmesh.make_virtual_mesh(MESH_SHARDS, platform)
    db = att.Database(platform=platform, mesh=mesh)
    con = db.connect()
    tpch.load_into_engine(con, data)
    t_load = time.perf_counter() - t0
    con.query("PRAGMA compact_all_segments")
    n_rows = sum(len(next(iter(c.values()))) for c in data.values())
    phase("mesh load", t0, f"TPC-H SF {TPCH9_SF}: {n_rows} rows on "
          f"{mesh}, load {t_load:.1f} s, then PRAGMA compact_all_segments")
    t_q = time.perf_counter()
    cold_sum = hot_sum = single_sum = shuffle_sum = pool_sum = 0.0
    shuffle = Timer(join, "_distributed_join_pairs")
    pool = Timer(device_scan.DeviceScan, "_distributed_pool")
    for qid in sorted(tpch.QUERIES):
        sql = tpch.QUERIES[qid]
        stats = dict(db.dist_stats)
        t = time.perf_counter()
        rows = _rows(con.query(sql).fetchall())
        cold = time.perf_counter() - t
        hot = []
        in_shuffle, in_pool = shuffle.seconds, pool.seconds
        for _ in range(hot_runs):
            t = time.perf_counter()
            again = _rows(con.query(sql).fetchall())
            hot.append(time.perf_counter() - t)
            check(again == rows, f"Q{qid} [mesh] hot run differs from cold")
        in_shuffle = (shuffle.seconds - in_shuffle) * 1e3 / hot_runs
        in_pool = (pool.seconds - in_pool) * 1e3 / hot_runs
        shuffle_sum += in_shuffle
        pool_sum += in_pool
        check(_sql_equal(rows, want["tpch"][str(qid)],
                         "ORDER BY" in sql),
              f"Q{qid} [mesh]: {rows[:3]} != sqlite "
              f"{want['tpch'][str(qid)][:3]}")
        routes = {k: db.dist_stats[k] - stats.get(k, 0)
                  for k in ("scan_agg", "join")}
        hot_ms = statistics.median(hot) * 1e3
        one = single[("compacted", qid)]["hot_ms"]
        cold_sum += cold * 1e3
        hot_sum += hot_ms
        single_sum += one
        print(f"[mesh Q{qid}] cold {cold * 1e3:.3f} ms; hot "
              f"{'median of ' + str(hot_runs) + ' ' if hot_runs > 1 else ''}"
              f"{hot_ms:.3f} ms; phase 9 on one device (compacted, hot "
              f"median) {one:.3f} ms; distributed scan_agg "
              f"{routes['scan_agg']}, join {routes['join']}; a hot run's "
              f"shuffle joins {in_shuffle:.3f} ms, distributed "
              f"scan-aggregates {in_pool:.3f} ms", flush=True)
    shuffle.restore()
    pool.restore()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - mark
    b1, b2, b3, runs = _launches()
    print(f"[mesh total] 22 queries: cold {cold_sum:.3f} ms, hot "
          f"{hot_sum:.3f} ms (shuffle joins {shuffle_sum:.3f} ms, "
          f"distributed scan-aggregates {pool_sum:.3f} ms); phase 9's hot "
          f"medians {single_sum:.3f} ms; "
          f"dist_stats {db.dist_stats}; launches B1 {b1}, B2 {b2}, B3 {b3}, "
          f"generic runs {runs}; peak extra device memory {peak} B (limit "
          f"{MESH_PEAK_LIMIT} B), resident segments "
          f"{db.buffer_manager.device_bytes} B", flush=True)
    check(db.dist_stats["scan_agg"] > 0 and db.dist_stats["join"] > 0,
          f"the mesh paths did not run: {db.dist_stats}")
    check(b1 == b2 == b3 == 0,
          f"a fused kernel launched under a mesh: B1 {b1}, B2 {b2}, B3 {b3}")
    check(peak < MESH_PEAK_LIMIT,
          f"phase 12 peak extra device memory {peak} B")
    phase("mesh queries", t_q, f"22 queries on {MESH_SHARDS} shards == "
          f"sqlite; B1-B3 launched 0 times")
    db.close()


ROOFLINE_ROWS = 64e6
HEADLINE_SCALE = 1.0  # bench.py's 100M rows
SUCCINCT_SCALE = 0.01
# ClickBench rows: 1M of the module's full 10M, cut to fit the command's
# time limit beside phase 11 (PERF.md §4)
CB_SCALE = 0.1
CB_HOT = 1


def _zero_counts():
    from adacom_tpu_torch.exec import device_scan
    from adacom_tpu_torch.ops import fused_scan, grouped_scan

    fused_scan.KERNEL_LAUNCHES = grouped_scan.GROUPED_LAUNCHES = 0
    grouped_scan.MULTI_LAUNCHES = device_scan.RUNS = 0


def _counts_line():
    b1, b2, b3, runs = _launches()
    return f"B1 {b1}, B2 {b2}, B3 {b3}, device_scan {runs}"


def roofline_step(dev):
    """Phase 10a: the card's read and copy bandwidth, B1 and the torch
    decode path against it (tools/roofline.py, every answer against
    NumPy). Returns its record."""
    from adacom_tpu_torch.tools import roofline

    t0 = time.perf_counter()
    r = roofline.measure(dev, ROOFLINE_ROWS, 16, 20)
    rd, cp = r["read"], r["copy"]
    b1 = {k: v["kernel"] for k, v in r["b1"].items()}
    phase("benchmark roofline", t0, f"read {rd['bytes']} B: "
          f"{rd['events_gbps']:.1f} GB/s by events, {rd['wall_gbps']:.1f} by "
          f"wall; copy {cp['bytes']} B read + written: "
          f"{cp['events_gbps']:.1f} / {cp['wall_gbps']:.1f} GB/s; B1 at "
          f"({r['segments']}, 16, 2048), {r['packed_bytes']} B: lean "
          f"{b1['lean']['events_ms']:.4f} ms, predicate "
          f"{b1['pred']['events_ms']:.4f} ms "
          f"(wall {b1['pred']['wall_ms']:.4f} ms) = "
          f"{100 * r['b1']['pred']['share_of_read']:.1f}% of the measured "
          f"read, {100 * r['b1']['pred']['share_of_datasheet']:.1f}% of "
          f"{roofline.DATASHEET_GBPS:.0f} GB/s; scan_table "
          f"{r['b1']['pred']['wrapper']['events_ms']:.4f} ms; torch decode "
          f"path {r['torch_decode']['events_ms']:.3f} ms "
          f"({100 * r['torch_decode']['share_of_read']:.1f}% of the read); "
          f"every answer == numpy")
    return r


def headline_step():
    """Phase 10b: bench/headline.py (the bench.py twin) in this process at
    bench.py's scale; its JSON line goes to stdout as it prints it."""
    from adacom_tpu_torch.bench import headline

    t0 = time.perf_counter()
    os.environ.update(ADACOM_BENCH_SCALE=str(HEADLINE_SCALE),
                      ADACOM_BENCH_RUNS="5", ADACOM_BENCH_PLATFORM="cuda")
    _zero_counts()
    result, checks = headline.main()
    b1 = _launches()[0]
    check(checks["verified_runs"] == 6, f"headline: {checks}")
    check(checks["scan_answer"] == checks["scan_expected"],
          f"headline scan: {checks['scan_answer']} != "
          f"{checks['scan_expected']}")
    check(b1 >= 20 and checks["b1_launches"] >= 20,
          f"headline launched B1 {b1} times ({checks['b1_launches']} in the "
          f"timed scans)")
    mem = result["detail"]["memory"]
    check(mem["reduction"] > 0, f"headline memory: {mem}")
    phase("benchmark headline", t0, f"6 lookup runs verified, scan "
          f"{checks['scan_answer']} == (n, n(n-1)/2); hot lookup mean "
          f"{result['value']} s; scan {result['detail']['device_scan']['time_s']}"
          f" s; launches on this path: {_counts_line()}")
    return result


def adaptive_lookups(scale):
    """Phase 10c: ZipfOverTime's lookups, each checked, while its
    background compaction runs on the card; the thread must act during
    them and stop at cleanup."""
    import threading

    from adacom_tpu_torch.bench import succinct_benchmarks as sb

    t0 = time.perf_counter()
    b, state = sb.ZipfOverTime(scale, "cuda"), {}
    b.load(state)
    try:
        con, n = state["con"], state["n"]
        cat = state["db"].catalog.get_column_segment_catalog()
        check(cat.background_compaction_enabled, "no background compaction")
        rounds = cat.policy_rounds
        for v in state["data"]:
            got = con.query(f"SELECT i FROM t1 WHERE i == {int(v)}").fetchall()
            check(got == ([(int(v),)] if v < n else []),
                  f"lookup {v} under compaction: {got}")
        rounds = cat.policy_rounds - rounds
    finally:
        b.cleanup(state)
    alive = [t.name for t in threading.enumerate()
             if t.name == "adacom-compaction"]
    check(rounds > 0, "the compaction thread made no policy step")
    check(not alive, f"compaction threads still running: {alive}")
    phase("succinct compaction", t0, f"{len(state['data'])} lookups correct "
          f"while the background thread made {rounds} policy steps; the "
          f"thread stopped")


def succinct_step(scale):
    """Phase 10c: every [succinct] class through the bench runner on the
    card, one hot run each, every verify passing."""
    import io
    import threading

    from adacom_tpu_torch.bench import runner, succinct_benchmarks

    t0 = time.perf_counter()
    names = [n for n, c in runner.REGISTRY.items()
             if c.__module__ == succinct_benchmarks.__name__]
    check(len(names) == 18, f"succinct group: {names}")
    rows = []
    for name in names:
        t = time.perf_counter()
        _zero_counts()
        log = io.StringIO()
        recs = runner.run_benchmark(runner.REGISTRY[name], scale=scale,
                                    nruns=1, log=log, platform="cuda")
        check(len(recs) == 1, f"{name}: {recs}")
        tsv = [ln for ln in log.getvalue().splitlines()
               if ln.startswith(name + "\t")]
        rows.append(tsv[0])
        print(f"[succinct {name}] {tsv[0]!r} verified; "
              f"{time.perf_counter() - t:.2f} s with load; launches "
              f"{_counts_line()}", flush=True)
    alive = [t.name for t in threading.enumerate()
             if t.name == "adacom-compaction"]
    check(not alive, f"compaction threads still running: {alive}")
    phase("succinct", t0, f"{len(rows)} [succinct] benchmarks at scale "
          f"{scale}, each verified; no compaction thread left")
    adaptive_lookups(scale)


def clickbench_oracle(scale):
    """Phase 10d's sqlite3 oracle (`python3 chip_smoke.py
    --clickbench-oracle SCALE`, a subprocess): every answer as JSON."""
    from adacom_tpu_torch.bench import clickbench as cb

    print(json.dumps(cb.sqlite_answers(scale)))


def clickbench_step(oracle, scale):
    """Phase 10d: tools/clickbench_run.run on the card, every answer equal
    to sqlite's (computed by `oracle`, a subprocess started earlier)."""
    from adacom_tpu_torch.tools import clickbench_run

    t0 = time.perf_counter()
    want = {}

    def answers(qid):
        if not want:
            t = time.perf_counter()
            out, err = oracle.communicate(timeout=900)
            check(oracle.returncode == 0,
                  f"ClickBench oracle failed: {err[-2000:]}")
            want.update(json.loads(out))
            want["waited_s"] = time.perf_counter() - t
        return want["answers"][str(qid)]

    _zero_counts()
    with open(os.devnull, "w") as quiet:
        res = clickbench_run.run(scale, CB_HOT, "cuda", answers, log=quiet)
    for qid, q in res["queries"].items():
        print(f"[clickbench Q{qid:02d}] cold {q['cold_ms']:.3f} ms; hot "
              f"median of {CB_HOT} {q['median_ms']:.3f} ms; cold run's "
              f"launches " + ", ".join(f"{k} {v}"
                                       for k, v in q["launches"].items())
              + "; == sqlite", flush=True)
    tot = sum(q["median_ms"] for q in res["queries"].values())
    slow = sorted(res["queries"].items(), key=lambda kv: -kv[1]["median_ms"])
    sec = want["seconds"]
    phase("clickbench", t0, f"43 queries over {res['rows']} rows (scale "
          f"{scale}), every answer == sqlite; load + compaction "
          f"{res['load_s']:.1f} s, {res['size']} B; sum of hot medians "
          f"{tot:.3f} ms, slowest " + ", ".join(
              f"Q{k} {v['median_ms']:.1f} ms" for k, v in slow[:4])
          + f"; launches on this path: {_counts_line()}; sqlite took "
          f"{sec['total']:.1f} s (load {sec['load']:.1f} s), waited "
          f"{want['waited_s']:.1f} s for it")
    return res


# ---- 13. the tools ---------------------------------------------------------

# phase 13's sizes, cut from the tools' defaults for the time limit (PERF.md
# section 4): the fuzzers at 300 queries / 200 ops (2,000 at full size),
# TPC-H SF 0.05 (1), one hot run (3), 8M grouped rows (20M), 200,000
# strings (2M), 4M rows for 6 s (20M for 30 s), the [succinct] scans at
# scale 0.001 (0.02), Q18/Q21 at SF 0.05 (1)
FUZZ_QUERIES = 300
FUZZ_OPS = 200
FUZZ_SEED = 0
FUZZ_NULLS = 0.1  # the NULL fraction of the fuzzer's second table
TOOLS_SF = 0.05
GROUPED_ROWS = 8_000_000
STRING_ROWS = 200_000
OVERTIME_ROWS = 4_000_000
OVERTIME_S = 6.0
SUITES_SCALE = 0.001
SUITES_PATTERN = "ZipfScanOOM"

WARMUP_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
t0 = time.perf_counter()
import adacom_tpu_torch as att
from adacom_tpu_torch import build
from adacom_tpu_torch.utils import warmup
db = att.Database(platform=sys.argv[2])
t_db = time.perf_counter() - t0
started = [str(d) for d in warmup._threads]
t1 = time.perf_counter()
warm_s = warmup.ensure_transfer_warm(db.device)
wait_s = time.perf_counter() - t1
print(json.dumps({"database_s": t_db, "warm_s": warm_s, "wait_s": wait_s,
                  "started": started, "device": str(db.device),
                  "library": build.kernels.cache_info().currsize}))
"""


def fuzz_oracle(seed):
    """Phase 13b's sqlite3 oracle (`python3 chip_smoke.py --fuzz-oracle
    SEED`, a subprocess): the normalized answers to the seed's first
    FUZZ_QUERIES queries as JSON, on the NULL-free table ("plain") and on
    the one with FUZZ_NULLS of each column NULL ("nulls")."""
    from adacom_tpu_torch.tools import fuzz_differential as fd

    print(json.dumps({
        "plain": fd.oracle_answers(FUZZ_QUERIES, int(seed)),
        "nulls": fd.oracle_answers(FUZZ_QUERIES, int(seed), FUZZ_NULLS)}))


def warmup_step(platform="cuda"):
    """13a: Database() in a fresh process starts the warm-up thread;
    ensure_transfer_warm() returns its seconds with the kernel library
    loaded."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", WARMUP_CHILD,
         os.path.dirname(os.path.abspath(__file__)), platform],
        capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"warm-up child failed: {r.stderr[-2000:]}")
    w = json.loads(r.stdout.strip().splitlines()[-1])
    if platform == "cuda":
        check(len(w["started"]) == 1 and
              w["started"][0].startswith(w["device"]) and w["library"] == 1,
              f"warm-up: {w}")
    phase("tools warm-up", t0, f"fresh process: Database() {w['database_s']:.3f}"
          f" s, warm-up started for {w['started']}; it took {w['warm_s']} s, "
          f"ensure_transfer_warm() waited {w['wait_s']:.3f} s; kernel "
          f"library loaded: {w['library'] == 1}")
    return w


def fuzz_step(oracle_proc, platform="cuda"):
    """13b and 13c: the differential fuzzer on the host and the device
    routes against sqlite (answers from `oracle_proc`), on the NULL-free
    table and on one with FUZZ_NULLS of each column NULL, and the DML
    fuzzer in memory on both routes and durable at the default config
    with a crash and a reopen."""
    from adacom_tpu_torch.tools import fuzz_differential as fd
    from adacom_tpu_torch.tools import fuzz_dml

    t0 = time.perf_counter()
    out, err = oracle_proc.communicate(timeout=900)
    check(oracle_proc.returncode == 0, f"fuzz oracle failed: {err[-2000:]}")
    want = json.loads(out)
    waited = time.perf_counter() - t0
    res = {}
    for table, nulls in (("plain", 0.0), ("nulls", FUZZ_NULLS)):
        for name, cfg in (("host route", fd.HOST_ROUTE),
                          ("device route", fd.DEVICE_ROUTE)):
            t = time.perf_counter()
            with open(os.devnull, "w") as quiet:
                r = fd.run(FUZZ_QUERIES, FUZZ_SEED, platform, cfg,
                           lambda i, _sql, a=want[table]: a[i], log=quiet,
                           nulls=nulls)
            res[name, table] = r
            check(r["queries"] == FUZZ_QUERIES and not r["divergences"],
                  f"fuzz_differential ({name}, nulls {nulls}): "
                  f"{r['divergences'][:3]}")
            # each dense GROUP BY wider than the fused tiers' took the
            # route's aggregate: the host one, or the generic device path
            took, skipped = ("host_agg", "generic_agg") if cfg is \
                fd.HOST_ROUTE else ("generic_agg", "host_agg")
            check(r["routes"][took] > 0 and r["routes"][skipped] == 0,
                  f"fuzz_differential ({name}, nulls {nulls}): dense GROUP "
                  f"BYs routed {r['routes']}")
            print(f"[tools fuzz_differential {name}, nulls {nulls}] "
                  f"{FUZZ_QUERIES} queries (seed {FUZZ_SEED}), 0 "
                  f"divergences from sqlite; routes {r['routes']}; "
                  f"{time.perf_counter() - t:.2f} s", flush=True)
        check(res["device route", table]["routes"]["device_scan"] > 0,
              "the device route ran no device scan")
        check(res["device route", table]["routes"]["device_scan"] >
              res["host route", table]["routes"]["device_scan"],
              "the host route ran as many device scans as the device route")
    phase("tools fuzz_differential", t0, f"both routes agree with sqlite "
          f"on both tables "
          f"(waited {waited:.1f} s for its answers)")
    t0 = time.perf_counter()
    for name, durable, cfg in (("in memory, host route", False,
                                fd.HOST_ROUTE),
                               ("in memory, device route", False,
                                fd.DEVICE_ROUTE),
                               ("durable, crash and reopen", True, None)):
        t = time.perf_counter()
        r = fuzz_dml.run(FUZZ_OPS, FUZZ_SEED, durable, platform, cfg)
        check(r["mismatch"] is None, f"fuzz_dml ({name}): {r['mismatch']}")
        print(f"[tools fuzz_dml {name}] {FUZZ_OPS} ops (seed {FUZZ_SEED}), "
              f"final state == sqlite's ({r['rows']} rows); routes "
              f"{r['routes']}; {time.perf_counter() - t:.2f} s", flush=True)
    phase("tools fuzz_dml", t0, "three runs, each equal to sqlite")
    return res


def tpch_tools_step(platform="cuda"):
    """13d: verify_sf1 and tpch_sf1 at TOOLS_SF; all 22 answers equal
    sqlite's and Q1/Q6 launch B3."""
    from adacom_tpu_torch.tools import tpch_sf1, verify_sf1

    t0 = time.perf_counter()
    with open(os.devnull, "w") as quiet:
        v = verify_sf1.run(TOOLS_SF, platform, log=quiet)
    check(v["passed"] == v["total"] == 22,
          f"verify_sf1: {[q for q, r in v['queries'].items() if not r['ok']]}"
          f" differ from sqlite")
    b3 = {q: v["queries"][q]["launches"]["B3"] for q in ("Q01", "Q06")}
    engine = sum(r["engine_s"] for r in v["queries"].values())
    oracle = sum(r["oracle_s"] for r in v["queries"].values())
    phase("tools verify_sf1", t0, f"SF {TOOLS_SF}: 22/22 equal to sqlite; "
          f"engine {engine:.3f} s, sqlite {oracle:.3f} s in sum; B3 launches "
          f"{b3}")
    t0 = time.perf_counter()
    with open(os.devnull, "w") as quiet:
        t = tpch_sf1.run(TOOLS_SF, 1, platform, log=quiet)
    check(len(t["tsv"]) == 22, f"tpch_sf1: {len(t['tsv'])} TSV rows")
    b3t = {q: t["launches"][q]["B3"] for q in (1, 6)}
    if platform == "cuda":
        check(min(b3.values()) > 0 and min(b3t.values()) > 0,
              f"Q1/Q6 did not launch B3: {b3}, {b3t}")
    phase("tools tpch_sf1", t0, f"SF {TOOLS_SF}, 1 hot run: {t['size']} B "
          f"compacted; hot sum {t['total']:.3f} s (the reference system's "
          f"SF 1 runtimes sum to {t['ref_total']:.2f} s); B3 launches "
          f"{b3t}; on {t['device']}")
    return v, t


def small_tools_step(platform="cuda"):
    """13e: grouped_agg_bench, string_bench, adaptive_overtime,
    record_suites and q18_stream at small sizes, each checked."""
    import io
    import threading

    from adacom_tpu_torch.tools import (adaptive_overtime, grouped_agg_bench,
                                        q18_stream, record_suites,
                                        string_bench)

    t0 = time.perf_counter()
    g = grouped_agg_bench.run(GROUPED_ROWS, platform)
    on, off = g["engine_s"]["fused_on"], g["engine_s"]["fused_off"]
    if platform == "cuda":
        check(on["route"] == "b2_kernel", f"grouped_agg_bench: {g}")
    phase("tools grouped_agg_bench", t0, f"{GROUPED_ROWS} rows, 6 groups, "
          f"answers equal both ways and to numpy: {on['route']} "
          f"{on['s'] * 1e3:.3f} ms, {off['route']} {off['s'] * 1e3:.3f} ms "
          f"(best of 7); {g['backend']}")
    t0 = time.perf_counter()
    sb = string_bench.run(STRING_ROWS, platform)
    for c in sb:
        check(c["raw_bytes"] > c["dict_bytes"] >= c["dict_fsst_bytes"] or
              c["distinct"] >= STRING_ROWS, f"string_bench: {c}")
    phase("tools string_bench", t0, "; ".join(
        f"{c['distinct']} distinct: raw {c['raw_bytes']} B, dict "
        f"{c['dict_bytes']} B, dict+fsst {c['dict_fsst_bytes']} B (fsst "
        f"{c['fsst_adopted']}), contains {c['scan_contains_s']}, eq "
        f"{c['point_eq_s']}" for c in sb))
    t0 = time.perf_counter()
    with open(os.devnull, "w") as quiet:
        a = adaptive_overtime.run(OVERTIME_ROWS, OVERTIME_S, platform, 2.0,
                                  log=quiet)
    alive = [t.name for t in threading.enumerate()
             if t.name == "adacom-compaction"]
    check(a["policy_rounds"] >= 1 and not alive,
          f"adaptive_overtime: {a['policy_rounds']} rounds, threads {alive}")
    phase("tools adaptive_overtime", t0, f"{OVERTIME_ROWS} rows for "
          f"{OVERTIME_S} s: {a['lookups']} lookups, {a['policy_rounds']} "
          f"policy rounds; all-packed {a['packed_bytes']} B, all-plain "
          f"{a['plain_bytes']} B; last second {a['rows'][-2]!r}; the "
          f"compaction thread stopped")
    t0 = time.perf_counter()
    rows = record_suites.run(SUITES_SCALE, 1, SUITES_PATTERN, platform,
                             log=io.StringIO())
    check(len(rows) == 3, f"record_suites: {rows}")
    phase("tools record_suites", t0, f"scale {SUITES_SCALE}, pattern "
          f"{SUITES_PATTERN!r}, each run verified: " + "; ".join(
              repr(r) for r in rows[1:]))
    t0 = time.perf_counter()
    q = q18_stream.run(TOOLS_SF, platform)
    check(q["on"]["streamed"] > 0 and q["off"]["streamed"] == 0,
          f"q18_stream: {q['on']['streamed']} / {q['off']['streamed']}")
    if platform == "cuda":
        check(q["on"]["peak_extra_device_bytes"] is not None,
              "q18_stream read no device memory")
    phase("tools q18_stream", t0, f"SF {TOOLS_SF}: " + "; ".join(
        f"{m}: Q18 mean {statistics.mean(q[m]['18']) * 1e3:.3f} ms, Q21 "
        f"{statistics.mean(q[m]['21']) * 1e3:.3f} ms, peak RSS "
        f"{q[m]['rss_mb']:.0f} MB, peak extra device memory "
        f"{q[m]['peak_extra_device_bytes']} B, streamed "
        f"{q[m]['streamed']}" for m in ("on", "off")))
    return g, sb, a, rows, q


def tools_path(fuzz_oracle_proc, platform="cuda"):
    """Phase 13: the warm-up, the fuzzers, the TPC-H tools and the other
    measurement tools on the card at cut sizes."""
    warmup_step(platform)
    fuzz_step(fuzz_oracle_proc, platform)
    tpch_tools_step(platform)
    small_tools_step(platform)


# phase 14's sizes (PERF.md section 4)
QC_ROWS = 5_000_000  # the UPDATE table
QC_SF = 0.05  # the COPY round trip of lineitem
QC_OUTER = 1_000_000  # the correlated NOT IN's outer rows
QC_NOT_IN = ("SELECT k, x FROM o WHERE x NOT IN (SELECT y FROM s WHERE "
             "s.k = o.k) ORDER BY k, x NULLS FIRST")


def negative_bounds_step(t1_con, n_rows, t3):
    """14a: a filtered aggregate of t1 (phase 4) and a filtered GROUP BY of
    t3 (phase 6), each with a negative lower bound, launch B1 resp. B2
    exactly once and equal numpy; beside each, the same query with a
    bound of 0 (the route a negative bound took before it folded)."""
    import numpy as np

    from adacom_tpu_torch.ops import fused_scan, grouped_scan

    t0 = time.perf_counter()
    hi = min(n_rows, 5_000_000)
    out = []
    for lo in (-20, 0):
        sql = (f"SELECT count(*), sum(i), min(i), max(i) FROM t1 WHERE "
               f"i >= {lo} AND i < {hi}")
        before = fused_scan.KERNEL_LAUNCHES
        got = t1_con.query(sql).fetchall()
        delta = fused_scan.KERNEL_LAUNCHES - before
        check(got == [(hi, hi * (hi - 1) // 2, 0, hi - 1)],
              f"{sql}: {got} != numpy")
        check(delta == 1, f"{sql}: {delta} B1 launches, not 1")
        t = time.perf_counter()
        check(t1_con.query(sql).fetchall() == got, f"{sql} (hot) differs")
        out.append(f"t1 i >= {lo}: B1 x{delta}, hot "
                   f"{(time.perf_counter() - t) * 1e3:.3f} ms")
    g, v = t3["g"], t3["v"]
    con = t3["db"].connect()
    for lo in (-200_000, 0):
        hi3 = 400_000
        sql = (f"SELECT g, count(*), sum(v) FROM t3 WHERE v >= {lo} AND "
               f"v < {hi3} GROUP BY g ORDER BY g")
        keep = (v >= lo) & (v < hi3)
        cnt = np.bincount(g[keep], minlength=T3_GROUPS)
        sm = np.zeros(T3_GROUPS, np.int64)
        np.add.at(sm, g[keep], v[keep].astype(np.int64))
        before = grouped_scan.GROUPED_LAUNCHES
        got = con.query(sql).fetchall()
        delta = grouped_scan.GROUPED_LAUNCHES - before
        check([(int(r[0]), int(r[1]), int(r[2])) for r in got] ==
              [(i, int(cnt[i]), int(sm[i])) for i in range(T3_GROUPS)],
              f"{sql}: {got} != numpy")
        check(delta == 1, f"{sql}: {delta} B2 launches, not 1")
        t = time.perf_counter()
        check(con.query(sql).fetchall() == got, f"{sql} (hot) differs")
        out.append(f"t3 v >= {lo}: B2 x{delta}, hot "
                   f"{(time.perf_counter() - t) * 1e3:.3f} ms")
    phase("queue C negative bounds", t0, "; ".join(out) + "; == numpy")


def update_step(platform="cuda", n_rows=QC_ROWS):
    """14b: UPDATE of a VARCHAR and a DECIMAL column of an n_rows table on
    the card, its WHERE on the device path, against numpy; then an UPDATE
    that violates a UNIQUE index raises and changes nothing."""
    import numpy as np

    import adacom_tpu_torch as att
    from adacom_tpu_torch.exec import device_scan
    from adacom_tpu_torch.main.connection import SQLError

    t0 = time.perf_counter()
    rng = np.random.default_rng(0x14B)
    k = np.arange(n_rows, dtype=np.int32)
    words = np.asarray(["a", "bb", "ccc", "dd", "e"], dtype=object)
    s = words[rng.integers(0, len(words), n_rows)]
    p = rng.integers(-10**6, 10**6, n_rows).astype(np.int64)  # cents
    db = att.Database(platform=platform)
    con = db.connect()
    con.query("CREATE TABLE u(k INTEGER, s VARCHAR, p DECIMAL(12,2))")
    app = con.appender("u")
    for a in range(0, n_rows, CHUNK):
        app.append_columns({"k": k[a:a + CHUNK], "s": s[a:a + CHUNK],
                            "p": p[a:a + CHUNK]})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    t_load = time.perf_counter() - t0

    def answers():
        rows = con.query("SELECT s, count(*), sum(p) FROM u GROUP BY s "
                         "ORDER BY s").fetchall()
        return [(r[0], int(r[1]), round(float(r[2]) * 100)) for r in rows]

    t = time.perf_counter()
    runs = device_scan.RUNS
    con.query("UPDATE u SET s = 'x', p = p + 0.01 WHERE k % 7 = 0")
    t_upd = time.perf_counter() - t
    check(device_scan.RUNS > runs, "the UPDATE's WHERE skipped the device")
    hit = k % 7 == 0
    s2 = np.where(hit, "x", s)
    p2 = p + hit
    want = [(w, int((s2 == w).sum()), int(p2[s2 == w].sum()))
            for w in sorted(set(words) | {"x"})]
    got = answers()
    check(got == want, f"UPDATE u: {got} != numpy {want}")
    t = time.perf_counter()
    con.query("CREATE UNIQUE INDEX uk ON u(k)")
    t_index = time.perf_counter() - t
    idx = db.catalog.get_table("u").index_on("k")
    probe = [(i, r.tolist()) for i, r in idx.lookup_eq(10)]
    try:
        con.query("UPDATE u SET k = 5 WHERE k BETWEEN 10 AND 11")
        check(False, "an UPDATE violating UNIQUE(k) did not raise")
    except SQLError:
        pass
    check(answers() == want and
          [(i, r.tolist()) for i, r in idx.lookup_eq(10)] == probe and
          con.query("SELECT count(*) FROM u WHERE k BETWEEN 10 AND 11"
                    ).fetchall() == [(2,)],
          "the failed UPDATE changed the table or its index")
    db.close()
    phase("queue C UPDATE", t0, f"{n_rows} rows (load {t_load:.2f} s): "
          f"UPDATE of {int(hit.sum())} rows (VARCHAR, DECIMAL) "
          f"{t_upd:.3f} s == numpy; UNIQUE index {t_index:.3f} s; a "
          f"violating UPDATE raised and changed nothing")


def copy_step(platform="cuda", sf=QC_SF):
    """14c: lineitem at TPC-H SF sf written with COPY TO and read back
    with COPY FROM into the DECIMAL schema answers Q1 and Q6 (B3) exactly
    as the appender-loaded table."""
    import shutil
    import tempfile

    import numpy as np

    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import tpch
    from adacom_tpu_torch.ops import grouped_scan

    t0 = time.perf_counter()
    li = tpch.generate_lineitem(sf)
    d = tempfile.mkdtemp(prefix="adacom-copy-")
    path = os.path.join(d, "lineitem.csv")
    try:
        answers, secs = {}, {}
        for how in ("appender", "copy"):
            db = att.Database(platform=platform)
            con = db.connect()
            t = time.perf_counter()
            if how == "appender":
                tpch.load_into_engine(con, {"lineitem": li})
            else:
                con.query(tpch.DDL["lineitem"])
                n = con.query(f"COPY lineitem FROM '{path}' (HEADER)"
                              ).scalar()
                check(n == len(li["l_orderkey"]), f"COPY FROM read {n} rows")
                col = db.catalog.get_table("lineitem").columns
                for c in ("l_extendedprice", "l_discount", "l_shipdate"):
                    got = np.concatenate([sg._host_values for sg in
                                          col[c].segments])
                    check(np.array_equal(got, li[c]),
                          f"COPY FROM: {c} differs from the generated "
                          f"values")
            secs[how] = time.perf_counter() - t
            db.catalog.get_column_segment_catalog().compact_all_segments()
            before = grouped_scan.MULTI_LAUNCHES
            answers[how] = {q: con.query(tpch.QUERIES[q]).fetchall()
                            for q in (1, 6)}
            check(grouped_scan.MULTI_LAUNCHES > before,
                  f"Q1/Q6 on the {how}'s lineitem skipped B3")
            if how == "appender":
                t = time.perf_counter()
                con.query(f"COPY lineitem TO '{path}' (HEADER)")
                secs["copy to"] = time.perf_counter() - t
            db.close()
        check(answers["copy"] == answers["appender"],
              f"Q1/Q6 after COPY: {answers['copy']} != "
              f"{answers['appender']}")
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    phase("queue C COPY", t0, f"lineitem SF {sf}, {len(li['l_orderkey'])} "
          f"rows: appender {secs['appender']:.2f} s, COPY TO "
          f"{secs['copy to']:.2f} s ({size} B), COPY FROM "
          f"{secs['copy']:.2f} s; Q1 and Q6 (B3) equal exactly")


def not_in_step(platform="cuda", n_outer=QC_OUTER):
    """14d: a correlated NOT IN over two tables with NULLs on both sides
    (o: n_outer rows) equals sqlite."""
    import sqlite3

    import numpy as np

    import adacom_tpu_torch as att

    t0 = time.perf_counter()
    rng = np.random.default_rng(0x14D)
    ok_ = rng.integers(0, n_outer // 4, n_outer).astype(np.int32)
    ox = rng.integers(0, 40, n_outer).astype(np.int32)
    ox_ok = rng.random(n_outer) > 0.05
    sk = rng.integers(0, n_outer // 3, n_outer).astype(np.int32)
    sy = rng.integers(0, 40, n_outer).astype(np.int32)
    sy_ok = rng.random(n_outer) > 0.02
    db = att.Database(platform=platform)
    con = db.connect()
    con.query("CREATE TABLE o(k INTEGER, x INTEGER)")
    con.query("CREATE TABLE s(k INTEGER, y INTEGER)")
    for name, cols, valid in (("o", {"k": ok_, "x": ox}, {"x": ox_ok}),
                              ("s", {"k": sk, "y": sy}, {"y": sy_ok})):
        app = con.appender(name)
        app.append_columns(cols, valid)
        app.close()
    t = time.perf_counter()
    got = [(int(a), None if b is None else int(b))
           for a, b in con.query(QC_NOT_IN).fetchall()]
    t_engine = time.perf_counter() - t
    db.close()
    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE o(k INTEGER, x INTEGER)")
    lite.execute("CREATE TABLE s(k INTEGER, y INTEGER)")
    for name, a, b, v in (("o", ok_, ox, ox_ok), ("s", sk, sy, sy_ok)):
        lite.executemany(f"INSERT INTO {name} VALUES (?, ?)", zip(
            a.tolist(), [int(x) if keep else None
                         for x, keep in zip(b.tolist(), v.tolist())]))
    lite.execute("CREATE INDEX s_k ON s(k, y)")
    t = time.perf_counter()
    want = lite.execute(QC_NOT_IN).fetchall()
    t_lite = time.perf_counter() - t
    lite.close()
    check(got == want, f"correlated NOT IN: {len(got)} rows != sqlite's "
          f"{len(want)}")
    phase("queue C NOT IN", t0, f"{n_outer} outer rows, NULLs on both "
          f"sides: {len(got)} rows == sqlite; engine {t_engine:.3f} s, "
          f"sqlite {t_lite:.3f} s")


def queue_c_path(platform="cuda"):
    """Phase 14b-d (14a runs on phases 4 and 6's tables, before they
    close)."""
    update_step(platform)
    copy_step(platform)
    not_in_step(platform)


# phase 15's appended rows (txn_stress's default: 10M), cut for time
TXN_W_ROWS = 5_000_000


def txn_path(platform="cuda"):
    """Phase 15: txn_stress at its defaults but TXN_W_ROWS appended rows,
    in a temporary directory, crashed with this script's `crash`; one
    `phase 15` line."""
    import shutil
    import tempfile

    from adacom_tpu_torch.tools import txn_stress

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="adacom_txn_")
    try:
        r = txn_stress.run(os.path.join(root, "db"), crash,
                           platform=platform, w_rows=TXN_W_ROWS)
    except RuntimeError as e:
        raise SmokeFailure(f"phase 15: {e}") from e
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(r["auto_checkpoints"] >= 1,
          f"phase 15: no automatic checkpoint ran: {r}")
    check(r["conflicts"] >= 1, f"phase 15: no conflict was raised: {r}")
    check(platform != "cuda" or r["b1_launches"] >= 1,
          f"phase 15: the compacted count(*), sum(v) over w skipped B1: {r}")
    phase("phase 15", t0, f"rows {r['rows']} == the model before the crash "
          f"and after the reopen (sums {r['sums']}); checkpoints: "
          f"{r['auto_checkpoints']} automatic, {r['checkpoints']} explicit, "
          f"{r['refused']} explicit refused; {r['conflicts']} conflicts "
          f"raised; WAL {r['wal_bytes']} B at the crash; reopen "
          f"{r['reopen_s']:.3f} s; B1 launches +{r['b1_launches']} "
          f"(fused scan runs {r['scan_agg']}); threads {r['threads_s']:.2f} "
          f"s; phase {r['seconds']:.2f} s")


# phase 16's points, cut from tools/route_sweep.py's for time (PERF.md §6)
ROUTE_ROWS = (262_144, 1_000_000, 8_000_000)
ROUTE_DOMAINS = (1024, 100_000)
ROUTE_KS = (1, 8, 64)
ROUTE_HOT = 3


def routing_path(platform="cuda", t1_rows=N_ROWS):
    """Phase 16: tools/route_sweep.py at ROUTE_ROWS x ROUTE_DOMAINS (the
    dense GROUP BY on the host aggregate and the generic path) and at
    ROUTE_KS on t1 (the range scan on the host tier and the device scan,
    and under the defaults), every answer equal to numpy; one line per
    point with the route each default takes."""
    from adacom_tpu_torch.config import DBConfig
    from adacom_tpu_torch.exec.executor import dense_agg_on_host
    from adacom_tpu_torch.tools import route_sweep as rs

    t0 = time.perf_counter()
    cfg = DBConfig()
    want = {"host": ("host_aggregate", "host_tier"),
            "generic": ("generic_device_path",), "device": ("device_scan",)}
    with open(os.devnull, "w") as quiet:
        try:
            # one sweep per row count: both routes at every point
            agg = [p for n in ROUTE_ROWS for p in rs.agg_sweep(
                platform, (n,), ROUTE_DOMAINS, ("all",), ROUTE_HOT, quiet)]
            seg = rs.segment_sweep(platform, ROUTE_KS, t1_rows, ROUTE_HOT,
                                   quiet, rs.SEGMENT_ROUTES +
                                   (("defaults", rs.defaults()),))
        except AssertionError as e:  # an answer differed from numpy
            raise SmokeFailure(f"phase 16: {e}") from e
    for section, points in (("agg", agg), ("segments", seg)):
        for p in points:
            for name, rec in p["routes"].items():
                check(platform != "cuda" or name not in want or
                      rec["route"] in want[name],
                      f"phase 16 {section}: route {name} took {rec['route']}")
            r = p["routes"]
            if section == "agg":
                takes = "host aggregate" if dense_agg_on_host(
                    p["rows"], p["domain"], platform, None, cfg) else \
                    "generic device path"
                line = (f"N {p['rows']}, D {p['domain']}: host "
                        f"{r['host']['hot_ms']:.3f} ms, generic "
                        f"{r['generic']['hot_ms']:.3f} ms; "
                        f"device_agg_min_rows {cfg.device_agg_min_rows} "
                        f"takes the {takes}")
            else:
                line = (f"k {p['k']} ({p['rows']} rows): host "
                        f"{r['host']['hot_ms']:.3f} ms, device "
                        f"{r['device']['hot_ms']:.3f} ms; host_materialize "
                        f"{cfg.host_materialize}, host_scan_segment_limit "
                        f"{cfg.host_scan_segment_limit} take the "
                        f"{r['defaults']['route']} "
                        f"({r['defaults']['hot_ms']:.3f} ms)")
            print(f"[routing {section}] {line}; == numpy", flush=True)
    phase("routing", t0, f"{len(agg)} GROUP BY points and {len(seg)} range "
          f"scans, both routes of each == numpy")


# phase 17's input size, in elements per function
NATIVE_ROWS = 1 << 21


def native_step():
    """Phase 17: every function of native.py against its NumPy path
    (tools/native_check.py) on inputs of NATIVE_ROWS elements; one line."""
    from adacom_tpu_torch.tools import native_check

    t0 = time.perf_counter()
    res = native_check.compare(NATIVE_ROWS)
    check(not res["failures"], f"phase 17: the native library differs from "
                               f"its NumPy path in {res['failures']}")
    phase("native==numpy", t0, f"{res['comparisons']} comparisons at "
          f"{NATIVE_ROWS} elements, every function of native.py equal to "
          f"its NumPy path ({os.path.basename(res['library'])}, built for "
          f"this host); {res['seconds']:.2f} s")


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
    from adacom_tpu_torch.ops import fused_scan, grouped_scan

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
    entries = []
    for p in log_path:
        with open(p) as f:
            entries += ptxas_entries(f.read())
    regs = [e[1] for e in entries]
    grouped = [f"{name} {r} regs {sp} B spilled" for name, r, sp in entries
               if name.startswith("grouped_scan")]
    phase("build", t0, f"kernels {t_kern:.1f} s, native "
          f"{t_all - t_kern:.1f} s; threads/block "
          f"{lib.adacom_table_scan_threads()} (B1), "
          f"{lib.adacom_grouped_scan_threads()} (B2/B3); ptxas max registers "
          f"{max(regs) if regs else 'n/a'}, spill stores "
          f"{sum(e[2] for e in entries)} B over {len(regs)} kernels; "
          f"{'; '.join(grouped)}")

    # ---- 17. the native host library against its NumPy path -----------
    native_step()

    # ---- 3. kernels against their plain versions ------------------------
    t0 = time.perf_counter()
    n_cmp, b1_err = kernel_vs_plain(dev)
    phase("kernel==plain B1", t0, f"{n_cmp} comparisons over widths 1..32, "
          f"all exact (max_abs_err {b1_err})")
    t0 = time.perf_counter()
    n_cmp, b2_err, modes = grouped_vs_plain(dev)
    phase("kernel==plain B2", t0, f"{n_cmp} comparisons (group x value "
          f"widths, 4 ranges each; one group at maximal codes, 16 groups "
          f"across a warp, 300 ragged segments, one segment), all exact "
          f"(max_abs_err {b2_err})")
    t0 = time.perf_counter()
    n_cmp, b3_err, b3_modes = multi_vs_plain(dev)
    modes |= b3_modes
    check(modes == {True, False}, f"accumulator modes run: {modes}")
    phase("kernel==plain B3", t0, f"{n_cmp} comparisons (0..6 group planes, "
          f"1..8 value planes, 0..8 predicates; maximal terms, 16 groups "
          f"across a warp, 16 groups x 33 outputs, 300 ragged segments with "
          f"a narrower stack, one segment), all exact (max_abs_err "
          f"{b3_err}); both accumulator modes (private slots, warp "
          f"aggregation) ran")

    # ---- 10a. the card's bandwidth (roofline), before the B1 timing ------
    roof = roofline_step(dev)
    read_gbps = roof["read"]["events_gbps"]

    # ---- 4. main path at 100M rows, then NULLs (B1) ----------------------
    db1 = db = att.Database(platform="cuda")
    con1 = con = db.connect()
    fused_scan.KERNEL_LAUNCHES = 0  # count the main path's launches only
    segs = main_path(db, con, N_ROWS, HOT_RUNS, N_LOOKUPS)
    nulls(db, con, NULL_ROWS)
    b1_launches = fused_scan.KERNEL_LAUNCHES  # the main path's count, read now

    # B1 alone, its wrapper and its plain version at the main path's shape
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
    b1_err = max(b1_err, max(abs(a - b) for a, b in zip(got, ref)))
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

    b1_ms = cuda_ms(launch, 50)
    wrapper_ms = cuda_ms(lambda: fused_scan.scan_table(
        words, counts, mins, lanes=lanes, device_out=True), 50)
    b1_plain_ms = cuda_ms(lambda: fused_scan.scan_table_reference(
        words, counts, mins, lanes=lanes, device_out=True), 5)
    nbytes = words.numel() * 4
    b1_bound = bound_ms(nbytes + sc.numel() * 4 + 4 * 8)
    phase("timing B1", t0, f"shape {tuple(words.shape)} ({nbytes} B): kernel "
          f"{b1_ms:.4f} ms = {nbytes / b1_ms / 1e6:.1f} GB/s; wrapper (kernel "
          f"+ epilogue) {wrapper_ms:.4f} ms; plain version "
          f"{b1_plain_ms:.3f} ms; "
          f"{_bound_line(nbytes + sc.numel() * 4 + 4 * 8, b1_ms)}; "
          f"{100 * nbytes / b1_ms / 1e6 / read_gbps:.1f}% of the measured "
          f"read bandwidth {read_gbps:.1f} GB/s (roofline)")
    del words, part, segs, entries

    # the sqlite oracle of phase 9, started once B1 is timed: it computes
    # while phases 5-8 run (about 210 s of command on the card's host)
    tpch_oracle_proc = start_oracle("--tpch-oracle", TPCH9_SF)
    try:
        # ---- 5. TPC-H Q1 and Q6 at SF 10 (B3) -------------------------------
        grouped_scan.MULTI_LAUNCHES = 0
        tp = tpch_path(HOT_RUNS)
        b3_launches = grouped_scan.MULTI_LAUNCHES

        t0 = time.perf_counter()
        b3 = {}
        for q in (1, 6):
            ms, wrapper, plain, err = time_multi(tp[q]["calls"])
            b3_err = max(b3_err, err)
            nbytes = _packed_bytes(tp[q]["calls"], "B3")
            bb = _bound_bytes(tp[q]["calls"], "B3")
            b3[q] = (ms, wrapper, plain, bound_ms(bb))
            print(f"[timing B3 Q{q}] {len(tp[q]['calls'])} launch(es), "
                  f"{nbytes} packed B: kernel {ms:.4f} ms = "
                  f"{nbytes / ms / 1e6:.1f} GB/s, "
                  f"{100 * nbytes / ms / 1e6 / read_gbps:.1f}% of the measured "
                  f"read bandwidth; {_bound_line(bb, ms)}; "
                  f"wrapper {wrapper:.4f} ms; "
                  f"plain version {plain:.3f} ms; hot query "
                  f"{tp[q]['hot'] * 1e3:.3f} ms, host time outside the wrapper "
                  f"{tp[q]['hot'] * 1e3 - wrapper:.3f} ms", flush=True)
        phase("timing B3", t0, f"lineitem packed {tp['packed_bytes']} B vs "
              f"plain {tp['plain_bytes']} B")
        tp["db"].close()
        del tp["db"]

        # ---- 6. 100M-row GROUP BY (B2) --------------------------------------
        grouped_scan.GROUPED_LAUNCHES = 0
        t3 = b2_path(HOT_RUNS)
        b2_launches = grouped_scan.GROUPED_LAUNCHES

        t0 = time.perf_counter()
        b2_ms, b2_wrapper, b2_plain_ms, err = time_grouped(t3["calls"])
        b2_err = max(b2_err, err)
        nbytes = _packed_bytes(t3["calls"], "B2")
        bb = _bound_bytes(t3["calls"], "B2")
        b2_bound = bound_ms(bb)
        phase("timing B2", t0, f"{len(t3['calls'])} launch(es), {nbytes} packed "
              f"B: kernel {b2_ms:.4f} ms = {nbytes / b2_ms / 1e6:.1f} GB/s, "
              f"{100 * nbytes / b2_ms / 1e6 / read_gbps:.1f}% of the measured "
              f"read bandwidth; "
              f"{_bound_line(bb, b2_ms)}; wrapper {b2_wrapper:.4f} ms; plain version {b2_plain_ms:.3f} ms; "
              f"hot query {t3['hot'] * 1e3:.3f} ms")
        # ---- 6b. GROUP BY over NULLs at T5_ROWS rows on three routes --------
        t0 = time.perf_counter()
        _zero_counts()
        t5_path(t3["db"].connect(), t3["want"])
        phase("t5 nulls", t0, f"launches on this path: {_counts_line()}")
        # ---- 14a. negative bounds on t1 and t3 (B1, B2) ---------------------
        t0 = time.perf_counter()
        _zero_counts()
        negative_bounds_step(con1, N_ROWS, t3)
        phase("queue C a", t0, f"launches on this path: {_counts_line()}")
        t3["db"].close()
        del t3["db"], t3["g"], t3["v"]

    except BaseException:
        stop(tpch_oracle_proc)
        raise

    # the sqlite oracles of phases 10d and 13b start below (ClickBench's
    # once phase 8 has freed t4's host arrays); they compute while phases
    # 9-10c run
    cb_oracle = fuzz_oracle_proc = None
    try:
        # ---- 8. the generic device path -------------------------------------
        t0 = time.perf_counter()
        n_cmp = codecs_on_card(dev)
        phase("generic codecs", t0, f"{n_cmp} comparisons (constant, rle, "
              f"delta, dictionary, alp at {list(CODEC_COUNTS)} rows: decode, "
              f"gather, pool of two), card == host bit for bit")
        t4_path(HOT_RUNS).close()
        adaptive_mix(db1, con1, N_ROWS, HOT_RUNS)
        db1.close()
        del db1, con1, db, con
        cb_oracle = start_oracle("--clickbench-oracle", CB_SCALE)

        # ---- 9. the relational path: TPC-H SF 1, against sqlite -----------
        t0 = time.perf_counter()
        _zero_counts()
        tpch_records, tpch_data, tpch_want = relational_path(
            TPCH9_HOT, oracle=tpch_oracle_proc)
        phase("relational", t0, f"launches on this path: {_counts_line()}")
        check(grouped_scan.MULTI_LAUNCHES > 0, "phase 9 launched no B3")

        # ---- 11. durable TPC-H SF 1 and the client surface ---------------
        t0 = time.perf_counter()
        _zero_counts()
        durable_path(tpch_data, tpch_want)
        phase("durable", t0, f"launches on this path: {_counts_line()}")
        check(grouped_scan.MULTI_LAUNCHES > 0 and
              fused_scan.KERNEL_LAUNCHES > 0, "phase 11 skipped B3 or B1")

        # ---- 12. the multi-device layer: the twin dryrun, TPC-H on a mesh -
        mesh_dryrun()
        t0 = time.perf_counter()
        mesh_path(tpch_data, tpch_want, tpch_records)
        phase("mesh", t0, f"launches on this path: {_counts_line()}")
        del tpch_data, tpch_want, tpch_records

        # the sqlite answers of phase 13b's fuzzer, computed while phase 10
        # runs
        fuzz_oracle_proc = start_oracle("--fuzz-oracle", FUZZ_SEED)

        # ---- 10. the benchmark surface: headline, [succinct], ClickBench --
        headline_step()
        succinct_step(SUCCINCT_SCALE)
        clickbench_step(cb_oracle, CB_SCALE)

        # ---- 13. the tools: warm-up, fuzzers, TPC-H tools, the rest ------
        t0 = time.perf_counter()
        _zero_counts()
        tools_path(fuzz_oracle_proc)
        phase("tools", t0, f"launches on this path: {_counts_line()}")
        check(min(_launches()) > 0, f"phase 13 skipped a device tier: "
              f"{_counts_line()}")

        # ---- 14b-d. UPDATE, COPY into DECIMAL, correlated NOT IN ----------
        t0 = time.perf_counter()
        _zero_counts()
        queue_c_path()
        phase("queue C", t0, f"launches on this path: {_counts_line()}")
        check(grouped_scan.MULTI_LAUNCHES > 0,
              "phase 14 launched no B3")

        # ---- 15. concurrent writers, transactions and checkpoints --------
        t0 = time.perf_counter()
        _zero_counts()
        txn_path()
        phase("txn", t0, f"launches on this path: {_counts_line()}")
        check(fused_scan.KERNEL_LAUNCHES > 0, "phase 15 launched no B1")

        # ---- 16. the routing defaults: both routes of each knob ----------
        t0 = time.perf_counter()
        _zero_counts()
        routing_path()
        phase("route", t0, f"launches on this path: {_counts_line()}")
        check(_launches()[-1] > 0, "phase 16 ran no generic device path")
    finally:
        stop(tpch_oracle_proc)
        stop(cb_oracle)
        stop(fuzz_oracle_proc)

    check(min(b1_launches, b2_launches, b3_launches) > 0,
          f"a kernel was not launched on its main path: B1 {b1_launches}, "
          f"B2 {b2_launches}, B3 {b3_launches}")
    grouped_src = "adacom_tpu_torch/csrc/grouped_scan.cu"
    print(json.dumps({"kernels": [
        {"name": "table_scan", "route": "cuda",
         "source": "adacom_tpu_torch/csrc/table_scan.cu",
         "replaces": "adacom_tpu/ops/pallas_scan.py:227",
         "launches": b1_launches, "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "grouped_scan", "route": "cuda", "source": grouped_src,
         "replaces": "adacom_tpu/ops/pallas_scan.py:529",
         "launches": b2_launches, "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "multi_grouped_scan", "route": "cuda", "source": grouped_src,
         "replaces": "adacom_tpu/ops/pallas_scan.py:795",
         "launches": b3_launches, "max_abs_err": b3_err,
         "ms": b3[1][0], "plain_ms": b3[1][2], "bound_ms": b3[1][3],
         "bound_by": "bytes", "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["--tpch-oracle"], ["--clickbench-oracle"],
                         ["--fuzz-oracle"]):
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        oracle_of = {"--tpch-oracle": tpch_oracle,
                     "--clickbench-oracle": clickbench_oracle,
                     "--fuzz-oracle": fuzz_oracle}
        oracle_of[sys.argv[1]](float(sys.argv[2]))
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
