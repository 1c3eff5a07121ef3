#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adacom_tpu_torch) once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and a C++ compiler, and
imports nothing of JAX. Phases, one line each, any failure exits non-zero:

1. device: the card's name and power limit, CUDA present;
2. build: the kernels (csrc/*.cu, one nvcc per source, for sm_90a) and
   the native host library, from the checkout's sources;
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
7. timing: each kernel alone, its wrapper and its plain version at its
   main path's shape (CUDA events), after the launch counts were read,
   with its bound (the bytes it must move at 3.35 TB/s). No single PyTorch
   call unpacks the vertical-lane layout, so `library_ms` is null;
8. the generic device path (PyTorch tensor ops, no kernel of its own):
   a. every codec (constant, rle, delta, dictionary, alp) decodes on the
      card to the host values bit for bit at 1, 4,097, 65,535 and 65,536
      rows (whole segment, gather, a pool of two);
   b. t4: 100M rows of (k BIGINT, r INTEGER, d INTEGER, f DOUBLE,
      c INTEGER) compacted with compression_codec='auto' (delta, rle,
      dictionary, alp, succinct on every segment); the ungrouped
      aggregate over all five columns, a 1,000-group GROUP BY (also on the
      host aggregate), a filtered aggregate, a device scan
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
   segments, after compaction, and compacted with host_materialize=false
   (the device scan feeds the joins), each equal to sqlite's; for the two
   compacted runs each query prints its cold time, the median of 3 hot
   runs, the device time and kernels of one hot run and its routes (the
   streamed join, streamed aggregate and index join counters, the generic
   path's runs, the B1/B2/B3 launches); Q1 and Q6 must launch B3. Then a
   window query over orders, UNION/EXCEPT/INTERSECT, DISTINCT, FROM-less
   SELECTs, (VALUES ...) joined to nation and samples, against sqlite; a
   join and sorts under a memory_limit that makes them spill, against
   their answers in RAM; the pool cache's bytes and the phase's peak
   extra device memory (at most 4 GiB each).

Each main path (4, 5, 6, 9) runs with the launch counts set to 0 just
before it and read just after. The last two lines are the kernels' JSON
record and the result line. `python3 chip_smoke.py --tpch-oracle SF` is
phase 9's sqlite subprocess (no card needed).
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
T4_ROWS = 100_000_000
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
    return dict(cold=t_cold, hot=t_hot, calls=list(rec.calls), db=db)


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
    """Phase 8b: t4 at 100M rows under compression_codec='auto' (k delta,
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
    # the same query on the host aggregate (device_agg_min_rows above the
    # row count)
    t = time.perf_counter()
    con.query(f"SET device_agg_min_rows={n_rows + 1}")
    host_t = []
    for _ in range(3):
        t1 = time.perf_counter()
        host = con.query(group_sql).fetchall()
        host_t.append(time.perf_counter() - t1)
        verify_grouped(host)
    con.query("SET device_agg_min_rows=32000000")
    phase("generic t4 GROUP BY r on the host aggregate", t,
          f"== numpy; median of 3 {statistics.median(host_t) * 1e3:.3f} ms "
          f"against {device_ms:.3f} ms on the generic device path")

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
    host_rows = con.query(scan_sql).fetchall()
    check([(int(a), float(b)) for a, b in host_rows] == want_rows,
          "host-tier scan != numpy")

    def verify_scan(got):
        check(got == host_rows, f"device scan: {len(got)} rows != host "
                                f"tier's {len(host_rows)}")

    con.query("SET host_materialize=false")
    generic_query(con, "t4 device scan", scan_sql, hot_runs, verify_scan,
                  "t4")
    con.query("SET host_materialize=true")

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
TPCH9_HOT = 3
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


def relational_path(hot_runs, sf=TPCH9_SF, platform="cuda"):
    """Phase 9: TPC-H at scale factor sf on the card, every answer held
    against sqlite in a subprocess. Returns the per-query records."""
    import numpy as np
    import torch

    import adacom_tpu_torch as att
    from adacom_tpu_torch.bench import tpch
    from adacom_tpu_torch.exec import spill

    oracle = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tpch-oracle", str(sf)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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
        del data
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
            if mode == "device scan":
                con.query("SET host_materialize=false")
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
        return records
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.communicate()


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
          f"{_bound_line(nbytes + sc.numel() * 4 + 4 * 8, b1_ms)}")
    del words, part, segs, entries

    # ---- 5. TPC-H Q1 and Q6 at SF 10 (B3) ---------------------------------
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
              f"{nbytes / ms / 1e6:.1f} GB/s; {_bound_line(bb, ms)}; "
              f"wrapper {wrapper:.4f} ms; "
              f"plain version {plain:.3f} ms; hot query "
              f"{tp[q]['hot'] * 1e3:.3f} ms, host time outside the wrapper "
              f"{tp[q]['hot'] * 1e3 - wrapper:.3f} ms", flush=True)
    phase("timing B3", t0, f"lineitem packed {tp['packed_bytes']} B vs "
          f"plain {tp['plain_bytes']} B")
    tp["db"].close()
    del tp["db"]

    # ---- 6. 100M-row GROUP BY (B2) -----------------------------------------
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
          f"B: kernel {b2_ms:.4f} ms = {nbytes / b2_ms / 1e6:.1f} GB/s; "
          f"{_bound_line(bb, b2_ms)}; wrapper {b2_wrapper:.4f} ms; plain version {b2_plain_ms:.3f} ms; "
          f"hot query {t3['hot'] * 1e3:.3f} ms")
    t3["db"].close()
    del t3["db"]

    # ---- 8. the generic device path -----------------------------------------
    t0 = time.perf_counter()
    n_cmp = codecs_on_card(dev)
    phase("generic codecs", t0, f"{n_cmp} comparisons (constant, rle, "
          f"delta, dictionary, alp at {list(CODEC_COUNTS)} rows: decode, "
          f"gather, pool of two), card == host bit for bit")
    t4_path(HOT_RUNS).close()
    adaptive_mix(db1, con1, N_ROWS, HOT_RUNS)
    db1.close()
    del db1, con1, db, con

    # ---- 9. the relational path: TPC-H SF 1, against sqlite ---------------
    t0 = time.perf_counter()
    fused_scan.KERNEL_LAUNCHES = grouped_scan.GROUPED_LAUNCHES = 0
    grouped_scan.MULTI_LAUNCHES = 0
    relational_path(TPCH9_HOT)
    phase("relational", t0, f"launches on this path: B1 "
          f"{fused_scan.KERNEL_LAUNCHES}, B2 {grouped_scan.GROUPED_LAUNCHES}, "
          f"B3 {grouped_scan.MULTI_LAUNCHES}")
    check(grouped_scan.MULTI_LAUNCHES > 0, "phase 9 launched no B3")

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
    if sys.argv[1:2] == ["--tpch-oracle"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        tpch_oracle(float(sys.argv[2]))
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
