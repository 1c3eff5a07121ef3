"""Window-function execution over materialized batches.

Port of adacom_tpu/exec/window.py, copied as it is (numpy only).

Parity with the reference's window operator
(src/execution/operator/aggregate/physical_window.cpp + the segment-tree
frame aggregator src/execution/window_segment_tree.cpp). The TPU-native
design differs: rows are sorted once per window (partition keys major,
order keys minor), partitions become contiguous segments, and every
function is computed with vectorized segmented primitives:

- running extrema use a Hillis-Steele doubling scan (O(n log n), no Python
  loop over partitions);
- arbitrary ROWS frames for min/max use a power-of-two sparse table (the
  vectorized analogue of the reference's window segment tree);
- sums/counts/averages over any frame are two prefix-sum gathers.

All computation here is host-side NumPy: window queries in the reference's
workloads are small post-aggregation decorations, not the scan hot path
(which stays on device; see executor._scan_batches).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------
# segmented primitives
# ---------------------------------------------------------------------


def seg_starts_of(part_id_sorted: np.ndarray) -> np.ndarray:
    n = len(part_id_sorted)
    if n == 0:
        return np.empty(0, np.int64)
    return np.flatnonzero(
        np.r_[True, part_id_sorted[1:] != part_id_sorted[:-1]]
    ).astype(np.int64)


def expand_starts(starts: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row partition start and end (exclusive) from segment starts."""
    ends = np.r_[starts[1:], n]
    lens = ends - starts
    pstart = np.repeat(starts, lens)
    pend = np.repeat(ends, lens)
    return pstart, pend


def segmented_running_extreme(a: np.ndarray, pstart: np.ndarray, is_min: bool) -> np.ndarray:
    """Inclusive running min/max within each partition (sorted domain)."""
    n = len(a)
    out = a.copy()
    idx = np.arange(n, dtype=np.int64)
    op = np.minimum if is_min else np.maximum
    shift = 1
    while shift < n:
        prev = idx - shift
        ok = prev >= pstart
        if ok.any():
            merged = op(out[ok], out[prev[ok]])
            out = out.copy()
            out[ok] = merged
        shift <<= 1
    return out


class RangeExtreme:
    """Sparse-table range min/max over a 1-D array: O(n log n) build, O(1)
    per query, all queries answered in one vectorized gather pass (the
    reference's window_segment_tree.cpp equivalent)."""

    def __init__(self, a: np.ndarray, is_min: bool):
        self.op = np.minimum if is_min else np.maximum
        self.tables = [a]
        n = len(a)
        k = 1
        while (1 << k) <= n:
            prev = self.tables[-1]
            half = 1 << (k - 1)
            self.tables.append(self.op(prev[: n - (1 << k) + 1], prev[half : n - half + 1]))
            k += 1

    def query(self, lo: np.ndarray, hi: np.ndarray):
        """Extreme over [lo, hi) per element; hi > lo required."""
        ln = hi - lo
        k = np.zeros(len(ln), np.int64)
        nz = ln > 0
        k[nz] = np.int64(np.floor(np.log2(ln[nz])))
        out = np.empty(len(ln), self.tables[0].dtype)
        for kk in range(len(self.tables)):
            m = (k == kk) & nz
            if m.any():
                t = self.tables[kk]
                out[m] = self.op(t[lo[m]], t[hi[m] - (1 << kk)])
        return out


# ---------------------------------------------------------------------
# frame bounds
# ---------------------------------------------------------------------


def frame_bounds(frame, pos, pstart, pend, peer_start, peer_end, has_order):
    """Per-row [fs, fe) in the sorted domain.

    Default frame (no clause): RANGE UNBOUNDED PRECEDING..CURRENT ROW when
    ORDER BY is present (current row's peers included), else the whole
    partition — matching the SQL standard and the reference's binder."""
    if frame is None:
        if has_order:
            return pstart, peer_end
        return pstart, pend

    mode, start, end = frame

    def lo_of(bound):
        kind = bound[0]
        if kind == "unbounded_preceding":
            return pstart
        if kind == "current":
            return pos if mode == "rows" else peer_start
        if kind == "preceding":
            return pos - int(bound[1])
        if kind == "following":
            return pos + int(bound[1])
        if kind == "unbounded_following":
            return pend
        raise ValueError(bound)

    def hi_of(bound):
        kind = bound[0]
        if kind == "unbounded_following":
            return pend
        if kind == "current":
            return pos + 1 if mode == "rows" else peer_end
        if kind == "preceding":
            return pos - int(bound[1]) + 1
        if kind == "following":
            return pos + int(bound[1]) + 1
        if kind == "unbounded_preceding":
            return pstart
        raise ValueError(bound)

    fs = np.clip(lo_of(start), pstart, pend)
    fe = np.clip(hi_of(end), pstart, pend)
    fe = np.maximum(fe, fs)  # empty frame -> fs == fe
    return fs, fe


# ---------------------------------------------------------------------
# per-function computation (sorted domain)
# ---------------------------------------------------------------------


def compute_sorted(func: str, args_sorted, frame, has_order,
                   pos, pstart, pend, peer_start, peer_end,
                   is_decimal_sum: bool, const_args):
    """Returns (values, valid|None) in the sorted domain.

    args_sorted: list of (value_array, valid_array|None).
    const_args: python constants for ntile/lag/lead offsets."""
    n = len(pos)
    plen = pend - pstart

    if func == "row_number":
        return pos - pstart + 1, None
    if func == "rank":
        return peer_start - pstart + 1, None
    if func == "dense_rank":
        new_peer = np.zeros(n, bool)
        new_peer[np.unique(peer_start)] = True
        c = np.cumsum(new_peer)
        return c - c[pstart] + 1, None
    if func == "percent_rank":
        r = (peer_start - pstart).astype(np.float64)
        d = np.maximum(plen - 1, 1).astype(np.float64)
        out = np.where(plen > 1, r / d, 0.0)
        return out, None
    if func == "cume_dist":
        return (peer_end - pstart) / plen.astype(np.float64), None
    if func == "ntile":
        k = max(int(const_args[0]), 1)
        i = pos - pstart
        size = plen // k
        rem = plen % k
        big = rem * (size + 1)
        in_big = i < big
        with np.errstate(divide="ignore", invalid="ignore"):
            bucket_small = np.where(size > 0, (i - big) // np.maximum(size, 1) + rem, 0)
        out = np.where(in_big, i // (size + 1), bucket_small) + 1
        return out.astype(np.int64), None

    if func in ("lag", "lead"):
        off = int(const_args[0]) if const_args else 1
        x, xv = args_sorted[0]
        if func == "lag":
            src = pos - off
            ok = src >= pstart
        else:
            src = pos + off
            ok = src < pend
        safe = np.where(ok, src, pos)
        out = x[safe]
        valid = ok.copy()
        if xv is not None:
            valid &= xv[safe]
        if len(args_sorted) > 2 or (len(const_args) > 1 and const_args[1] is not None):
            default = const_args[1]
            out = np.where(ok, out, np.asarray(default, dtype=out.dtype))
            valid = None if xv is None else np.where(ok, valid, True)
        return out, valid

    fs, fe = frame_bounds(frame, pos, pstart, pend, peer_start, peer_end, has_order)
    nonempty = fe > fs

    if func in ("first_value", "last_value", "nth_value", "first", "any_value"):
        x, xv = args_sorted[0]
        if func == "last_value":
            src = fe - 1
        elif func == "nth_value":
            src = fs + int(const_args[0]) - 1
            nonempty = nonempty & (src < fe)
        else:
            src = fs
        safe = np.where(nonempty, src, pos)
        out = x[safe]
        valid = nonempty.copy()
        if xv is not None:
            valid &= xv[safe]
        return out, (None if valid.all() else valid)

    # frame aggregates
    if func == "count":
        if not args_sorted:  # count(*)
            return (fe - fs).astype(np.int64), None
        x, xv = args_sorted[0]
        m = np.ones(n, np.int64) if xv is None else xv.astype(np.int64)
        cs = np.r_[0, np.cumsum(m)]
        return cs[fe] - cs[fs], None

    x, xv = args_sorted[0]
    m = None if xv is None else xv
    if func in ("sum", "avg", "stddev", "stddev_samp", "var_samp", "variance"):
        if x.dtype.kind == "f":
            acc = x.astype(np.float64)
        else:
            acc = x.astype(np.int64)
        vals = acc if m is None else np.where(m, acc, 0)
        cs = np.r_[np.zeros(1, vals.dtype), np.cumsum(vals)]
        s = cs[fe] - cs[fs]
        cnt_m = np.ones(n, np.int64) if m is None else m.astype(np.int64)
        cc = np.r_[0, np.cumsum(cnt_m)]
        cnt = cc[fe] - cc[fs]
        if func == "sum":
            valid = cnt > 0
            return s, (None if valid.all() else valid)
        if func == "avg":
            with np.errstate(divide="ignore", invalid="ignore"):
                out = s.astype(np.float64) / np.maximum(cnt, 1)
            valid = cnt > 0
            return out, (None if valid.all() else valid)
        # variance family: E[x^2] - E[x]^2 over the frame
        sq = vals.astype(np.float64) ** 2
        cq = np.r_[0.0, np.cumsum(sq)]
        s2 = cq[fe] - cq[fs]
        cntf = np.maximum(cnt, 1).astype(np.float64)
        mean = s.astype(np.float64) / cntf
        var = (s2 - cntf * mean * mean) / np.maximum(cntf - 1, 1)
        var = np.maximum(var, 0.0)
        if func in ("stddev", "stddev_samp"):
            out = np.sqrt(var)
        else:
            out = var
        valid = cnt > 1
        return out, (None if valid.all() else valid)

    if func in ("min", "max"):
        is_min = func == "min"
        if m is not None:
            if x.dtype.kind == "f":
                fill = np.inf if is_min else -np.inf
                x = np.where(m, x, fill)
            else:
                info = np.iinfo(x.dtype if x.dtype.kind in "iu" else np.int64)
                fill = info.max if is_min else info.min
                x = np.where(m, x, fill)
        cnt_m = np.ones(n, np.int64) if m is None else m.astype(np.int64)
        cc = np.r_[0, np.cumsum(cnt_m)]
        cnt = cc[fe] - cc[fs]
        # fast path: running frame from the partition start
        if np.array_equal(fs, pstart) and (
            np.array_equal(fe, pos + 1) or np.array_equal(fe, peer_end)
        ):
            run = segmented_running_extreme(x, pstart, is_min)
            out = run if np.array_equal(fe, pos + 1) else run[fe - 1]
        elif np.array_equal(fs, pstart) and np.array_equal(fe, pend):
            idx_last = fe - 1
            run = segmented_running_extreme(x, pstart, is_min)
            out = run[idx_last]
        else:
            rq = RangeExtreme(x, is_min)
            out = np.zeros(n, x.dtype)
            ne = nonempty
            if ne.any():
                out[ne] = rq.query(fs[ne], fe[ne])
        valid = cnt > 0
        return out, (None if valid.all() else valid)

    raise ValueError(f"unsupported window function {func}")
