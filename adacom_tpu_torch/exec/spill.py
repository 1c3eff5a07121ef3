"""Out-of-core operators: partitioned spilling join and external sort.

Port of adacom_tpu/exec/spill.py, copied as it is (numpy only).

Reference capabilities: the spilling hash join (ProbeSpill,
src/execution/join_hashtable.cpp:16 — partition both sides when the hash
table exceeds memory, process partition by partition) and the external
merge sort (src/common/sort/merge_sorter.cpp).

TPU-native/host redesign: materialized batches are host numpy, so the
out-of-core risk is (a) the |pairs| expansion of a large join and (b)
the O(n) take() copies of a large sort. Both spill to disk-backed
numpy memmaps under a byte budget derived from the engine memory_limit:

- the join hash-partitions BOTH inputs by key hash (grace hash join),
  joins partition pairs one at a time (bounding the in-RAM working set),
  and streams the resulting pair indices into memmaps;
- the sort is an external SAMPLE sort: sample the primary key to pick
  P-1 range boundaries, bucket rows to disk, sort each bucket in RAM,
  and concatenate — bucket order IS global order (equal primary keys
  never split across buckets; ties are broken in-bucket by the full
  lexsort so the result matches a one-shot lexsort up to tie order).

Temp files live in a TemporaryDirectory deleted when the returned arrays
are garbage collected (the memmap keeps the fd alive on POSIX)."""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import numpy as np


class _SpillDir:
    """Temp dir whose lifetime is tied to the arrays mapped from it."""

    def __init__(self):
        self._td = tempfile.TemporaryDirectory(prefix="adacom_spill_")
        self.path = self._td.name
        self._n = 0

    def memmap(self, shape, dtype) -> np.memmap:
        self._n += 1
        fn = os.path.join(self.path, f"m{self._n}.bin")
        mm = np.memmap(fn, dtype=dtype, mode="w+", shape=shape)
        mm._spill_dir = self  # keep the directory alive
        return mm


def partitioned_join_pairs(lk: np.ndarray, rk: np.ndarray,
                           n_partitions: int):
    """Grace-hash-join pair generation: equal-key (li, ri) pairs computed
    per hash partition, streamed to disk. Returns (li, ri) memmaps.

    lk/rk are 64-bit key hashes (u64); callers verify real key equality
    afterwards exactly like the in-RAM path."""
    P = max(2, int(n_partitions))
    lp = (lk % np.uint64(P)).astype(np.int64)
    rp = (rk % np.uint64(P)).astype(np.int64)
    l_order = np.argsort(lp, kind="stable")
    r_order = np.argsort(rp, kind="stable")
    l_bounds = np.searchsorted(lp[l_order], np.arange(P + 1))
    r_bounds = np.searchsorted(rp[r_order], np.arange(P + 1))

    sd = _SpillDir()
    chunks: List[tuple] = []
    total = 0
    for p in range(P):
        li_rows = l_order[l_bounds[p]:l_bounds[p + 1]]
        ri_rows = r_order[r_bounds[p]:r_bounds[p + 1]]
        if len(li_rows) == 0 or len(ri_rows) == 0:
            continue
        rkp = rk[ri_rows]
        order = np.argsort(rkp, kind="stable")
        rks = rkp[order]
        lkp = lk[li_rows]
        lo = np.searchsorted(rks, lkp, "left")
        hi = np.searchsorted(rks, lkp, "right")
        counts = hi - lo
        n_p = int(counts.sum())
        if n_p == 0:
            continue
        li_local = np.repeat(np.arange(len(lkp)), counts)
        starts = np.repeat(lo, counts)
        base = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(n_p) - np.repeat(base, counts)
        ri_local = order[starts + within]
        li_g = li_rows[li_local]
        ri_g = ri_rows[ri_local]
        fn = os.path.join(sd.path, f"p{p}.npz")
        np.savez(fn, li=li_g, ri=ri_g)
        chunks.append((fn, n_p))
        total += n_p

    li_out = sd.memmap((max(total, 1),), np.int64)[:total]
    ri_out = sd.memmap((max(total, 1),), np.int64)[:total]
    off = 0
    for fn, n_p in chunks:
        z = np.load(fn)
        li_out[off:off + n_p] = z["li"]
        ri_out[off:off + n_p] = z["ri"]
        os.unlink(fn)
        off += n_p
    return li_out, ri_out


_CHUNK = 1 << 22  # rows per in-RAM processing chunk


def verify_pairs_chunked(lkeys, rkeys, li, ri):
    """Hash-collision verification over (possibly disk-backed) pair index
    arrays, processed in bounded chunks; returns compacted memmap pairs."""
    n = len(li)
    sd = _SpillDir()
    lo_out = sd.memmap((max(n, 1),), np.int64)
    ro_out = sd.memmap((max(n, 1),), np.int64)
    m = 0
    for off in range(0, n, _CHUNK):
        lic = np.asarray(li[off:off + _CHUNK])
        ric = np.asarray(ri[off:off + _CHUNK])
        ok = np.ones(len(lic), dtype=bool)
        for lcol, rcol in zip(lkeys, rkeys):
            lv, rv = lcol[lic], rcol[ric]
            if lv.dtype.kind == "f" or rv.dtype.kind == "f":
                ok &= lv.astype(np.float64) == rv.astype(np.float64)
            else:
                ok &= lv.astype(np.int64) == rv.astype(np.int64)
        k = int(ok.sum())
        lo_out[m:m + k] = lic[ok]
        ro_out[m:m + k] = ric[ok]
        m += k
    return lo_out[:m], ro_out[:m]


def gather(col: np.ndarray, idx: np.ndarray,
           valid: Optional[np.ndarray] = None):
    """col[idx] (and valid[idx]) computed chunk-wise into disk-backed
    outputs — the join/sort materialization step without the O(|idx|)
    in-RAM copy."""
    n = len(idx)
    sd = _SpillDir()
    out = sd.memmap((max(n, 1),), col.dtype)[:n]
    vout = None if valid is None else sd.memmap((max(n, 1),), np.bool_)[:n]
    for off in range(0, n, _CHUNK):
        ic = np.asarray(idx[off:off + _CHUNK])
        out[off:off + len(ic)] = col[ic]
        if valid is not None:
            vout[off:off + len(ic)] = valid[ic]
    return (out, vout) if valid is not None else out


def external_sort_indices(keys: List[np.ndarray],
                          n_partitions: int) -> np.ndarray:
    """External sample sort over normalized keys (np.lexsort convention:
    last array = primary). Returns the permutation as a disk-backed
    memmap; in-RAM peak is one bucket's keys + indices."""
    P = max(2, int(n_partitions))
    primary = keys[-1]
    n = len(primary)
    sd = _SpillDir()
    out = sd.memmap((max(n, 1),), np.int64)[:n]
    if n == 0:
        return out
    sample = primary[np.random.default_rng(0).integers(0, n, min(n, 65536))]
    bounds = np.quantile(np.sort(sample), np.linspace(0, 1, P + 1)[1:-1],
                         method="nearest")
    bounds = np.unique(bounds)
    bucket = np.searchsorted(bounds, primary, side="right")
    order = np.argsort(bucket, kind="stable")
    b_sorted = bucket[order]
    b_bounds = np.searchsorted(b_sorted, np.arange(len(bounds) + 2))
    off = 0
    for p in range(len(bounds) + 1):
        rows = order[b_bounds[p]:b_bounds[p + 1]]
        if len(rows) == 0:
            continue
        idx = np.lexsort(tuple(k[rows] for k in keys))
        out[off:off + len(rows)] = rows[idx]
        off += len(rows)
    return out
