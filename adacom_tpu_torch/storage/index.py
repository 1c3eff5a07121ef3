"""Per-column sorted index: the TPU build's ART analogue.

Parity target: the reference's Adaptive Radix Tree
(src/execution/index/art/, 2.8k LoC) serving (a) point/range lookups that
beat a full scan, (b) PRIMARY KEY / UNIQUE constraint enforcement on append,
(c) the optimizer's index-scan rewrite (table_scan.cpp:388), and
(d) composite keys + index joins (art.cpp:929 multi-column keys; the
executor's index-join path probes per outer row instead of scanning).

Composite indexes ("CREATE INDEX i ON t(a, b)") sort each segment by a
64-bit row hash of the key columns and answer EQUALITY probes (binary
search on the hash + verification); range lookups stay single-column,
matching how ART composite keys serve point probes.

A pointer-chasing radix tree is the wrong shape for this engine: lookups
here are answered host-side (the latency tier) or as batched device gathers,
and segments are immutable once sealed. So the index is a *per-segment
sorted permutation*: for each sealed segment of the indexed column, a
stable argsort of its values. Lookup = zonemap prune, then one
``np.searchsorted`` (binary search over contiguous memory — SIMD-friendly,
cache-linear) per surviving segment; appends never rewrite old entries
(only new segments get sorted), matching how ART inserts stay local.
Equality and range predicates map to (lo, hi) slices of the permutation.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


class ConstraintViolation(Exception):
    """PRIMARY KEY / UNIQUE violation (reference duplicate-key error)."""


def _hash_rows(cols) -> np.ndarray:
    """Order-insensitive 64-bit combined row hash (equality probes only)."""
    h = np.zeros(len(cols[0]), dtype=np.uint64)
    for c in cols:
        x = np.ascontiguousarray(c)
        if x.dtype.kind == "f":
            x = x.view(np.uint64 if x.dtype.itemsize == 8 else np.uint32)
        x = x.astype(np.uint64)
        h ^= (x + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6))
              + (h >> np.uint64(2)))
        h *= np.uint64(0xBF58476D1CE4E5B9)
    return h


class SortedIndex:
    def __init__(self, name: str, table, column: str, unique: bool = False):
        self.name = name
        self.table = table
        # "a" or "a,b,..." (comma-joined list survives WAL/checkpoint defs)
        self.column = column.lower()
        self.columns = [c.strip() for c in self.column.split(",")]
        self.composite = len(self.columns) > 1
        self.unique = unique
        self._lock = threading.Lock()
        # seg_idx -> (count, sorted_values, order) ; rebuilt if count changes
        self._segs: Dict[int, Tuple[int, np.ndarray, np.ndarray]] = {}

    # ------------------------------------------------------------------
    def _col(self):
        return self.table.columns[self.columns[0]]

    def _key_arrays(self, seg_idx: int):
        return [self.table.columns[c].segments[seg_idx]
                ._host_compute_values() for c in self.columns]

    def _entry(self, seg_idx: int):
        seg = self._col().segments[seg_idx]
        with self._lock:
            cached = self._segs.get(seg_idx)
            if cached is not None and cached[0] == seg.count:
                return cached[1], cached[2]
            if self.composite:
                vals = _hash_rows(self._key_arrays(seg_idx))
            else:
                vals = seg._host_compute_values()
            order = np.argsort(vals, kind="stable")
            entry = (seg.count, vals[order], order)
            self._segs[seg_idx] = entry
            return entry[1], entry[2]

    def _encode_probe(self, value) -> np.ndarray:
        """Composite probe tuple -> its 64-bit hash (scalar array)."""
        cols = []
        for c, v in zip(self.columns, value):
            dt = self.table.columns[c].ltype.np_dtype
            cols.append(np.asarray([v]).astype(dt))
        return _hash_rows(cols)

    def _verify_composite(self, seg_idx: int, rows: np.ndarray, value):
        keys = self._key_arrays(seg_idx)
        ok = np.ones(len(rows), dtype=bool)
        for arr, v in zip(keys, value):
            ok &= arr[rows] == np.asarray(v).astype(arr.dtype)
        return rows[ok]

    def build(self):
        """Index every sealed segment (CREATE INDEX on existing data)."""
        self.table.flush()
        for i in range(len(self._col().segments)):
            self._entry(i)
        if self.unique:
            self._verify_existing_unique()

    def _verify_existing_unique(self):
        seen = None
        for i in range(len(self._col().segments)):
            sv, _ = self._entry(i)
            if len(sv) > 1 and (sv[1:] == sv[:-1]).any():
                raise ConstraintViolation(
                    f"index {self.name}: duplicate key in column {self.column}")
            seen = sv if seen is None else np.concatenate([seen, sv])
        if seen is not None and len(seen) > 1:
            seen.sort(kind="stable")
            if (seen[1:] == seen[:-1]).any():
                raise ConstraintViolation(
                    f"index {self.name}: duplicate key in column {self.column}")

    # ------------------------------------------------------------------
    # lookups (reference ART point/range query; fixes FetchRow-style
    # whole-structure walks with one binary search per candidate segment)
    # ------------------------------------------------------------------
    def lookup_eq(self, value) -> List[Tuple[int, np.ndarray]]:
        """Row positions equal to `value` (a scalar, or a tuple matching
        the index columns for composite keys), as [(seg_idx, rows)]."""
        out = []
        col = self._col()
        if self.composite:
            probe = self._encode_probe(value)[0]
            for i in range(len(col.segments)):
                skip = False
                for c, v in zip(self.columns, value):
                    if not self.table.columns[c].segments[i] \
                            .zonemap_may_match("=", v):
                        skip = True
                        break
                if skip:
                    continue
                sv, order = self._entry(i)
                lo = np.searchsorted(sv, probe, side="left")
                hi = np.searchsorted(sv, probe, side="right")
                if hi > lo:
                    rows = self._verify_composite(
                        i, np.sort(order[lo:hi]), value)
                    if len(rows):
                        out.append((i, rows))
            return out
        if not col.segments:
            return out
        # normalize the probe to the key dtype BEFORE the binary searches:
        # a float/longdouble scalar makes numpy cast the ENTIRE sorted key
        # array per searchsorted call (observed 0.2 ms per probe on 64k
        # keys — 200x the log-n search itself)
        dt = col.segments[0]._host_compute_values().dtype
        if dt.kind in "iu":
            if isinstance(value, (float, np.floating)):
                if value != int(value):
                    return out  # fractional probe matches no integer key
                value = int(value)
            info = np.iinfo(dt)
            if not (info.min <= int(value) <= info.max):
                return out
            value = dt.type(value)
        for i, seg in enumerate(col.segments):
            if not seg.zonemap_may_match("=", value):
                continue
            sv, order = self._entry(i)
            lo = np.searchsorted(sv, value, side="left")
            hi = np.searchsorted(sv, value, side="right")
            if hi > lo:
                out.append((i, np.sort(order[lo:hi])))
        return out

    def lookup_eq_batch(self, values) -> List[Tuple[int, np.ndarray]]:
        """Index-join probe: row positions matching ANY of `values`
        (single-column: 1-D array; composite: list of per-column arrays).
        One vectorized searchsorted per segment."""
        out = []
        col = self._col()
        if self.composite:
            arrs = [np.asarray(v) for v in values]
            probes = _hash_rows([
                a.astype(self.table.columns[c].ltype.np_dtype)
                for c, a in zip(self.columns, arrs)])
        else:
            probes = np.asarray(values)
        uniq = np.unique(probes)
        for i in range(len(col.segments)):
            sv, order = self._entry(i)
            if not len(sv):
                continue
            lo = np.searchsorted(sv, uniq, side="left")
            hi = np.searchsorted(sv, uniq, side="right")
            counts = hi - lo
            total = int(counts.sum())
            if total == 0:
                continue
            starts = np.repeat(lo, counts)
            base = np.concatenate([[0], np.cumsum(counts)[:-1]])
            within = np.arange(total) - np.repeat(base, counts)
            rows = np.sort(order[starts + within])
            out.append((i, rows))
        return out

    def lookup_range(self, lo=None, hi=None, lo_incl=True, hi_incl=True
                     ) -> List[Tuple[int, np.ndarray]]:
        out = []
        col = self._col()
        for i, seg in enumerate(col.segments):
            if lo is not None and not seg.zonemap_may_match(
                    ">=" if lo_incl else ">", lo):
                continue
            if hi is not None and not seg.zonemap_may_match(
                    "<=" if hi_incl else "<", hi):
                continue
            sv, order = self._entry(i)
            a = 0 if lo is None else np.searchsorted(
                sv, lo, side="left" if lo_incl else "right")
            z = len(sv) if hi is None else np.searchsorted(
                sv, hi, side="right" if hi_incl else "left")
            if z > a:
                out.append((i, np.sort(order[a:z])))
        return out

    # ------------------------------------------------------------------
    # uniqueness on ingest (reference ART insert constraint checking)
    # ------------------------------------------------------------------
    def check_batch_unique(self, new_values: np.ndarray):
        if self.composite:
            return  # composite UNIQUE is not enforced (single-col parity)
        nv = np.asarray(new_values)
        if len(nv) > 1:
            s = np.sort(nv, kind="stable")
            if (s[1:] == s[:-1]).any():
                raise ConstraintViolation(
                    f"index {self.name}: duplicate key within append batch")
        col = self._col()
        if not col.segments or len(nv) == 0:
            return
        vmin, vmax = nv.min(), nv.max()
        for i, seg in enumerate(col.segments):
            if seg.count == 0 or vmax < seg.vmin or vmin > seg.vmax:
                continue
            sv, _ = self._entry(i)
            pos = np.searchsorted(sv, nv, side="left")
            hit = (pos < len(sv)) & (sv[np.minimum(pos, len(sv) - 1)] == nv)
            if hit.any():
                dup = nv[hit][0]
                raise ConstraintViolation(
                    f"index {self.name}: duplicate key {dup!r}")

    def invalidate(self):
        with self._lock:
            self._segs.clear()

    def to_def(self) -> dict:
        return {"name": self.name, "table": self.table.name,
                "column": self.column, "unique": self.unique}

    def __repr__(self):
        u = "UNIQUE " if self.unique else ""
        return f"<{u}SortedIndex {self.name} ON {self.table.name}({self.column})>"
