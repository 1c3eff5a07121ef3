"""Adaptive filter: runtime-ordered conjunct evaluation for host scans.

Reference: AdaptiveFilter (src/execution/adaptive_filter.cpp:30, used by
RowGroup::TemplatedScan at row_group.cpp:396 and conjunction execution):
permute the evaluation order of filter conjuncts by measured runtime so
the most selective/cheapest predicate runs first and later predicates
only see surviving rows.

Here: each conjunct compiles separately; evaluation narrows the candidate
row set conjunct by conjunct (numpy fancy indexing). Per-conjunct EWMA
selectivity and per-row cost feed a rank = cost / max(1 - selectivity, eps)
— the classic ordering that minimizes expected total work — recomputed
every few batches. The device tier doesn't need this (a fused XLA kernel
evaluates all conjuncts in one vectorized pass); it's the latency-tier
analogue."""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from adacom_tpu_torch.exec.expr import ExprCompiler

_ALPHA = 0.3  # EWMA weight for fresh measurements
_REORDER_EVERY = 16


class AdaptiveFilter:
    def __init__(self, conjuncts):
        self.ccs = [ExprCompiler().compile(c) for c in conjuncts]
        n = len(self.ccs)
        self.sel = [0.5] * n        # EWMA fraction of rows passing
        self.cost = [1.0] * n       # EWMA ns per input row
        self.order = list(range(n))
        self._calls = 0

    def select(self, cols, lits) -> Optional[np.ndarray]:
        """Row indices passing all conjuncts, or None when any conjunct
        leaves numpy (caller falls back to the device path).

        cols: [(values_np, valid_np|None)] full segment columns."""
        n_rows = len(cols[0][0]) if cols else 0
        rows = None  # None == all rows
        for k in self.order:
            cc = self.ccs[k]
            sub = cols if rows is None else [
                (v[rows], None if m is None else m[rows]) for v, m in cols
            ]
            n_in = n_rows if rows is None else len(rows)
            if n_in == 0:
                break
            t0 = time.perf_counter_ns()
            try:
                fv, fm = cc.fn(sub, cc.prep_args(lits))
            except Exception:
                return None
            if not isinstance(fv, np.ndarray):
                return None
            mask = fv if fm is None else (fv & np.asarray(fm))
            if mask.ndim == 0:
                mask = np.full(n_in, bool(mask))
            dt = time.perf_counter_ns() - t0
            keep = np.nonzero(mask)[0]
            self.cost[k] = (1 - _ALPHA) * self.cost[k] + \
                _ALPHA * (dt / max(n_in, 1))
            self.sel[k] = (1 - _ALPHA) * self.sel[k] + \
                _ALPHA * (len(keep) / max(n_in, 1))
            rows = keep if rows is None else rows[keep]
        self._calls += 1
        if self._calls % _REORDER_EVERY == 0:
            self.order = sorted(
                range(len(self.ccs)),
                key=lambda k: self.cost[k] / max(1.0 - self.sel[k], 1e-3))
        return rows if rows is not None else np.arange(n_rows)
