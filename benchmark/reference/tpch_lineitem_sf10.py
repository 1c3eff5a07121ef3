"""Plain NumPy answers over the generated tables: TPC-H Q15's revenue view.

Independent of the program: it reads only the generated arrays (decimals as
integers at scale 2, dates as days since 1970-01-01). The sums are taken
once per run, by month and supplier, into bins small enough that every bin
sum is an integer below 2**53, so the float64 accumulation of np.bincount
is exact; totals are then Python integers, and each revenue is the exact
DECIMAL (Fraction) that SQL defines.

`precision="float32"` is the control: the same answers computed in
float32, the step below the configuration's exact arithmetic."""

from __future__ import annotations

from fractions import Fraction

import numpy as np

EXACT_LIMIT = float(1 << 53)


def _exact_bins(key, n, weights=None) -> np.ndarray:
    b = np.bincount(key, weights=weights, minlength=n)
    if weights is not None:
        if b.max(initial=0) >= EXACT_LIMIT or b.min(initial=0) < 0:
            raise ArithmeticError("a bin sum would leave float64's exact integers")
        b = b.astype(np.int64)
    return b


class Reference:
    def __init__(self, data: dict, precision: str = "exact"):
        if precision not in ("exact", "float32"):
            raise ValueError(precision)
        self.f32 = precision == "float32"
        li = data["lineitem"]
        self.ship = np.asarray(li["l_shipdate"], dtype=np.int64)
        self.li = li
        self._q15 = None

    def answer(self, name: str, params: dict) -> list:
        return getattr(self, name)(params)

    def _num(self, x, scale):
        """An exact decimal at `scale`, or its float32 in the control."""
        if self.f32:
            return float(np.float32(x) / np.float32(10 ** scale))
        return Fraction(int(x), 10 ** scale)

    def _prepare_q15(self):
        li = self.li
        supp = np.asarray(li["l_suppkey"], dtype=np.int64)
        self.n_supp_keys = int(supp.max()) + 1
        month = self.ship.astype("datetime64[D]").astype("datetime64[M]").astype(np.int64)
        self.m0 = int(month.min())
        nm = int(month.max()) - self.m0 + 1
        rev = np.asarray(li["l_extendedprice"], dtype=np.int64) * (100 - np.asarray(li["l_discount"], dtype=np.int64))
        self._q15 = _exact_bins((month - self.m0) * self.n_supp_keys + supp,
                                nm * self.n_supp_keys, rev).reshape(nm, self.n_supp_keys)
        self._q15_rows = _exact_bins((month - self.m0) * self.n_supp_keys + supp,
                                     nm * self.n_supp_keys).reshape(nm, self.n_supp_keys)

    def _quarter(self, params):
        """(revenue by supplier key, supplier has a row) over the months
        [date, date_end)."""
        if self._q15 is None:
            self._prepare_q15()
        lo, hi = np.datetime64(params["date"], "D"), np.datetime64(params["date_end"], "D")
        if lo.astype("datetime64[M]").astype("datetime64[D]") != lo or \
                hi.astype("datetime64[M]").astype("datetime64[D]") != hi:
            raise ValueError("Q15's bins take whole months")
        m_lo = int(lo.astype("datetime64[M]").astype(np.int64)) - self.m0
        m_hi = int(hi.astype("datetime64[M]").astype(np.int64)) - self.m0
        m_lo, m_hi = max(m_lo, 0), max(min(m_hi, self._q15.shape[0]), 0)
        present = self._q15_rows[m_lo:m_hi].sum(axis=0) > 0
        if self.f32:
            rev = self._q15[m_lo:m_hi].astype(np.float32).sum(axis=0, dtype=np.float32)
        else:
            rev = self._q15[m_lo:m_hi].sum(axis=0)
        return rev, present

    def tpch_revenue_top(self, params):
        """Q15's revenue view, its 10 suppliers of most revenue (ties by
        supplier key)."""
        rev, present = self._quarter(params)
        keys = np.flatnonzero(present)
        order = np.lexsort((keys, -rev[keys]))
        return [(int(k), self._num(rev[k], 4)) for k in keys[order[:10]].tolist()]
