"""Plain NumPy answers over the generated tables: TPC-H Q15 (2.4.15), the
supplier or suppliers of most revenue in a quarter.

Builds on the reference beside it, `tpch_lineitem_sf10`: its exact binned
sums by month and supplier give each supplier's revenue over the quarter
as an exact integer at scale 4. Independent of the program: it reads only
the generated arrays. `precision="float32"` is the control, as there."""

from __future__ import annotations

import numpy as np

from . import tpch_lineitem_sf10


class Reference(tpch_lineitem_sf10.Reference):
    def __init__(self, data: dict, precision: str = "exact"):
        super().__init__(data, precision)
        supplier = data["supplier"]
        self.s_suppkey = np.asarray(supplier["s_suppkey"], dtype=np.int64)
        self.s_rows = [supplier[c] for c in ("s_name", "s_address", "s_phone")]
        self.s_order = np.argsort(self.s_suppkey, kind="stable")

    def tpch_q15(self, params):
        """Every supplier whose revenue over the quarter equals the
        largest (all of them on a tie), with its name, address and phone,
        by supplier key."""
        rev, present = self._quarter(params)
        keys = np.flatnonzero(present)
        if not len(keys):
            return []
        vals = rev[keys]
        top = keys[vals == vals.max()]
        pos = np.searchsorted(self.s_suppkey, top, sorter=self.s_order)
        out = []
        for k, p in zip(top.tolist(), pos.tolist()):
            if p == len(self.s_order) or self.s_suppkey[self.s_order[p]] != k:
                continue  # no supplier row: the join drops it
            row = self.s_order[p]
            out.append((k, *(str(col[row]) for col in self.s_rows), self._num(rev[k], 4)))
        return out
