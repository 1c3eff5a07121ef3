"""The executor's materialized batch (Mat) and its errors.

Split out of exec/executor.py (the JAX package keeps them there, at
adacom_tpu/exec/executor.py:38 and :119-124) so that the executor's mixins
(exec/device_scan.py, exec/join.py) import them without a cycle;
exec/executor.py re-exports all three.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.sql import bound as b
from adacom_tpu_torch.exec.expr import compute_dtype_of


@dataclasses.dataclass
class Mat:
    names: List[str]
    types: List[tt.LogicalType]
    dicts: List[Any]
    cols: List[np.ndarray]
    valids: List[Optional[np.ndarray]]

    @property
    def nrows(self) -> int:
        return len(self.cols[0]) if self.cols else self._nrows

    # the row count of a batch without columns: a FROM-less SELECT is one
    # row (the JAX package counts it as 0 rows)
    _nrows: int = 0

    @classmethod
    def empty_like(cls, node: b.LogicalOp) -> "Mat":
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return cls(
            list(node.names), list(node.types), list(dicts),
            [np.empty(0, compute_dtype_of(t)) for t in node.types],
            [None] * len(node.names),
        )

    def take(self, idx: np.ndarray) -> "Mat":
        return Mat(
            self.names, self.types, self.dicts,
            [c[idx] for c in self.cols],
            [None if v is None else v[idx] for v in self.valids],
            len(idx),
        )


class ExecError(Exception):
    pass


class _FallbackToDevice(ExecError):
    """Internal: a host morsel hit a non-numpy path; rerun on the device.
    Uncaught (a scan the device path declines), it is an ExecError."""


def client_module(name: str):
    """Import adacom_tpu_torch.<name>, a client module of the JAX package
    (relation, verification, io); an ExecError names it while it is not
    ported (ROADMAP queue A item 4)."""
    import importlib

    full = f"adacom_tpu_torch.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full and not full.startswith(f"{e.name}."):
            raise
        raise ExecError(f"not yet ported: {full} (ROADMAP queue A item 4)"
                        ) from None
