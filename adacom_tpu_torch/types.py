"""Logical SQL type system and its device representations.

Port of adacom_tpu/types.py without its import-time JAX configuration.
Parity target: the reference's LogicalType/PhysicalType
(src/common/types/*, SURVEY.md §2.2 "Type system / vectors"):

- integers are int32/uint32 in compute; 64-bit logical ints are int64
  (hot codecs split them into 32-bit planes)
- DECIMAL(p,s) is a scaled integer (int64), like DuckDB's physical decimals
- DATE/TIMESTAMP are days/micros since epoch (int32/int64)
- VARCHAR is dictionary-encoded at ingest: uint32 codes on device + a host
  dictionary (the reference dictionary codec made first-class)
- BOOLEAN is uint8 {0,1} host-side, uint32 in compute
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LogicalType:
    name: str
    # numpy dtype used for host staging & results
    np_dtype: np.dtype
    # True if integer-like and eligible for succinct packing
    # (reference TypeIsInteger gate, column_segment.cpp:45-82)
    integer: bool = False
    signed: bool = False
    # decimal scale (10**scale divisor); 0 for non-decimals
    scale: int = 0
    precision: int = 0
    is_string: bool = False
    is_float: bool = False

    @property
    def width_bytes(self) -> int:
        return self.np_dtype.itemsize

    def __str__(self) -> str:
        if self.name == "DECIMAL":
            return f"DECIMAL({self.precision},{self.scale})"
        return self.name


def _t(name, dtype, **kw) -> LogicalType:
    return LogicalType(name, np.dtype(dtype), **kw)


BOOLEAN = _t("BOOLEAN", np.uint8, integer=True)
TINYINT = _t("TINYINT", np.int8, integer=True, signed=True)
SMALLINT = _t("SMALLINT", np.int16, integer=True, signed=True)
INTEGER = _t("INTEGER", np.int32, integer=True, signed=True)
BIGINT = _t("BIGINT", np.int64, integer=True, signed=True)
UTINYINT = _t("UTINYINT", np.uint8, integer=True)
USMALLINT = _t("USMALLINT", np.uint16, integer=True)
UINTEGER = _t("UINTEGER", np.uint32, integer=True)
UBIGINT = _t("UBIGINT", np.uint64, integer=True)
FLOAT = _t("FLOAT", np.float32, is_float=True)
DOUBLE = _t("DOUBLE", np.float64, is_float=True)
DATE = _t("DATE", np.int32, integer=True, signed=True)
TIMESTAMP = _t("TIMESTAMP", np.int64, integer=True, signed=True)
VARCHAR = _t("VARCHAR", np.uint32, is_string=True)  # dict codes on device


def DECIMAL(precision: int, scale: int) -> LogicalType:
    return LogicalType(
        "DECIMAL", np.dtype(np.int64), integer=True, signed=True,
        scale=scale, precision=precision,
    )


_BY_NAME = {
    "BOOLEAN": BOOLEAN, "BOOL": BOOLEAN, "LOGICAL": BOOLEAN,
    "TINYINT": TINYINT, "INT1": TINYINT,
    "SMALLINT": SMALLINT, "INT2": SMALLINT, "SHORT": SMALLINT,
    "INTEGER": INTEGER, "INT": INTEGER, "INT4": INTEGER, "SIGNED": INTEGER,
    "BIGINT": BIGINT, "INT8": BIGINT, "LONG": BIGINT,
    "UTINYINT": UTINYINT, "USMALLINT": USMALLINT,
    "UINTEGER": UINTEGER, "UINT": UINTEGER,
    "UBIGINT": UBIGINT,
    "FLOAT": FLOAT, "REAL": FLOAT, "FLOAT4": FLOAT,
    "DOUBLE": DOUBLE, "FLOAT8": DOUBLE,
    "DATE": DATE, "TIMESTAMP": TIMESTAMP, "DATETIME": TIMESTAMP,
    "VARCHAR": VARCHAR, "TEXT": VARCHAR, "STRING": VARCHAR, "CHAR": VARCHAR,
    "BPCHAR": VARCHAR,
}


def type_from_name(name: str, args: Optional[list] = None) -> LogicalType:
    base = name.upper()
    if base in ("DECIMAL", "NUMERIC"):
        p, s = (args or [18, 3])
        return DECIMAL(int(p), int(s))
    if base in _BY_NAME:
        return _BY_NAME[base]
    raise ValueError(f"unknown type: {name}")


# --- integer range metadata for codec decisions -------------------------


def int_bounds(t: LogicalType) -> tuple[int, int]:
    if not t.integer:
        raise ValueError(f"{t} is not integer-typed")
    info = np.iinfo(t.np_dtype)
    return int(info.min), int(info.max)


def common_type(a: LogicalType, b: LogicalType) -> LogicalType:
    """Result type of a binary arithmetic op (simplified DuckDB promotion)."""
    if a.is_string or b.is_string:
        return VARCHAR
    if a.is_float or b.is_float:
        return DOUBLE if (a is DOUBLE or b is DOUBLE or a.name == "DECIMAL" or b.name == "DECIMAL") else FLOAT
    if a.name == "DECIMAL" or b.name == "DECIMAL":
        scale = max(a.scale, b.scale)
        return DECIMAL(38, scale)
    order = [BOOLEAN, TINYINT, UTINYINT, SMALLINT, USMALLINT, INTEGER,
             UINTEGER, BIGINT, UBIGINT, DATE, TIMESTAMP]
    ai = order.index(a) if a in order else len(order)
    bi = order.index(b) if b in order else len(order)
    t = a if ai >= bi else b
    # mixing signed/unsigned widens to signed 64-bit for safety
    if a.signed != b.signed:
        return BIGINT
    return t


# --- torch dtypes ----------------------------------------------------------

# numpy storage/compute dtype -> torch dtype of a device tensor holding it.
# torch implements little arithmetic for uint32/uint64 (none on the CPU), so
# codecs compute in int64 and keep packed words as int32 bit-views; these
# dtypes only type plain residency and decoded output.
TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(t: "LogicalType | np.dtype") -> torch.dtype:
    """torch dtype for a LogicalType (its storage dtype) or a numpy dtype."""
    dt = t.np_dtype if isinstance(t, LogicalType) else np.dtype(t)
    return TORCH_DTYPES[dt]
