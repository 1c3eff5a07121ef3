"""Values into a column's logical type: the assignments of UPDATE, the
fields of COPY FROM and the values of INSERT ... VALUES.

The JAX package casts an UPDATE's new values with the column's storage
dtype (a VARCHAR column's dtype holds dictionary codes, so a string raised
there) and appends COPY's fields as its CSV sniffer typed them (a DECIMAL
column got the DOUBLE value unscaled). Here each value takes the column's
logical type:

- DECIMAL(p, s): exact decimal text becomes the scaled integer with no
  detour through DOUBLE ('0.29' gives 29 at scale 2, '-1.5' gives -150);
  a DECIMAL of another scale is rescaled; digits past the scale round half
  away from zero; a DOUBLE goes through its shortest text (repr); an
  integer is multiplied out. A magnitude of 10**p or more raises.
- integers: a value outside the column type's range raises; DECIMAL and
  DOUBLE round half away from zero.
- DATE / TIMESTAMP: ISO text, or the other of the two.
- VARCHAR: strings (a dictionary-coded expression is decoded; a number
  becomes its text), encoded by the table into the column's dictionary.

A bad value raises ValueError, before anything is written.
"""

from __future__ import annotations

import datetime
from decimal import ROUND_HALF_UP, Decimal, InvalidOperation
from typing import Optional, Sequence

import numpy as np

from adacom_tpu_torch import types as tt


def _is_temporal(ty: tt.LogicalType) -> bool:
    return ty is tt.DATE or ty is tt.TIMESTAMP


def _half_away(x: np.ndarray) -> np.ndarray:
    """Round floats to integers, halves away from zero."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def _round_div(x: np.ndarray, q: int) -> np.ndarray:
    """int64 x / q rounded to an integer, halves away from zero."""
    return np.sign(x) * ((np.abs(x) + q // 2) // q)


def _magnitude(x: np.ndarray) -> int:
    """The largest |x| as a Python int (0 when empty)."""
    if not len(x):
        return 0
    return max(abs(int(x.min())), abs(int(x.max())))


def decimal_from_text(cells: Sequence[str], scale: int,
                      precision: int = 18) -> np.ndarray:
    """Exact decimal text -> int64 scaled by 10**scale, digits past the
    scale rounded half away from zero; a magnitude of 10**precision or
    more raises."""
    limit = 10 ** min(precision, 18)
    out = np.zeros(len(cells), np.int64)
    for i, text in enumerate(cells):
        try:
            d = Decimal(text.strip())
        except InvalidOperation:
            raise ValueError(f"invalid DECIMAL value {text!r}") from None
        if not d.is_finite():
            raise ValueError(f"invalid DECIMAL value {text!r}")
        # the check before quantize keeps its digits in the context's 28
        v = 0 if not d else limit if d.adjusted() + scale >= 18 else \
            int(d.scaleb(scale).quantize(Decimal(1), rounding=ROUND_HALF_UP))
        if abs(v) >= limit:
            raise ValueError(f"DECIMAL({precision},{scale}) value {text!r} "
                             f"out of range")
        out[i] = v
    return out


def _check_int_range(vals, ty: tt.LogicalType, shown) -> np.ndarray:
    info = np.iinfo(ty.np_dtype)
    lo, hi = int(np.min(vals)), int(np.max(vals))
    if lo < info.min or hi > info.max:
        bad = lo if lo < info.min else hi
        raise ValueError(f"{shown(bad)} out of range for {ty}")
    return np.asarray(vals).astype(ty.np_dtype)


def _ints_from_text(cells: Sequence[str], ty: tt.LogicalType) -> np.ndarray:
    if not len(cells):
        return np.zeros(0, ty.np_dtype)
    try:
        ints = np.asarray(cells, dtype=np.int64) if ty is not tt.UBIGINT \
            else None
    except OverflowError:
        ints = None
    except ValueError as e:
        raise ValueError(f"invalid {ty} value: {e}") from None
    if ints is None:  # past int64: compare as Python ints
        try:
            ints = np.asarray([int(c) for c in cells], dtype=object)
        except ValueError as e:
            raise ValueError(f"invalid {ty} value: {e}") from None
    return _check_int_range(ints, ty, repr)


def _bools_from_text(cells: Sequence[str]) -> np.ndarray:
    words = {"true": 1, "t": 1, "1": 1, "false": 0, "f": 0, "0": 0}
    try:
        return np.asarray([words[c.strip().lower()] for c in cells], np.uint8)
    except KeyError as e:
        raise ValueError(f"invalid BOOLEAN value {e.args[0]!r}") from None


def _timestamp_micros(text: str) -> int:
    # the binder's TIMESTAMP literal (sql/binder.py _bind_literal)
    dt = datetime.datetime.fromisoformat(text.strip())
    return int(dt.timestamp() * 1e6)


def _days_from_text(cells: Sequence[str]) -> np.ndarray:
    """ISO dates (YYYY-MM-DD) -> days since the epoch."""
    from adacom_tpu_torch.sql.binder import days_from_iso

    try:
        return np.asarray([days_from_iso(c) for c in cells], np.int32)
    except ValueError as e:
        raise ValueError(f"invalid DATE value: {e}") from None


def from_text(cells: Sequence[str], ty: tt.LogicalType):
    """Text fields (no NULLs among them) -> values of `ty` in its storage
    dtype; a list of str for VARCHAR."""
    if ty.is_string:
        return list(cells)
    if ty.name == "DECIMAL":
        return decimal_from_text(cells, ty.scale, ty.precision)
    if ty is tt.DATE:
        return _days_from_text(cells)
    if ty is tt.TIMESTAMP:
        return np.asarray([_timestamp_micros(c) for c in cells], np.int64)
    if ty is tt.BOOLEAN:
        return _bools_from_text(cells)
    if ty.is_float:
        try:
            return np.asarray(cells, dtype=str).astype(np.float64) \
                .astype(ty.np_dtype)
        except ValueError as e:
            raise ValueError(f"invalid {ty} value: {e}") from None
    return _ints_from_text(cells, ty)


def from_values(vals: Sequence, dst: tt.LogicalType) -> np.ndarray:
    """Python values of constant expressions (INSERT ... VALUES) as values
    of a non-string type `dst`; None is NULL and holds the type's zero.
    Text takes from_text's rule, and so does a numeric literal written with
    a fraction (sql/lexer.py NumText) into DECIMAL, which keeps all of its
    digits; other numbers take cast's, as BIGINT or DOUBLE values. An
    integer into DATE or TIMESTAMP is its stored value (days, micros)."""
    out = np.zeros(len(vals), dst.np_dtype)
    texts, ints, floats = [], [], []
    for i, v in enumerate(vals):
        if v is None:
            continue
        if isinstance(v, str):
            texts.append((i, v))
        elif dst.name == "DECIMAL" and getattr(v, "text", None):
            texts.append((i, v.text))
        elif isinstance(v, (bool, int, np.integer)):
            ints.append((i, int(v)))
        else:
            floats.append((i, float(v)))
    if texts:
        idx, cells = zip(*texts)
        out[list(idx)] = from_text(list(cells), dst)
    if ints:
        idx, xs = zip(*ints)
        xs = np.asarray(xs, dtype=object)
        out[list(idx)] = _check_int_range(xs, dst, repr) \
            if _is_temporal(dst) else cast(xs, None, tt.BIGINT, dst, len(xs))
    if floats:
        idx, xs = zip(*floats)
        out[list(idx)] = cast(np.asarray(xs, np.float64), None, tt.DOUBLE,
                              dst, len(xs))
    return out


def _text_of(vals: np.ndarray, src: tt.LogicalType):
    """Values of a non-string type as SQL text."""
    from adacom_tpu_torch.sql.binder import iso_from_days

    if src.name == "DECIMAL":
        return [str(Decimal(int(v)).scaleb(-src.scale)) for v in vals]
    if src is tt.DATE:
        return [iso_from_days(int(v)) for v in vals]
    if src.is_float:
        return [repr(float(v)) for v in vals]
    return [str(int(v)) for v in vals]


def _strings(v, ok, src, dictionary, dst_dictionary, scalar):
    """cast() into VARCHAR: codes of `dst_dictionary` where given (each
    distinct string encoded once), else an object array of str; NULL rows
    hold ""."""
    if dictionary is not None and dictionary is dst_dictionary:
        return v.astype(tt.VARCHAR.np_dtype)
    if dst_dictionary is not None and (scalar or dictionary is not None):
        # a constant, or codes of another dictionary: encode the distinct
        # strings and map
        if scalar:
            codes = np.zeros(len(v), np.int64)
            strs = [str(v[0])] if len(v) else []
        else:
            codes = np.where(ok, v, 0).astype(np.int64)
            uniq, codes = np.unique(codes, return_inverse=True)
            strs = dictionary.decode(uniq)
        lut = np.asarray([dst_dictionary.encode_one(x) for x in strs] or [0],
                         dtype=np.uint32)
        out = lut[codes]
        if not ok.all():
            out[~ok] = dst_dictionary.encode_one("")
        return out
    if dictionary is not None:
        strs = dictionary.decode(np.where(ok, v, 0).astype(np.int64))
    elif v.dtype.kind in "OUS" or src.is_string:
        strs = [str(x) for x in v]
    else:
        strs = _text_of(v, src)
    return np.asarray([s if k else "" for s, k in zip(strs, ok)],
                      dtype=object)


def cast(values, valid: Optional[np.ndarray], src: tt.LogicalType,
         dst: tt.LogicalType, n: int, dictionary=None, dst_dictionary=None):
    """An expression's evaluated values (`values`, scalar or array, in the
    compute dtype of `src`; dictionary codes when `dictionary` is given)
    as values of `dst`: its storage dtype; for VARCHAR, codes of
    `dst_dictionary` (the column's dictionary, into which new strings are
    encoded) or, without one, an object array of str. Rows where `valid`
    is False are NULL: their values are not checked."""
    v = np.asarray(values)
    scalar = v.ndim == 0
    if scalar:
        v = np.full(n, v.item() if v.dtype.kind != "U" else str(v),
                    dtype=object if v.dtype.kind in "OU" else v.dtype)
    ok = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    if ok.ndim == 0:
        ok = np.full(n, bool(ok))
    texty = v.dtype.kind in "OUS"
    if dst.is_string:
        return _strings(v, ok, src, dictionary, dst_dictionary, scalar)
    if texty:
        if dictionary is not None:
            v = np.asarray(dictionary.decode(v.astype(np.int64)), object)
        cells = [str(x) if k else "0" for x, k in zip(v, ok)]
        if _is_temporal(dst) and not ok.all():
            cells = [c if k else "1970-01-01" for c, k in zip(cells, ok)]
        return from_text(cells, dst)
    if dictionary is not None or src.is_string:
        raise ValueError(f"cannot cast {src} to {dst}")
    if dst.name == "DECIMAL":
        if src.is_float:
            f = np.where(ok, v.astype(np.float64), 0.0)
            if not np.isfinite(f).all():
                raise ValueError(f"cannot cast a non-finite value to {dst}")
            return decimal_from_text([repr(x) for x in f.tolist()],
                                     dst.scale, dst.precision)
        if _is_temporal(src):
            raise ValueError(f"cannot cast {src} to {dst}")
        s = src.scale if src.name == "DECIMAL" else 0
        limit = 10 ** min(dst.precision, 18)
        iv = np.where(ok, v, 0)
        if dst.scale >= s:
            # |iv| below ceil(limit / mult) keeps |iv| * mult below limit
            mult = 10 ** (dst.scale - s)
            if _magnitude(iv) >= -(-limit // mult):
                raise ValueError(f"value out of range for {dst}")
            return iv.astype(np.int64) * mult
        out = _round_div(iv.astype(np.int64), 10 ** (s - dst.scale))
        if _magnitude(out) >= limit:
            raise ValueError(f"value out of range for {dst}")
        return out
    if dst.is_float:
        f = v.astype(np.float64)
        if src.name == "DECIMAL":
            f = f / 10.0 ** src.scale
        return f.astype(dst.np_dtype)
    if dst is tt.DATE or dst is tt.TIMESTAMP:
        day_us = 86_400_000_000
        if src is dst:
            return np.where(ok, v, 0).astype(dst.np_dtype)
        if src is tt.DATE:
            return np.where(ok, v, 0).astype(np.int64) * day_us
        if src is tt.TIMESTAMP:
            return (np.where(ok, v, 0).astype(np.int64) // day_us) \
                .astype(np.int32)
        raise ValueError(f"cannot cast {src} to {dst}")
    # integer columns (BOOLEAN among them)
    if _is_temporal(src):
        raise ValueError(f"cannot cast {src} to {dst}")
    if src.name == "DECIMAL":
        v = _round_div(np.where(ok, v, 0).astype(np.int64), 10 ** src.scale)
    v = np.where(ok, v, 0)
    if not len(v):
        return v.astype(dst.np_dtype)
    if v.dtype.kind == "f":
        if not np.isfinite(v).all():
            raise ValueError(f"cannot cast a non-finite value to {dst}")
        v = _half_away(v)
        info = np.iinfo(dst.np_dtype)
        # info.max + 1.0 is a power of two, exact in float64
        if v.min() < info.min or v.max() >= info.max + 1.0:
            bad = v.min() if v.min() < info.min else v.max()
            raise ValueError(f"{float(bad)!r} out of range for {dst}")
        return v.astype(dst.np_dtype)
    return _check_int_range(v.astype(np.int64) if v.dtype.kind == "b"
                            else v, dst, repr)
