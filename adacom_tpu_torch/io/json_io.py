"""JSON reader (reference extension/json read_json/read_ndjson; port of
adacom_tpu/io/json_io.py): newline-delimited JSON objects or one
top-level array of objects.

Columns are the union of keys in document order; types follow the CSV
sniffer lattice (BIGINT -> DOUBLE -> DATE -> VARCHAR, booleans kept).
Missing keys and JSON nulls become SQL NULL."""

from __future__ import annotations

import json
import os
import re
from typing import List

import numpy as np

from adacom_tpu_torch import types as tt

_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")


def _load_records(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    text_s = text.lstrip()
    if text_s.startswith("["):
        recs = json.loads(text_s)
        if not isinstance(recs, list):
            raise ValueError("top-level JSON must be an array of objects")
    else:
        recs = [json.loads(line) for line in text.splitlines() if line.strip()]
    for r in recs:
        if not isinstance(r, dict):
            raise ValueError("every JSON record must be an object")
    return recs


def read_json(path: str):
    """Read JSON records -> (names, types, cols, valids)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    recs = _load_records(path)
    names: List[str] = []
    for r in recs:
        for k in r:
            if k not in names:
                names.append(k)
    types, cols, valids = [], [], []
    from adacom_tpu_torch.sql.binder import days_from_iso

    for k in names:
        cells = [r.get(k) for r in recs]
        present = np.asarray([c is not None for c in cells], dtype=bool)
        valid = None if present.all() else present
        non_null = [c for c in cells if c is not None]
        if non_null and all(isinstance(c, bool) for c in non_null):
            ty = tt.BOOLEAN
            arr = np.asarray([bool(c) for c in cells], dtype=np.bool_)
        elif non_null and all(isinstance(c, (int, bool)) for c in non_null):
            ty = tt.BIGINT
            arr = np.asarray([int(c) if c is not None else 0 for c in cells],
                             dtype=np.int64)
        elif non_null and all(isinstance(c, (int, float, bool))
                              for c in non_null):
            ty = tt.DOUBLE
            arr = np.asarray([float(c) if c is not None else 0.0
                              for c in cells], dtype=np.float64)
        elif non_null and all(isinstance(c, str) and _DATE_RE.match(c)
                              for c in non_null):
            ty = tt.DATE
            arr = np.asarray([days_from_iso(c) if c is not None else 0
                              for c in cells], dtype=np.int32)
        else:
            ty = tt.VARCHAR
            arr = ["" if c is None else
                   (c if isinstance(c, str) else json.dumps(c))
                   for c in cells]
        types.append(ty)
        cols.append(arr)
        valids.append(valid)
    return names, types, cols, valids
