"""The least bytes a query must read, frozen with its test.

Each column a query reads counts at its frame-of-reference width in each
block of 65,536 rows: the bits that max - min of the block needs (0 for a
constant block), the paper's succinct encoding. The count comes from the
generated values alone, never from what a kernel was passed, so it is the
same whatever route or kernel reads the data. A string column counts by
the codes of its values in the order they first appear."""

from __future__ import annotations

import numpy as np

BLOCK_ROWS = 1 << 16


def column_codes(values: np.ndarray) -> np.ndarray:
    """Integers that stand for the column's values: the values themselves,
    or for strings their codes in order of first appearance."""
    if values.dtype.kind == "O":
        values = values.astype(str)
    if values.dtype.kind in "US":
        if values.dtype.kind == "U" and values.dtype.itemsize == 4:
            values = values.view(np.uint32)  # one character each: sort as integers
        _, first, inverse = np.unique(values, return_index=True, return_inverse=True)
        rank = np.empty(len(first), dtype=np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(first))
        return rank[inverse]
    return values


def packed_bytes(values: np.ndarray, block_rows: int = BLOCK_ROWS) -> int:
    """Bytes of the column bit-packed per block at its FOR width."""
    v = column_codes(np.asarray(values)).astype(np.int64, copy=False)
    n = len(v)
    total_bits = 0
    full = n - n % block_rows
    if full:
        blocks = v[:full].reshape(-1, block_rows)
        span = (blocks.max(axis=1) - blocks.min(axis=1)).astype(np.uint64)
        widths = _bit_length(span)
        total_bits += int(((widths * block_rows + 7) // 8).sum()) * 8
    if n > full:
        tail = v[full:]
        w = int(tail.max() - tail.min()).bit_length()
        total_bits += ((w * (n - full) + 7) // 8) * 8
    return total_bits // 8


def _bit_length(x: np.ndarray) -> np.ndarray:
    out = np.zeros(x.shape, dtype=np.int64)
    x = x.copy()
    while np.any(x):
        nz = x > 0
        out += nz
        x >>= np.uint64(1)
    return out


def least_seconds(n_bytes: int, bytes_per_s: float) -> float:
    """The time a device reading `n_bytes` at `bytes_per_s` cannot beat."""
    return n_bytes / bytes_per_s
