"""Frame-of-reference bit-packing codec in the *vertical lane* layout.

Port of adacom_tpu/ops/bitpack.py. The bit layout is the JAX package's,
bit for bit, so words packed by either package decode in the other:
element i of a segment lives at row r = i // L, lane = i % L
(L = ceil(N/32) lanes), and word k of lane l holds bits [32k, 32k+32) of
the concatenated 32 codes of that lane — a dense (w, L) array of N*w bits.
Every row's word index and bit offset are static, so decode is 32 shift /
mask steps with no gathers.

Representation in torch: torch has almost no arithmetic for uint32 on the
CPU, so packed words are stored as ``int32`` bit-views (zero-copy
reinterpretable as uint32) and all codec arithmetic runs in ``int64`` with
explicit 32-bit masks. Codes come back as ``int64`` tensors holding values
in [0, 2^32).

Widths 1..32 are supported; 64-bit logical types are stored by the segment
layer as two 32-bit planes packed independently.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS = 32  # elements per packing group == bits per packed word

_M32 = 0xFFFFFFFF


def lanes_for(n: int) -> int:
    """Number of lanes (packing groups) for n elements."""
    return max(1, (n + ROWS - 1) // ROWS)


def width_for_span(span: int, padded_to_byte: bool = False) -> int:
    """Minimal bit width for codes in [0, span] (sdsl bits::hi(max)+1 parity,
    column_segment.cpp:385; byte padding per config
    succinct_padded_to_next_byte_enabled)."""
    if span < 0:
        raise ValueError("span must be >= 0")
    w = max(1, int(span).bit_length())
    if padded_to_byte:
        w = min(32, (w + 7) & ~7)
    return min(w, 32)


def _mask(width: int) -> int:
    return (1 << width) - 1


def _check_width(width: int) -> None:
    if not (1 <= width <= 32):
        raise ValueError(f"width must be in 1..32, got {width}")


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit-view (two's complement)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def words_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit-view words -> int64 tensor of their uint32 values."""
    return words.to(torch.int64) & _M32


def pad_codes(codes: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """Pad a flat int64 code array to ROWS*n_lanes and reshape to (ROWS, L)."""
    n = codes.shape[0]
    total = ROWS * n_lanes
    codes = codes.to(torch.int64)
    if n < total:
        codes = torch.nn.functional.pad(codes, (0, total - n))
    return codes.reshape(ROWS, n_lanes)


def pack(rows: torch.Tensor, *, width: int) -> torch.Tensor:
    """Pack (ROWS, L) int64 codes at `width` bits -> (width, L) int32 words.

    Vertical layout: word k of lane l holds bits [32k, 32k+32) of the
    concatenated 32 codes of that lane. The accumulator never holds more
    than 31 + 32 bits, so int64 carries it without reaching the sign bit.
    """
    _check_width(width)
    mask = _mask(width)
    words = []
    acc = torch.zeros_like(rows[0])
    shift = 0
    for r in range(ROWS):
        acc = acc | ((rows[r] & mask) << shift)
        shift += width
        if shift >= 32:
            words.append(acc & _M32)
            acc = acc >> 32
            shift -= 32
    assert shift == 0 and len(words) == width
    return to_i32(torch.stack(words))


def unpack(words: torch.Tensor, *, width: int) -> torch.Tensor:
    """Unpack (..., width, L) int32 words -> (..., ROWS, L) int64 codes.

    Leading dimensions (a stack of segments) are carried through."""
    _check_width(width)
    mask = _mask(width)
    w = words_u32(words)
    out = []
    for r in range(ROWS):
        p = r * width
        k, off = p >> 5, p & 31
        code = w[..., k, :] >> off
        if off + width > 32:
            code = code | (w[..., k + 1, :] << (32 - off))
        out.append(code & mask)
    return torch.stack(out, dim=-2)


def unpack_flat(words: torch.Tensor, count: int, *, width: int) -> torch.Tensor:
    """Unpack to a flat int64 array of `count` codes (drops lane padding)."""
    return unpack(words, width=width).reshape(-1)[:count]


def gather_codes(words: torch.Tensor, idx: torch.Tensor, *, width: int,
                 n_lanes: int) -> torch.Tensor:
    """Random-access decode: int64 codes at flat positions `idx` (any shape).

    Touches only the <=2 words containing each element's bits."""
    _check_width(width)
    idx = idx.to(torch.int64)
    r = idx // n_lanes
    lane = idx % n_lanes
    p = r * width
    k, off = p >> 5, p & 31
    w = words_u32(words)
    code = w[k, lane] >> off
    if width > 1:
        # straddle word (read only where needed; clamp the index)
        k1 = torch.clamp(k + 1, max=words.shape[0] - 1)
        straddle = (off + width) > 32
        ext = (w[k1, lane] << ((32 - off) & 31)) & _M32
        code = torch.where(straddle, code | ext, code)
    return code & _mask(width)


# ---------------------------------------------------------------------------
# NumPy golden reference (host-side; the single source of truth for the bit
# layout, identical to the JAX package's copy).
# ---------------------------------------------------------------------------


def pack_numpy(codes: np.ndarray, width: int) -> np.ndarray:
    """Reference encoder: identical layout, plain NumPy (uint64 staging)."""
    n = codes.shape[0]
    L = lanes_for(n)
    rows = np.zeros((ROWS, L), dtype=np.uint64)
    padded = np.zeros(ROWS * L, dtype=np.uint64)
    padded[:n] = codes.astype(np.uint64) & ((1 << width) - 1)
    rows[:] = padded.reshape(ROWS, L)
    words = np.zeros((width, L), dtype=np.uint32)
    acc = np.zeros(L, dtype=np.uint64)
    shift = 0
    k = 0
    for r in range(ROWS):
        acc |= rows[r] << np.uint64(shift)
        shift += width
        if shift >= 32:
            words[k] = (acc & 0xFFFFFFFF).astype(np.uint32)
            acc >>= np.uint64(32)
            shift -= 32
            k += 1
    assert shift == 0 and k == width
    return words


def unpack_numpy(words: np.ndarray, count: int, width: int) -> np.ndarray:
    L = words.shape[1]
    mask = np.uint64((1 << width) - 1)
    out = np.zeros((ROWS, L), dtype=np.uint64)
    for r in range(ROWS):
        p = r * width
        k, off = p >> 5, p & 31
        code = words[k].astype(np.uint64) >> np.uint64(off)
        if off + width > 32:
            code |= words[k + 1].astype(np.uint64) << np.uint64(32 - off)
        out[r] = code & mask
    return out.reshape(-1)[:count].astype(np.uint32)
