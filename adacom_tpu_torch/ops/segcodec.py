"""Segment-level succinct codec: frame-of-reference + vertical bit-packing.

Port of adacom_tpu/ops/segcodec.py (reference column_segment.cpp:273-520
BitCompressFromUncompressed / UncompressSuccinct): compute min/max over the
segment, subtract the minimum ("extract prefix"), pack codes at width
hi(max-min)+1 (optionally padded to the next byte), and decode by adding the
minimum back.

- the bit layout is the vertical lane layout of ops/bitpack.py, shared with
  the JAX package: packed words are byte-identical in both, so state moves
  between them with `packed_from_numpy` and `np.asarray` of the words;
- 64-bit logical types split into lo/hi 32-bit planes packed independently;
  a plane of width 0 is constant and stores nothing;
- arithmetic runs in int64 two's complement (uint64 values ride as their
  int64 bit patterns), and words are int32 bit-views, because torch has
  almost no unsigned arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.ops import bitpack

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class PackedData:
    """Packed representation of one segment's values (words on a device)."""

    # Per plane: int32 words tensor (width, L), or None when width == 0
    # (constant plane). Plane 0 = low 32 bits, plane 1 = high 32 bits.
    words: Tuple[Optional[torch.Tensor], ...]
    widths: Tuple[int, ...]
    # frame-of-reference minimum (python int, in the logical domain)
    min_factor: int
    count: int
    n_lanes: int
    dtype: np.dtype  # compute dtype of the packed values
    device: torch.device = torch.device("cpu")  # where the words live

    @property
    def nbytes(self) -> int:
        return sum(0 if w is None else w.numel() * 4 for w in self.words)

    @property
    def meta(self) -> tuple:
        """Representation key: everything a kernel specializes on."""
        return (self.widths, self.n_lanes, str(self.dtype))


def plan_widths(
    vmin: int,
    vmax: int,
    itemsize: int,
    *,
    extract_prefix: bool = True,
    padded_to_byte: bool = False,
) -> tuple[tuple[int, ...], int]:
    """Compute (plane widths, min_factor) from segment stats alone — the
    same decision pack_segment makes, usable without touching the data
    (e.g. to account the footprint of a paged-out compacted segment)."""
    min_factor = vmin if extract_prefix else (0 if vmin >= 0 else vmin)
    span = vmax - min_factor
    if itemsize == 8:
        lo_w = 32 if span >= (1 << 32) else (0 if span == 0 else bitpack.width_for_span(span, padded_to_byte))
        hi_span = span >> 32
        hi_w = 0 if hi_span == 0 else bitpack.width_for_span(hi_span, padded_to_byte)
        return (lo_w, hi_w), min_factor
    return ((0 if span == 0 else bitpack.width_for_span(span, padded_to_byte)),), min_factor


def packed_nbytes(widths: tuple, n_lanes: int) -> int:
    return sum(w * n_lanes * 4 for w in widths)


def _wrap64(v: int) -> int:
    """Python int -> its int64 two's-complement value (uint64 bit pattern)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _as_i64(values: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int64 (uint64 as its bit pattern, no copy)."""
    if values.dtype == torch.uint64:
        return values.view(torch.int64)
    return values.to(torch.int64)


def compute_span(values: torch.Tensor, ltype: tt.LogicalType) -> tuple[int, int]:
    """Return (min, max) as python ints (one host sync)."""
    v = _as_i64(values)
    if values.dtype == torch.uint64:
        # order uint64 bit patterns by flipping the sign bit
        v = v ^ (-(1 << 63))
        mn, mx = torch.aminmax(v)
        return int(mn) + (1 << 63), int(mx) + (1 << 63)
    mn, mx = torch.aminmax(v)
    return int(mn), int(mx)


def pack_segment(
    values: torch.Tensor,
    ltype: tt.LogicalType,
    *,
    extract_prefix: bool = True,
    padded_to_byte: bool = False,
    vmin: Optional[int] = None,
    vmax: Optional[int] = None,
) -> PackedData:
    """Encode a value tensor into PackedData on the tensor's device.

    values: integer tensor in the segment's compute dtype (i32/u32/i64/u64).
    vmin/vmax: pre-computed stats (zonemap) to avoid a second reduction.
    """
    count = values.shape[0]
    n_lanes = bitpack.lanes_for(count)
    if vmin is None or vmax is None:
        vmin, vmax = compute_span(values, ltype)
    itemsize = values.element_size()
    widths, min_factor = plan_widths(
        vmin, vmax, itemsize,
        extract_prefix=extract_prefix, padded_to_byte=padded_to_byte,
    )
    # codes = v - min_factor; int64 wraps exactly like the unsigned subtract
    codes = _as_i64(values) - _wrap64(min_factor)
    planes = [codes & _M32]
    if itemsize == 8:
        planes.append((codes >> 32) & _M32)
    words = tuple(
        None if w == 0 else bitpack.pack(bitpack.pad_codes(p, n_lanes), width=w)
        for p, w in zip(planes, widths))
    return PackedData(
        words=words,
        widths=tuple(widths),
        min_factor=min_factor,
        count=count,
        n_lanes=n_lanes,
        dtype=_np_dtype_of(values.dtype),
        device=values.device,
    )


def _np_dtype_of(dtype: torch.dtype) -> np.dtype:
    for k, v in tt.TORCH_DTYPES.items():
        if v == dtype:
            return k
    raise ValueError(f"no numpy dtype for {dtype}")


def _from_i64(v: torch.Tensor, compute_dtype) -> torch.Tensor:
    """int64 two's-complement values -> tensor of `compute_dtype`."""
    dt = tt.torch_dtype(np.dtype(compute_dtype))
    if dt == torch.uint64:
        return v.view(torch.uint64)
    if dt == torch.uint32:
        return (v & _M32).to(torch.uint32)
    return v.to(dt)


def _decode_codes(packed: PackedData, codes_of) -> torch.Tensor:
    """Assemble int64 values from per-plane codes (codes_of(plane) or None
    for a constant plane) plus the frame-of-reference minimum."""
    lo = codes_of(0)
    v = lo
    if len(packed.widths) == 2:
        hi = codes_of(1)
        if hi is not None:
            v = hi << 32 if v is None else v | (hi << 32)
    return v + _wrap64(packed.min_factor)


def unpack_segment(packed: PackedData, compute_dtype=None) -> torch.Tensor:
    """Standalone decode of a whole segment -> tensor of count values."""
    if compute_dtype is None:
        compute_dtype = packed.dtype
    if all(w == 0 for w in packed.widths):
        v = torch.full((packed.count,), _wrap64(packed.min_factor),
                       dtype=torch.int64, device=packed.device)
        return _from_i64(v, compute_dtype)

    def codes_of(i):
        w = packed.widths[i]
        if w == 0:
            return None
        return bitpack.unpack_flat(packed.words[i], packed.count, width=w)

    v = _decode_codes(packed, codes_of)
    return _from_i64(v, compute_dtype)


def gather_segment(packed: PackedData, idx: torch.Tensor) -> torch.Tensor:
    """Random-access decode of rows `idx` (FetchRow parity, touches only the
    words containing those rows)."""
    idx = idx.to(torch.int64)
    if all(w == 0 for w in packed.widths):
        v = torch.full(idx.shape, _wrap64(packed.min_factor),
                       dtype=torch.int64, device=idx.device)
        return _from_i64(v, packed.dtype)

    def codes_of(i):
        w = packed.widths[i]
        if w == 0:
            return None
        return bitpack.gather_codes(packed.words[i], idx, width=w,
                                    n_lanes=packed.n_lanes)

    return _from_i64(_decode_codes(packed, codes_of), packed.dtype)


def packed_from_numpy(words: Sequence[Optional[np.ndarray]], widths, min_factor: int,
                      count: int, n_lanes: int, dtype,
                      device: torch.device) -> PackedData:
    """Build the port's PackedData from host words: a (width, L) uint32
    array (or None for a constant plane) per plane, e.g. ``np.asarray`` of
    the JAX package's PackedData words. The bit layout is shared, so the
    words move as they are."""
    out = []
    for w, width in zip(words, widths):
        if width == 0:
            out.append(None)
            continue
        a = np.ascontiguousarray(w, dtype=np.uint32)
        if a.shape != (width, n_lanes):
            raise ValueError(f"plane shape {a.shape} != {(width, n_lanes)}")
        out.append(torch.from_numpy(a.view(np.int32).copy()).to(device))
    return PackedData(words=tuple(out), widths=tuple(widths),
                      min_factor=int(min_factor), count=int(count),
                      n_lanes=int(n_lanes), dtype=np.dtype(dtype),
                      device=torch.device(device))
