"""Compression framework: codec registry + analyze-based selection.

Port of adacom_tpu/ops/codecs.py. Parity with the reference's
CompressionFunction registry (src/include/duckdb/function/
compression_function.hpp:74-160) and the checkpoint-time best-codec
selection (ColumnDataCheckpointer::DetectBestCompressionMethod,
src/storage/checkpoint/column_data_checkpointer.cpp:86):

- ``succinct``     — FOR + vertical bit-packing (ops/segcodec.py);
- ``constant``     — an all-equal segment stores one scalar
                     (numeric_constant.cpp);
- ``rle``          — run values + run end positions; decode is a
                     searchsorted + gather over the whole segment (rle.cpp);
- ``delta``        — zig-zag deltas in element order, FOR bit-packed,
                     decoded with a prefix sum (bitpacking.cpp DELTA_FOR);
- ``dictionary``   — distinct-value LUT + bit-packed codes for
                     low-cardinality integer segments
                     (dictionary_compression.cpp);
- ``alp``          — floats that round-trip through
                     ``round(v * 10^e) / 10^e`` stored as FOR bit-packed
                     integers (the ALP scheme, for the reference's chimp
                     and patas float codecs);
- ``uncompressed`` — the plain tensor (fixed_size_uncompressed.cpp).

Encoders and ``analyze`` run on the host in numpy and give the JAX
package's ``meta``, packed words (byte for byte) and ``nbytes``, so a
segment encoded by one package decodes in the other. The encoded arrays
then live on the segment's device.

Decoders and ``gather`` are torch on that device. A decoder takes its
arguments with a leading segment axis (a pool of n segments of one meta,
each argument stacked) and returns (n, n_pad) values, lane padding
included, in the device dtype of the compute dtype
(``types.device_dtype``: unsigned integers widen to int64). ALP divides by
the scale as a device tensor, a true IEEE f64 division on the CPU and on
the card alike, so its decode is exact everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.ops import bitpack, segcodec

ROWS = bitpack.ROWS
_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class Encoded:
    """Device-resident encoded segment (generic codecs)."""

    codec: str
    meta: tuple  # hashable representation key; meta[0] == codec name
    arrays: Tuple[torch.Tensor, ...]  # one segment's decoder arguments
    count: int
    nbytes: int  # logical packed footprint in bytes


def _pow2_at_least(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def _n_pad(count: int) -> int:
    return ROWS * bitpack.lanes_for(count)


def _uint_view(values: np.ndarray) -> np.ndarray:
    """Reinterpret signed ints as unsigned of the same width (wrap-around
    delta arithmetic stays exact mod 2^w)."""
    if values.dtype.kind == "i":
        return values.view(np.dtype(f"u{values.dtype.itemsize}"))
    return values


def _to_device(a, device) -> torch.Tensor:
    """Host values -> a tensor of their device dtype on `device`."""
    a = np.asarray(a)
    if a.dtype.kind == "u":
        a = a.view(np.int64) if a.dtype.itemsize == 8 else a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _words(words_u32: np.ndarray, device) -> torch.Tensor:
    """(width, L) uint32 packed words -> their int32 bit-view on `device`."""
    return torch.from_numpy(words_u32.view(np.int32).copy()).to(device)


# ======================================================================
# codec implementations
# ======================================================================


class ConstantCodec:
    """All-equal segment -> one scalar (numeric_constant.cpp parity)."""

    name = "constant"

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        if values.size == 0:
            return None
        if values.dtype.kind == "f":
            same = np.all(values.view(f"u{values.dtype.itemsize}") ==
                          values.view(f"u{values.dtype.itemsize}")[0])
        else:
            same = np.all(values == values[0])
        return int(values.dtype.itemsize) if same else None

    def encode(self, values: np.ndarray, ltype, cfg, device="cpu") -> Encoded:
        n = values.shape[0]
        meta = (self.name, _n_pad(n), str(values.dtype))
        return Encoded(self.name, meta, (_to_device(values[0], device),), n,
                       int(values.dtype.itemsize))

    def arg_count(self, meta) -> int:
        return 1

    def make_decoder(self, meta, compute_dtype):
        _, n_pad, _ = meta
        dt = tt.device_dtype(compute_dtype)

        def decode(args):
            v = args[0].to(dt)
            return v.reshape(-1, 1).expand(v.shape[0], n_pad)

        return decode

    def gather(self, enc: Encoded, idx: torch.Tensor) -> torch.Tensor:
        return enc.arrays[0].expand(idx.shape)


class RleCodec:
    """Run-length runs + end positions; decode = searchsorted + gather.

    The reference's rle.cpp scans runs with a serial cursor; here decode is
    one ``searchsorted(run_ends, positions)`` over the whole segment. The
    run count is padded to a power of two (the JAX package's meta)."""

    name = "rle"

    def _runs(self, values: np.ndarray):
        v = _uint_view(values) if values.dtype.kind in "iu" else values.view(
            f"u{values.dtype.itemsize}")
        change = np.empty(v.shape[0], dtype=bool)
        change[0] = True
        np.not_equal(v[1:], v[:-1], out=change[1:])
        return np.flatnonzero(change)

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        if values.size == 0:
            return None
        starts = self._runs(values)
        r = _pow2_at_least(len(starts))
        if r >= values.size // 2:  # not run-friendly
            return None
        return r * (values.dtype.itemsize + 4)

    def encode(self, values: np.ndarray, ltype, cfg, device="cpu") -> Encoded:
        n = values.shape[0]
        starts = self._runs(values)
        run_values = values[starts]
        run_ends = np.empty(len(starts), dtype=np.int32)
        run_ends[:-1] = starts[1:]
        run_ends[-1] = n
        r_pad = _pow2_at_least(len(starts))
        rv = np.concatenate([run_values,
                             np.full(r_pad - len(starts), run_values[-1],
                                     dtype=values.dtype)])
        re_ = np.concatenate([run_ends,
                              np.full(r_pad - len(starts), np.int32(n),
                                      dtype=np.int32)])
        nbytes = r_pad * (values.dtype.itemsize + 4)
        meta = (self.name, r_pad, _n_pad(n), str(values.dtype))
        return Encoded(self.name, meta,
                       (_to_device(rv, device), _to_device(re_, device)), n,
                       nbytes)

    def arg_count(self, meta) -> int:
        return 2

    def make_decoder(self, meta, compute_dtype):
        _, r_pad, n_pad, _ = meta
        dt = tt.device_dtype(compute_dtype)

        def decode(args):
            rv, re_ = args  # (n, r_pad) each
            pos = torch.arange(n_pad, dtype=re_.dtype, device=re_.device)
            pos = pos.expand(re_.shape[0], n_pad).contiguous()
            run = torch.searchsorted(re_, pos, right=True)
            run = torch.clamp(run, max=r_pad - 1)
            return torch.gather(rv, 1, run).to(dt)

        return decode

    def gather(self, enc: Encoded, idx: torch.Tensor) -> torch.Tensor:
        rv, re_ = enc.arrays
        run = torch.searchsorted(re_, idx.to(re_.dtype), right=True)
        return rv[torch.clamp(run, max=rv.shape[0] - 1)]


class DeltaCodec:
    """Zig-zag delta + FOR bit-pack; decode is a prefix sum.

    Element order is the flat (ROWS, L) row-major order of ops/bitpack.py,
    so the decode is one cumsum over each segment's flattened codes, in
    int64: exact mod 2^64 for 64-bit values, masked to 32 bits for 32-bit
    ones. Applies when the zig-zag delta span packs into <= 32 bits
    (sequential keys pack to 1-2 bits)."""

    name = "delta"

    def _codes(self, values: np.ndarray):
        u = _uint_view(values)
        w = u.dtype.itemsize * 8
        d = np.empty_like(u)
        d[0] = 0
        d[1:] = u[1:] - u[:-1]  # wrap-around exact mod 2^w
        s = d.view(f"i{u.dtype.itemsize}")
        zz = ((s << 1) ^ (s >> (w - 1))).view(u.dtype)  # zig-zag
        return zz, u[0]

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        if values.size < 2 or values.dtype.kind not in "iu":
            return None
        zz, _ = self._codes(values)
        span = int(zz.max())
        if span >= (1 << 32):
            return None
        w = bitpack.width_for_span(
            span, cfg.succinct_padded_to_next_byte_enabled if cfg else False)
        return w * bitpack.lanes_for(values.size) * 4 + 8

    def encode(self, values: np.ndarray, ltype, cfg, device="cpu") -> Encoded:
        n = values.shape[0]
        zz, base = self._codes(values)
        span = int(zz.max())
        if span >= (1 << 32):
            raise ValueError("delta codec needs zig-zag deltas < 2^32")
        w = bitpack.width_for_span(
            span, cfg.succinct_padded_to_next_byte_enabled if cfg else False)
        n_lanes = bitpack.lanes_for(n)
        words = bitpack.pack_numpy(zz.astype(np.uint32), w)
        nbytes = w * n_lanes * 4 + values.dtype.itemsize
        meta = (self.name, w, n_lanes, str(values.dtype))
        # the base rides as the int64 bit pattern of its unsigned view
        base_i64 = torch.tensor(segcodec._wrap64(int(base)), dtype=torch.int64)
        return Encoded(self.name, meta,
                       (_words(words, device), base_i64.to(device)), n, nbytes)

    def arg_count(self, meta) -> int:
        return 2

    def make_decoder(self, meta, compute_dtype):
        _, w, n_lanes, dtype = meta
        dt = tt.device_dtype(compute_dtype)
        narrow = np.dtype(dtype).itemsize == 4
        signed = np.dtype(dtype).kind == "i"

        def decode(args):
            words, base = args  # (n, w, L), (n,)
            n = base.shape[0]
            zz = bitpack.unpack(words, width=w).reshape(n, -1)
            d = (zz >> 1) ^ -(zz & 1)  # un-zig-zag: signed deltas
            v = torch.cumsum(d, dim=1) + base.reshape(n, 1)
            if narrow:
                v = v & _M32
                if signed:
                    v = torch.where(v >= (1 << 31), v - (1 << 32), v)
            return v.to(dt)

        return decode

    def gather(self, enc: Encoded, idx: torch.Tensor) -> torch.Tensor:
        # random access needs the prefix: decode the segment, then take
        return _decode_one(enc)[idx]


class DictionaryCodec:
    """Distinct-value LUT + bit-packed codes (dictionary_compression.cpp
    parity for low-cardinality integer segments; VARCHAR is dictionary-
    encoded at ingest by the column layer already)."""

    name = "dictionary"

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        if values.size == 0 or values.dtype.kind not in "iu":
            return None
        uniq = np.unique(values)
        card = len(uniq)
        if card <= 1 or card > min(1 << 16, values.size // 4):
            return None
        c_pad = _pow2_at_least(card)
        w = bitpack.width_for_span(card - 1)
        return w * bitpack.lanes_for(values.size) * 4 + \
            c_pad * values.dtype.itemsize

    def encode(self, values: np.ndarray, ltype, cfg, device="cpu") -> Encoded:
        n = values.shape[0]
        uniq, codes = np.unique(values, return_inverse=True)
        card = len(uniq)
        c_pad = _pow2_at_least(card)
        lut = np.concatenate([uniq, np.full(c_pad - card, uniq[-1],
                                            dtype=values.dtype)])
        w = bitpack.width_for_span(card - 1)
        n_lanes = bitpack.lanes_for(n)
        words = bitpack.pack_numpy(codes.reshape(-1).astype(np.uint32), w)
        nbytes = w * n_lanes * 4 + c_pad * values.dtype.itemsize
        meta = (self.name, w, c_pad, n_lanes, str(values.dtype))
        return Encoded(self.name, meta,
                       (_words(words, device), _to_device(lut, device)), n,
                       nbytes)

    def arg_count(self, meta) -> int:
        return 2

    def make_decoder(self, meta, compute_dtype):
        _, w, c_pad, n_lanes, _ = meta
        dt = tt.device_dtype(compute_dtype)

        def decode(args):
            words, lut = args  # (n, w, L), (n, c_pad)
            codes = bitpack.unpack(words, width=w).reshape(lut.shape[0], -1)
            return torch.gather(lut, 1, codes).to(dt)

        return decode

    def gather(self, enc: Encoded, idx: torch.Tensor) -> torch.Tensor:
        _, w, c_pad, n_lanes, _ = enc.meta
        words, lut = enc.arrays
        codes = bitpack.gather_codes(words, idx, width=w, n_lanes=n_lanes)
        return lut[codes]


class AlpCodec:
    """Exact decimal-scaled floats -> FOR bit-packed ints (ALP scheme).

    Covers the reference's float codecs (chimp/, patas.cpp) with a
    vectorizable design: chimp's XOR chain decodes serially; ALP decodes as
    an integer unpack and one division. Only applied when
    ``round(v * 10^e) / 10^e`` reproduces every bit. The scale is a runtime
    tensor: a division by a host constant may become a multiply by its
    reciprocal, which is inexact (5941/100 != 5941*0.01)."""

    name = "alp"
    _MAX_E = 14

    def _plan(self, values: np.ndarray):
        if values.dtype.kind != "f" or values.size == 0:
            return None
        if not np.isfinite(values).all():
            return None
        v64 = values.astype(np.float64)
        for e in range(0, self._MAX_E + 1):
            scale = 10.0 ** e
            scaled = v64 * scale
            if np.abs(scaled).max() >= float(1 << 62):
                return None
            ints = np.round(scaled)
            if np.array_equal((ints / scale).astype(values.dtype), values):
                lo, hi = int(ints.min()), int(ints.max())
                return e, ints.astype(np.int64), lo, hi
        return None

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        plan = self._plan(values)
        if plan is None:
            return None
        e, ints, lo, hi = plan
        widths, _ = segcodec.plan_widths(lo, hi, 8)
        return segcodec.packed_nbytes(widths, bitpack.lanes_for(values.size)) + 16

    def encode(self, values: np.ndarray, ltype, cfg, device="cpu") -> Encoded:
        e, ints, lo, hi = self._plan(values)
        widths, min_factor = segcodec.plan_widths(lo, hi, 8)
        n_lanes = bitpack.lanes_for(values.shape[0])
        codes = (ints - np.int64(min_factor)).view(np.uint64)
        planes = (codes & np.uint64(_M32), codes >> np.uint64(32))
        words = tuple(_words(bitpack.pack_numpy(p.astype(np.uint32), w), device)
                      for p, w in zip(planes, widths) if w > 0)
        arrays = words + (
            torch.tensor(min_factor, dtype=torch.int64).to(device),
            torch.tensor(10.0 ** e, dtype=torch.float64).to(device))
        meta = (self.name, widths, n_lanes, e, str(values.dtype))
        return Encoded(self.name, meta, arrays, values.shape[0],
                       segcodec.packed_nbytes(widths, n_lanes) + 16)

    def arg_count(self, meta) -> int:
        _, widths, _, _, _ = meta
        return sum(1 for w in widths if w > 0) + 2  # + min_factor + scale

    def make_decoder(self, meta, compute_dtype):
        _, widths, n_lanes, e, dtype = meta
        dt = tt.device_dtype(compute_dtype)

        def decode(args):
            mf, scale = args[-2], args[-1]
            planes = iter(args[:-2])
            ws = [None if w == 0 else next(planes) for w in widths]
            ints = segcodec.decode_stack(ws, mf, widths, n_lanes)
            return (ints.to(torch.float64) / scale.reshape(-1, 1)).to(dt)

        return decode

    def gather(self, enc: Encoded, idx: torch.Tensor) -> torch.Tensor:
        return _decode_one(enc)[idx]


# ======================================================================
# registry + selection
# ======================================================================

REGISTRY: Dict[str, object] = {
    c.name: c
    for c in (ConstantCodec(), RleCodec(), DeltaCodec(), DictionaryCodec(),
              AlpCodec())
}

#: codecs eligible for automatic selection, tried in this order
AUTO_ORDER = ("constant", "rle", "delta", "dictionary", "alp")


def analyze_all(values: np.ndarray, ltype, cfg) -> Dict[str, int]:
    """Estimated packed bytes per applicable codec (succinct/uncompressed
    are computed from segment stats by the caller)."""
    out = {}
    for name in AUTO_ORDER:
        est = REGISTRY[name].analyze(values, ltype, cfg)
        if est is not None:
            out[name] = est
    return out


def detect_best_codec(values: np.ndarray, ltype, cfg,
                      succinct_bytes: Optional[int]) -> tuple[str, int]:
    """ColumnDataCheckpointer::DetectBestCompressionMethod parity: smallest
    analyzed size wins; ties break toward the cheaper decoder (AUTO_ORDER).
    Returns (codec_name, estimated_bytes); 'succinct' or 'uncompressed' when
    nothing beats them."""
    plain = values.size * values.dtype.itemsize
    best_name, best_bytes = "uncompressed", plain
    if succinct_bytes is not None and succinct_bytes < best_bytes:
        best_name, best_bytes = "succinct", succinct_bytes
    for name, est in analyze_all(values, ltype, cfg).items():
        if est < best_bytes:
            best_name, best_bytes = name, est
    return best_name, best_bytes


def encode(name: str, values: np.ndarray, ltype, cfg,
           device="cpu") -> Encoded:
    return REGISTRY[name].encode(values, ltype, cfg, device)


def arg_count(meta) -> int:
    return REGISTRY[meta[0]].arg_count(meta)


def make_decoder(meta, compute_dtype):
    return REGISTRY[meta[0]].make_decoder(meta, compute_dtype)


def _decode_one(enc: Encoded) -> torch.Tensor:
    """One segment's decode in the device dtype of its values (count rows)."""
    dec = make_decoder(enc.meta, np.dtype(enc.meta[-1]))
    return dec(tuple(a.unsqueeze(0) for a in enc.arrays))[0, :enc.count]


def decode_full(enc: Encoded, compute_dtype) -> torch.Tensor:
    """Whole-segment decode -> a (count,) tensor of `compute_dtype`."""
    return segcodec._from_i64(_decode_one(enc), compute_dtype)


def gather(enc: Encoded, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` of an encoded segment, in the device dtype of its values."""
    return REGISTRY[enc.codec].gather(enc, idx)


def decode_full_host(enc: Encoded, compute_dtype) -> np.ndarray:
    """Exact host materialization (the device decode is exact, ALP too)."""
    v = _decode_one(enc).cpu().numpy()
    return v.astype(np.dtype(compute_dtype), copy=False)
