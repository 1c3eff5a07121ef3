"""Fused compressed table scan: bit-unpack + row validity + range predicate
+ sum/count/min/max over a stack of same-width packed segments, in one pass.

Port of the JAX package's kernel B1: it replaces
``adacom_tpu/ops/pallas_scan.py::_build_table_scan`` (with its runner and
``scan_table``). The CUDA kernel is ``csrc/table_scan.cu``, written for
Hopper (sm_90a) and built on first use (``build.py``). It is bound by the
packed bytes against HBM bandwidth: one pass, every packed word read once,
one thread per lane reading coalesced words, the 32 row unpacks unrolled
per width, and one partial per (segment, block) finished by a few int64
torch ops on the device and ONE host pull.

``scan_table_reference`` is the plain PyTorch version of the same function
(int64 arithmetic on any device, built from ``bitpack.unpack``).
``scan_table`` takes the reference's arguments: on CUDA tensors it launches
the kernel or raises; on CPU tensors it runs the plain version.

The predicate runs in *code space*: the caller's value range [lo, hi] maps
per segment to [lo - min, hi - min] with saturation to [0, 2^32), and a
code matches iff (code - lo_code) <= (hi_code - lo_code) in uint32
arithmetic. A range that is empty for a segment becomes count = 0 for it,
since the unsigned span would otherwise wrap to match everything.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from adacom_tpu_torch import build
from adacom_tpu_torch.ops import bitpack

U32_MAX = 0xFFFFFFFF
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min

# kernel launches made by scan_table (a plain integer; a run resets and
# reads it to show the main path went through the kernel)
KERNEL_LAUNCHES = 0


def supported(width: int, n_lanes: int = 1) -> bool:
    """scan_table handles widths 1..32 at any lane count."""
    return 1 <= width <= 32 and n_lanes >= 1


def _scalars(n_seg: int, n_lanes: int, counts, mins, lo, hi, lanes):
    """Per-segment (n_seg, 4) uint32 [count, lo_code, hi_code, lanes] and
    int64 minima — the JAX wrapper's saturation (pallas_scan.py:345-361)."""
    mins64 = np.asarray(mins, dtype=np.int64).reshape(n_seg)
    counts = np.asarray(counts, dtype=np.int64).reshape(n_seg)
    lanes_arr = (np.full(n_seg, n_lanes, np.int64) if lanes is None
                 else np.asarray(lanes, dtype=np.int64).reshape(n_seg))
    scal = np.zeros((n_seg, 4), dtype=np.uint32)
    scal[:, 0] = counts.astype(np.uint32)
    scal[:, 3] = lanes_arr.astype(np.uint32)
    lo_v = -(1 << 62) if lo is None else int(lo)
    hi_v = (1 << 62) if hi is None else int(hi)
    lo_c = np.clip(lo_v - mins64, 0, U32_MAX)
    hi_c = np.clip(hi_v - mins64, -1, U32_MAX)
    scal[:, 1] = lo_c.astype(np.uint32)
    scal[:, 2] = np.where(hi_c < 0, 0, hi_c).astype(np.uint32)
    empty = hi_c < lo_c
    scal[empty, 0] = 0
    scal[empty, 1] = 0
    scal[empty, 2] = 0
    return scal, mins64


def _finish(code_sum, cnt, mn, mx, mins, minmax: bool) -> torch.Tensor:
    """Per-segment int64 (code_sum, count, min_code, max_code) -> the
    (4,) int64 [sum, count, vmin, vmax] (vmin/vmax 0 without minmax)."""
    total = (code_sum + cnt * mins).sum()
    zero = torch.zeros((), dtype=torch.int64, device=cnt.device)
    if not minmax:
        return torch.stack([total, cnt.sum(), zero, zero])
    has = cnt > 0
    gmin = torch.where(has, mn + mins, zero + _I64_MAX).min()
    gmax = torch.where(has, mx + mins, zero + _I64_MIN).max()
    return torch.stack([total, cnt.sum(), gmin, gmax])


def _check_shapes(words: torch.Tensor, valids: Optional[torch.Tensor]):
    if words.dim() != 3:
        raise ValueError(f"words must be (n_seg, width, n_lanes), got {tuple(words.shape)}")
    n_seg, width, n_lanes = (int(x) for x in words.shape)
    if n_seg < 1 or not supported(width, n_lanes):
        raise ValueError(f"unsupported scan shape {tuple(words.shape)}")
    if valids is not None and tuple(valids.shape) != (n_seg, 1, n_lanes):
        raise ValueError(f"valids must be {(n_seg, 1, n_lanes)}, got {tuple(valids.shape)}")
    return n_seg, width, n_lanes


def _result(out: torch.Tensor, device_out: bool):
    if device_out:
        return out
    s, c, mn, mx = out.tolist()  # the one host pull
    return s, c, mn, mx


def scan_table_reference(words: torch.Tensor, counts, mins, lo=None, hi=None,
                         lanes=None, device_out: bool = False,
                         minmax: bool = True, valids=None):
    """Plain PyTorch version of scan_table, on the tensors' device.

    Same arguments and results as scan_table; every intermediate is int64
    (codes from bitpack.unpack, the uint32 span trick with explicit masks)."""
    n_seg, width, n_lanes = _check_shapes(words, valids)
    scal, mins64 = _scalars(n_seg, n_lanes, counts, mins, lo, hi, lanes)
    dev = words.device
    sc = torch.from_numpy(scal.astype(np.int64)).to(dev)
    codes = bitpack.unpack(words, width=width)               # (S, 32, L)
    r = torch.arange(bitpack.ROWS, device=dev).view(1, -1, 1)
    lane = torch.arange(n_lanes, device=dev).view(1, 1, -1)
    cnt_s = sc[:, 0].view(-1, 1, 1)
    lanes_s = sc[:, 3].view(-1, 1, 1)
    keep = (lane < lanes_s) & (r * lanes_s + lane < cnt_s)
    if valids is not None:
        vbits = bitpack.words_u32(valids)                    # (S, 1, L)
        keep &= ((vbits >> r) & 1) == 1
    lo_s = sc[:, 1].view(-1, 1, 1)
    span = ((sc[:, 2] - sc[:, 1]) & U32_MAX).view(-1, 1, 1)
    keep &= ((codes - lo_s) & U32_MAX) <= span
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    code_sum = torch.where(keep, codes, zero).sum(dim=(1, 2))
    cnt = keep.sum(dim=(1, 2))
    mn = torch.where(keep, codes, zero + U32_MAX).amin(dim=(1, 2))
    mx = torch.where(keep, codes, zero).amax(dim=(1, 2))
    mins_t = torch.from_numpy(mins64).to(dev)
    return _result(_finish(code_sum, cnt, mn, mx, mins_t, minmax), device_out)


def scan_table(words: torch.Tensor, counts, mins, lo=None, hi=None,
               lanes=None, device_out: bool = False, minmax: bool = True,
               valids=None):
    """Fused compressed scan over a stacked table of same-width segments.

    words:  (n_seg, width, n_lanes) int32 packed planes (bitpack layout);
            segments with fewer lanes are zero-padded on the lane axis
    counts: (n_seg,) valid row counts
    mins:   (n_seg,) per-segment frame-of-reference minima
    lo/hi:  inclusive predicate range in the VALUE domain (None = open)
    lanes:  (n_seg,) each segment's ORIGINAL lane count (defaults to the
            stacked lane dim) — element order is i = r*lanes[s] + lane
    minmax: False reports vmin = vmax = 0
    valids: optional (n_seg, 1, n_lanes) int32 stacked width-1 validity
            planes (all-ones words for fully-valid segments); NULL rows are
            excluded from sum/count/min/max
    device_out: return the (4,) int64 device tensor instead of pulling it

    Returns (sum, count, vmin, vmax) as python ints; vmin/vmax only valid
    when count > 0 and minmax=True. Exact for 32-bit integer domains.
    """
    global KERNEL_LAUNCHES
    if words.device.type == "cpu":
        return scan_table_reference(words, counts, mins, lo, hi, lanes,
                                    device_out, minmax, valids)
    if words.device.type != "cuda":
        raise ValueError(f"scan_table: no kernel for device {words.device}")
    n_seg, width, n_lanes = _check_shapes(words, valids)
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError("scan_table: words must be contiguous int32")
    if valids is not None and (valids.device != words.device
                               or valids.dtype != torch.int32
                               or not valids.is_contiguous()):
        raise ValueError("scan_table: valids must be contiguous int32 on "
                         "the words' device")
    dev = words.device
    scal, mins64 = _scalars(n_seg, n_lanes, counts, mins, lo, hi, lanes)
    sc = torch.from_numpy(scal.view(np.int32)).to(dev)
    lib = build.kernels()
    threads = lib.adacom_table_scan_threads()
    blocks_y = min(math.ceil(n_lanes / threads), 65535)
    part = torch.empty((n_seg, blocks_y, 4), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.adacom_table_scan(
            words.data_ptr(), sc.data_ptr(),
            None if valids is None else valids.data_ptr(), part.data_ptr(),
            n_seg, width, n_lanes, blocks_y, stream)
    if rc != 0:
        raise RuntimeError(f"table_scan kernel launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES += 1
    mins_t = torch.from_numpy(mins64).to(dev)
    out = _finish(part[..., 0].sum(dim=1), part[..., 1].sum(dim=1),
                  part[..., 2].amin(dim=1), part[..., 3].amax(dim=1),
                  mins_t, minmax)
    return _result(out, device_out)
