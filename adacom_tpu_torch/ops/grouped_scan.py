"""Fused grouped compressed scans: per-group sums and counts over a small
dense group domain, in one pass over packed planes.

Port of the JAX package's kernels B2 and B3:

- ``grouped_scan_table`` replaces ``adacom_tpu/ops/pallas_scan.py::
  _build_grouped_scan`` (with its runner and ``grouped_scan_table``): the
  per-group sum and count of one packed value plane keyed by one packed
  group plane, with an optional value-range predicate;
- ``multi_grouped_scan_table`` replaces ``_build_multi_grouped_scan`` (with
  ``_build_multi_runner`` and ``multi_grouped_scan_table``): per group of a
  mixed-radix id over up to 6 packed group planes, the sums of monomials
  (products of up to 3 values) over up to 8 packed value planes and a
  match count, under a conjunction of per-plane code-space predicates.

One CUDA kernel serves both (``csrc/grouped_scan.cu``, built for sm_90a by
``build.py``): B2 is B3 with one group plane, one value plane whose minimum
is left out, and the monomial ``(v,)``. The kernel returns per-segment code
sums, and the wrapper rebuilds each segment's value sum in int64 as
``code_sum + count * vmin``, so B2 keeps signed minima and values of
2^31 and above. Integer sums are exact in any order: kernel and plain
version agree exactly.

Each entry point has a plain PyTorch twin (``*_reference``): int64
arithmetic from ``bitpack.unpack``, on any device. On CUDA tensors an entry
point launches the kernel or raises; on CPU tensors it runs its twin.

The group id and the values follow the Pallas kernels' 32-bit arithmetic:
a group id is ``sum_j (gcode_j + gmin_j) * stride_j`` mod 2^32 and counts
iff it lies in ``[0, n_groups)``; a value is ``(code + vmin)`` mod 2^32 and a
monomial the product of its values mod 2^32 (the executor's gate keeps
both exact: ``vmin >= 0`` and products below 2^32).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from adacom_tpu_torch import build
from adacom_tpu_torch.ops import bitpack, fused_scan

_M32 = 0xFFFFFFFF

MAX_GROUPS = 16  # B2's group domain bound (the kernel's accumulators)


def grouped_supported(n_groups: int, gw: int, vw: int) -> bool:
    return 1 <= n_groups <= MAX_GROUPS and 1 <= gw <= 32 and 1 <= vw <= 32


MAX_MULTI_GROUPS = 16
MAX_MULTI_PLANES = 8
MAX_MONO_DEGREE = 3
MAX_GROUP_PLANES = 6   # the scalar table holds 6 group minima
MAX_MONOS = 32         # kernel descriptor bound (the warp mode's outputs)

# scalar-table column layout, (n_seg, 32) uint32
_SC_COUNT = 0
_SC_LORIG = 1
_SC_GMIN = 2       # + group index j (j < 6)
_SC_VMIN = 8       # + plane index p (p < 8)
_SC_PRED = 16      # + 2*q (lo), 2*q+1 (hi) for pred q (q < 8)
SCAL_COLS = 32


def multi_supported(n_groups, n_planes, monos):
    return (1 <= n_groups <= MAX_MULTI_GROUPS
            and n_planes <= MAX_MULTI_PLANES
            and all(1 <= len(m) <= MAX_MONO_DEGREE for m in monos))


# kernel launches made by each entry point (plain integers; a run resets
# and reads them to show the main path went through the kernel)
GROUPED_LAUNCHES = 0
MULTI_LAUNCHES = 0


# ----------------------------------------------------------------------
# shapes
# ----------------------------------------------------------------------


def _check_grouped(gwords, vwords, n_groups):
    for name, t in (("gwords", gwords), ("vwords", vwords)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be (n_seg, width, n_lanes), got "
                             f"{tuple(t.shape)}")
    n_seg, gw, n_lanes = (int(x) for x in gwords.shape)
    vw = int(vwords.shape[1])
    if int(vwords.shape[0]) != n_seg or int(vwords.shape[2]) != n_lanes:
        raise ValueError(f"group planes {tuple(gwords.shape)} and value "
                         f"planes {tuple(vwords.shape)} differ in segments "
                         "or lanes")
    if n_seg < 1 or n_lanes < 1 or not grouped_supported(n_groups, gw, vw):
        raise ValueError(f"unsupported grouped scan shape: {n_groups} groups,"
                         f" planes {tuple(gwords.shape)}, {tuple(vwords.shape)}")
    return n_seg, gw, vw, n_lanes


def check_multi(gstacks, vstacks, scal, n_groups, strides, monos, preds):
    """Raise ValueError unless the arguments form a shape the kernel takes.

    Returns (n_seg, n_lanes, group widths, value widths). Nothing here
    touches a device: the executor calls it before it launches anything."""
    n_seg = int(scal.shape[0])
    if tuple(scal.shape) != (n_seg, SCAL_COLS) or n_seg < 1:
        raise ValueError(f"scal must be (n_seg, {SCAL_COLS}), got "
                         f"{tuple(scal.shape)}")
    gws = tuple(0 if s is None else int(s.shape[1]) for s in gstacks)
    vws = tuple(0 if s is None else int(s.shape[1]) for s in vstacks)
    stacks = [s for s in list(gstacks) + list(vstacks) if s is not None]
    if not stacks:
        # no word planes: the lane grid (and with it each segment's row
        # capacity) cannot be derived; callers route to the host
        raise ValueError("multi grouped scan needs at least one word plane")
    for s in stacks:
        if s.dim() != 3 or int(s.shape[0]) != n_seg or \
                not 1 <= int(s.shape[1]) <= 32:
            raise ValueError(f"plane stack {tuple(s.shape)} is not "
                             f"({n_seg}, 1..32, n_lanes)")
    if len(gstacks) > MAX_GROUP_PLANES or len(strides) != len(gstacks):
        raise ValueError(f"{len(gstacks)} group planes with {len(strides)} "
                         f"strides (at most {MAX_GROUP_PLANES})")
    if any(not 0 <= int(st) < (1 << 31) for st in strides):
        raise ValueError(f"strides {strides} outside [0, 2^31)")
    if not multi_supported(n_groups, len(vstacks), monos) or \
            len(monos) > MAX_MONOS:
        raise ValueError(f"unsupported multi grouped scan: {n_groups} groups,"
                         f" {len(vstacks)} value planes, monomials {monos}")
    if any(not 0 <= p < len(vstacks) for m in monos for p in m) or \
            len(preds) > MAX_MULTI_PLANES or \
            any(not 0 <= p < len(vstacks) for p in preds):
        raise ValueError(f"monomials {monos} / predicates {preds} name "
                         f"planes outside the {len(vstacks)} value planes")
    n_lanes = max(int(s.shape[2]) for s in stacks)
    return n_seg, n_lanes, gws, vws


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------


def _row_keep(count, lanes, n_lanes, dev):
    """(n_seg, 32, n_lanes) bool: row r of lane l counts iff l < lanes[s]
    and r * lanes[s] + l < count[s] (count, lanes: (n_seg,) int64)."""
    r = torch.arange(bitpack.ROWS, device=dev).view(1, -1, 1)
    lane = torch.arange(n_lanes, device=dev).view(1, 1, -1)
    lanes_s = lanes.view(-1, 1, 1)
    return (lane < lanes_s) & (r * lanes_s + lane < count.view(-1, 1, 1))


def _codes(words, width, n_lanes, n_seg, dev):
    """(n_seg, 32, n_lanes) int64 codes of a plane stack (zeros for a
    width-0 plane; narrower stacks are zero-padded on the lane axis)."""
    if words is None or width == 0:
        return torch.zeros((n_seg, bitpack.ROWS, n_lanes), dtype=torch.int64,
                           device=dev)
    codes = bitpack.unpack(words, width=width)
    if codes.shape[2] != n_lanes:
        codes = torch.nn.functional.pad(codes, (0, n_lanes - codes.shape[2]))
    return codes


def _group_sums(grp, keep, terms, n_groups):
    """Per-(segment, group) sums of each int64 term over the kept rows,
    then the kept-row count: a list of (n_seg, n_groups) int64 tensors.
    One masked reduction per group keeps the memory at one plane."""
    zero = torch.zeros((), dtype=torch.int64, device=grp.device)
    outs = [[] for _ in range(len(terms) + 1)]
    for g in range(n_groups):
        m = keep & (grp == g)
        for i, t in enumerate(terms):
            outs[i].append(torch.where(m, t, zero).sum(dim=(1, 2)))
        outs[-1].append(m.sum(dim=(1, 2)))
    return [torch.stack(o, dim=1) for o in outs]


def grouped_scan_table_reference(gwords, vwords, counts, gmins, vmins,
                                 n_groups, lo=None, hi=None, lanes=None):
    """Plain PyTorch version of grouped_scan_table, on the tensors' device.
    Same arguments and result."""
    n_seg, gw, vw, n_lanes = _check_grouped(gwords, vwords, n_groups)
    sc4, vmins64 = fused_scan._scalars(n_seg, n_lanes, counts, vmins, lo, hi,
                                       lanes)
    dev = gwords.device
    sc = torch.from_numpy(sc4.astype(np.int64)).to(dev)
    gm = np.asarray(gmins, dtype=np.int64).reshape(n_seg) & _M32
    gm_t = torch.from_numpy(gm).to(dev).view(-1, 1, 1)
    keep = _row_keep(sc[:, 0], sc[:, 3], n_lanes, dev)
    vcode = bitpack.unpack(vwords, width=vw)
    span = ((sc[:, 2] - sc[:, 1]) & _M32).view(-1, 1, 1)
    keep &= ((vcode - sc[:, 1].view(-1, 1, 1)) & _M32) <= span
    grp = (bitpack.unpack(gwords, width=gw) + gm_t) & _M32
    code_sum, cnt = _group_sums(grp, keep, [vcode], n_groups)
    vm = torch.from_numpy(vmins64).to(dev).view(-1, 1)
    seg_sum = code_sum + cnt * vm
    return torch.stack([seg_sum.sum(dim=0), cnt.sum(dim=0)], dim=1).cpu().numpy()


def multi_grouped_scan_table_reference(gstacks, vstacks, scal, n_groups,
                                       strides, monos, preds):
    """Plain PyTorch version of multi_grouped_scan_table, on the stacks'
    device. Same arguments and result."""
    n_seg, n_lanes, gws, vws = check_multi(gstacks, vstacks, scal, n_groups,
                                           strides, monos, preds)
    dev = next(s for s in list(gstacks) + list(vstacks) if s is not None).device
    sc = torch.from_numpy(np.asarray(scal, dtype=np.uint32).astype(np.int64)).to(dev)

    def col(c):
        return sc[:, c].view(-1, 1, 1)

    keep = _row_keep(sc[:, _SC_COUNT], sc[:, _SC_LORIG], n_lanes, dev)
    for q, p in enumerate(preds):
        code = _codes(vstacks[p], vws[p], n_lanes, n_seg, dev)
        lo = col(_SC_PRED + 2 * q)
        span = (col(_SC_PRED + 2 * q + 1) - lo) & _M32
        keep &= ((code - lo) & _M32) <= span
    grp = torch.zeros((), dtype=torch.int64, device=dev)
    for j, w in enumerate(gws):
        code = _codes(gstacks[j], w, n_lanes, n_seg, dev)
        grp = (grp + ((code + col(_SC_GMIN + j)) & _M32) * int(strides[j])) & _M32
    grp = grp.expand(n_seg, bitpack.ROWS, n_lanes)
    vals = {p: (_codes(vstacks[p], vws[p], n_lanes, n_seg, dev)
                + col(_SC_VMIN + p)) & _M32
            for p in sorted({p for m in monos for p in m})}
    terms = []
    for m in monos:
        t = vals[m[0]]
        for p in m[1:]:
            t = (t * vals[p]) & _M32  # low 32 bits survive int64 wrap
        terms.append(t)
    parts = _group_sums(grp, keep, terms, n_groups)
    return torch.stack([p.sum(dim=0) for p in parts], dim=1).cpu().numpy()


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------


# Accumulator bytes a block may give private per-thread slots (the
# kernel's kPrivateBytes): n_groups * n_out * threads * 8 B at most.
PRIVATE_BYTES = 48 * 1024
# The kernel's instantiations: the most bit readers (planes of width > 0)
# each one carries.
READER_CLASSES = (2, 4, 8, 14)


def accumulator_mode(n_groups: int, n_out: int, threads: int) -> str:
    """"private" (per-thread u64 slots, no atomics) when a block's slots fit
    in PRIVATE_BYTES of shared memory, else "warp" (warp-aggregated adds)."""
    return ("private" if n_groups * n_out * threads * 8 <= PRIVATE_BYTES
            else "warp")


def reader_class(n_readers: int) -> int:
    """The smallest instantiation that carries `n_readers` bit readers."""
    for c in READER_CLASSES:
        if n_readers <= c:
            return c
    raise ValueError(f"{n_readers} bit readers (at most {READER_CLASSES[-1]})")


def launch_blocks(n_seg: int, n_lanes: int, threads: int,
                  resident: int) -> int:
    """Persistent blocks for n_seg * ceil(n_lanes / threads) (segment, lane
    tile) pieces: one per block the card holds at once, never more blocks
    than pieces."""
    return max(1, min(n_seg * math.ceil(n_lanes / threads), resident))


_RESIDENT = {}


def _resident_blocks(lib, dev, cap: int, private: bool, n_groups: int,
                     n_out: int) -> int:
    """Blocks of this instantiation and shape the whole card holds at once."""
    key = (dev.index, cap, private, n_groups, n_out)
    if key not in _RESIDENT:
        per_sm = lib.adacom_grouped_scan_blocks_per_sm(cap, int(private),
                                                       n_groups, n_out)
        if per_sm < 1:
            raise RuntimeError(f"grouped_scan kernel fits no SM "
                               f"(occupancy query returned {per_sm})")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _RESIDENT[key] = per_sm * sms
    return _RESIDENT[key]


@dataclasses.dataclass
class _Launch:
    """One prepared kernel launch: device inputs and output, and the host
    descriptor the C interface copies into the kernel's parameters."""

    planes: List[Optional[torch.Tensor]]  # 6 group slots, then 8 value slots
    widths: np.ndarray                    # (14,) int32
    plane_lanes: np.ndarray               # (14,) int32, each stack's lanes
    strides: np.ndarray                   # (6,) uint32
    monos: np.ndarray                     # (n_mono, 3) int32, -1 pads
    preds: np.ndarray                     # (n_pred,) int32
    scal: torch.Tensor                    # (n_seg, 32) int32 on the device
    out: torch.Tensor                     # (n_seg, G, n_out) int64
    n_gp: int
    n_vp: int
    n_groups: int
    n_lanes: int
    readers: int                          # instantiation (READER_CLASSES)
    private: bool                         # accumulator mode
    blocks: int


def _prepare(gstacks, vstacks, scal_np, n_groups, strides, monos, preds,
             n_lanes) -> _Launch:
    stacks = [s for s in list(gstacks) + list(vstacks) if s is not None]
    dev = stacks[0].device
    for s in stacks:
        if s.device != dev or s.dtype != torch.int32:
            raise ValueError("plane stacks must be int32 on one device")
    lib = build.kernels()
    threads = lib.adacom_grouped_scan_threads()
    # a stack narrower than n_lanes is read in place: the kernel takes each
    # stack's own lane count and reads its missing lanes as code 0
    planes = [None] * (MAX_GROUP_PLANES + MAX_MULTI_PLANES)
    for j, s in enumerate(gstacks):
        planes[j] = None if s is None else s.contiguous()
    for p, s in enumerate(vstacks):
        planes[MAX_GROUP_PLANES + p] = None if s is None else s.contiguous()
    widths = np.array([0 if s is None else int(s.shape[1]) for s in planes],
                      np.int32)
    plane_lanes = np.array([0 if s is None else int(s.shape[2])
                            for s in planes], np.int32)
    st = np.zeros(MAX_GROUP_PLANES, np.uint32)
    st[:len(strides)] = [int(x) for x in strides]
    mono_arr = np.full((len(monos), 3), -1, np.int32)
    for i, m in enumerate(monos):
        mono_arr[i, :len(m)] = m
    n_seg = int(scal_np.shape[0])
    n_out = len(monos) + 1
    sc = torch.from_numpy(np.ascontiguousarray(scal_np, dtype=np.uint32)
                          .view(np.int32)).to(dev)
    private = accumulator_mode(n_groups, n_out, threads) == "private"
    cap = reader_class(len(stacks))
    resident = _resident_blocks(lib, dev, cap, private, int(n_groups), n_out)
    blocks = launch_blocks(n_seg, n_lanes, threads, resident)
    out = torch.empty((n_seg, n_groups, n_out), dtype=torch.int64, device=dev)
    return _Launch(planes, widths, plane_lanes, st, mono_arr,
                   np.asarray(preds, np.int32).reshape(-1), sc, out,
                   len(gstacks), len(vstacks), int(n_groups), n_lanes, cap,
                   private, blocks)


def _launch(lp: _Launch) -> torch.Tensor:
    """Zero the output and launch the kernel on the current stream; returns
    the per-segment sums (n_seg, G, n_out)."""
    lib = build.kernels()
    ptrs = (ctypes.c_void_p * len(lp.planes))(
        *[None if t is None else t.data_ptr() for t in lp.planes])
    dev = lp.out.device
    with torch.cuda.device(dev):
        lp.out.zero_()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.adacom_multi_grouped_scan(
            ptrs, lp.widths.ctypes.data, lp.plane_lanes.ctypes.data,
            lp.strides.ctypes.data, lp.monos.ctypes.data,
            lp.preds.ctypes.data, lp.n_gp, lp.n_vp, int(lp.monos.shape[0]),
            int(lp.preds.shape[0]), lp.n_groups, lp.scal.data_ptr(),
            lp.out.data_ptr(), int(lp.out.shape[0]), lp.n_lanes, lp.readers,
            int(lp.private), lp.blocks, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_scan kernel launch failed: CUDA error {rc}")
    return lp.out


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def prepare_grouped(gwords, vwords, counts, gmins, vmins, n_groups, lo=None,
                    hi=None, lanes=None) -> Tuple[_Launch, torch.Tensor]:
    """B2 mapped onto the kernel: (launch, per-segment int64 vmins)."""
    n_seg, _gw, _vw, n_lanes = _check_grouped(gwords, vwords, n_groups)
    sc4, vmins64 = fused_scan._scalars(n_seg, n_lanes, counts, vmins, lo, hi,
                                       lanes)
    scal = np.zeros((n_seg, SCAL_COLS), np.uint32)
    scal[:, _SC_COUNT] = sc4[:, 0]
    scal[:, _SC_LORIG] = sc4[:, 3]
    scal[:, _SC_GMIN] = np.asarray(gmins, np.int64).reshape(n_seg) & _M32
    # value minimum left at 0: the kernel sums codes; the epilogue adds
    # count * vmin in int64
    scal[:, _SC_PRED] = sc4[:, 1]
    scal[:, _SC_PRED + 1] = sc4[:, 2]
    lp = _prepare([gwords], [vwords], scal, n_groups, (1,), ((0,),), (0,),
                  n_lanes)
    return lp, torch.from_numpy(vmins64).to(gwords.device)


def _finish_grouped(seg, vmins_t):
    """(n_seg, G, 2) per-segment [code_sum, count] -> (G, 2) int64
    [sum, count] on the device."""
    cnt = seg[..., 1]
    seg_sum = seg[..., 0] + cnt * vmins_t.view(-1, 1)
    return torch.stack([seg_sum.sum(dim=0), cnt.sum(dim=0)], dim=1)


def grouped_scan_table(gwords, vwords, counts, gmins, vmins, n_groups,
                       lo=None, hi=None, lanes=None):
    """Fused grouped scan: per-group (sum, count) of the value column over
    a dense group domain [0, n_groups).

    gwords/vwords: (n_seg, gw|vw, n_lanes) int32 packed planes (group ids
    and values share the segment layout); counts: (n_seg,) row counts;
    gmins/vmins: per-segment FOR minima (group ids are gcode + gmin —
    callers pass group-domain-rebased minima); lo/hi: optional VALUE-domain
    predicate range; lanes: each segment's original lane count.
    Returns a (n_groups, 2) int64 numpy array [sum, count]."""
    global GROUPED_LAUNCHES
    if gwords.device.type == "cpu":
        return grouped_scan_table_reference(gwords, vwords, counts, gmins,
                                            vmins, n_groups, lo, hi, lanes)
    _require_cuda(gwords, "grouped_scan_table")
    lp, vmins_t = prepare_grouped(gwords, vwords, counts, gmins, vmins,
                                  n_groups, lo, hi, lanes)
    part = _launch(lp)
    GROUPED_LAUNCHES += 1
    return _finish_grouped(part, vmins_t).cpu().numpy()  # the one host pull


def prepare_multi(gstacks, vstacks, scal, n_groups, strides, monos,
                  preds) -> _Launch:
    n_seg, n_lanes, _gws, _vws = check_multi(gstacks, vstacks, scal,
                                             n_groups, strides, monos, preds)
    return _prepare(gstacks, vstacks, np.asarray(scal), n_groups, strides,
                    monos, preds, n_lanes)


def multi_grouped_scan_table(gstacks: Sequence[Optional[torch.Tensor]],
                             vstacks: Sequence[Optional[torch.Tensor]],
                             scal, n_groups, strides, monos, preds):
    """Fused multi-aggregate grouped scan over one representation class.

    gstacks: (n_seg, w_j, n_lanes) int32 packed group planes (None for a
             width-0 plane), with strides[j] their mixed-radix strides;
    vstacks: (n_seg, w_p, n_lanes) int32 packed value planes (None for
             width-0 planes);
    scal:    (n_seg, 32) uint32 scalar table (the _SC_* layout);
    monos:   tuples of value-plane indices, one per monomial;
    preds:   value-plane indices carrying a code-space range predicate
             (lo/hi in the scalar table, pred q at _SC_PRED + 2q).
    Returns a (n_groups, len(monos) + 1) int64 numpy array: the monomial
    sums, then the count."""
    global MULTI_LAUNCHES
    first = next((s for s in list(gstacks) + list(vstacks) if s is not None),
                 None)
    if first is None or first.device.type == "cpu":
        return multi_grouped_scan_table_reference(
            gstacks, vstacks, scal, n_groups, strides, monos, preds)
    _require_cuda(first, "multi_grouped_scan_table")
    part = _launch(prepare_multi(gstacks, vstacks, scal, n_groups, strides,
                                 monos, preds))
    MULTI_LAUNCHES += 1
    return part.sum(dim=0).cpu().numpy()  # the one host pull
