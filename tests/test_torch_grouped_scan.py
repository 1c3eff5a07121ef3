"""Port grouped scans (adacom_tpu_torch.ops.grouped_scan) against the JAX
package's Pallas kernels B2 and B3 (adacom_tpu.ops.pallas_scan.
grouped_scan_table / multi_grouped_scan_table, run in interpret mode on
the CPU as the JAX package's own tests run them).

On the CPU the port's entry points run their plain PyTorch versions; the
CUDA kernel is held against those on the card by chip_smoke.py. The same
packed words (bitpack.pack_numpy; the bit layout is shared) go to both.
Results are integer sums and counts and must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adacom_tpu import types as _jtt  # noqa: F401  (enables jax x64)
from adacom_tpu.ops import pallas_scan
from adacom_tpu_torch.ops import bitpack, grouped_scan

SEG_ROWS = [2048, 2048, 1500]           # ragged tail: fewer lanes, rows
LANES = [bitpack.lanes_for(n) for n in SEG_ROWS]
L = max(LANES)
M32 = 0xFFFFFFFF


def _plane(codes_per_seg, width):
    """(n_seg, width, L) uint32 stack of pack_numpy words."""
    out = np.zeros((len(SEG_ROWS), width, L), np.uint32)
    for s, codes in enumerate(codes_per_seg):
        out[s, :, :LANES[s]] = bitpack.pack_numpy(codes, width)
    return out


def _group_codes(rng, width, n_groups):
    """Codes mostly inside the domain (and a little past it), plus a few
    full-width codes that land far outside it."""
    top = (1 << width) - 1
    segs = []
    for n in SEG_ROWS:
        c = rng.integers(0, min(top, n_groups + 1), n, endpoint=True,
                         dtype=np.uint64)
        wide = rng.random(n) < 0.05
        c[wide] = rng.integers(0, top, int(wide.sum()), endpoint=True,
                               dtype=np.uint64)
        segs.append(c.astype(np.uint32))
    return segs


def _value_codes(rng, width):
    return [rng.integers(0, 1 << width, n, dtype=np.uint64).astype(np.uint32)
            for n in SEG_ROWS]


def _t(words):
    return torch.from_numpy(words.view(np.int32))


# ----------------------------------------------------------------------
# B2
# ----------------------------------------------------------------------

GMINS = [0, 2, -1]                       # rebased: -1 drops code 0
VMINS = [-4000, 123, -(1 << 31)]         # signed frame-of-reference minima


def _b2_ranges(vw):
    top = (1 << vw) - 1
    return [
        (-3000, 123 + top // 2),         # cuts through every segment
        (10**12, 10**13),                # empty for every segment
        (-(1 << 31) + top // 3, -3500),  # empty for some segments only
    ]


def _b2_oracle(gcodes, vcodes, n_groups, lo, hi):
    out = np.zeros((n_groups, 2), np.int64)
    for gc, vc, gm, vm in zip(gcodes, vcodes, GMINS, VMINS):
        gid = (gc.astype(np.int64) + gm) & M32
        val = vc.astype(np.int64) + vm
        keep = gid < n_groups
        if lo is not None:
            keep &= val >= lo
        if hi is not None:
            keep &= val <= hi
        np.add.at(out[:, 0], gid[keep], val[keep])
        np.add.at(out[:, 1], gid[keep], 1)
    return out


# every width of {1, 2, 7, 16, 31, 32} appears for both planes
B2_CASES = [(1, 32, 6), (2, 31, 6), (7, 16, 16), (16, 7, 6), (31, 2, 6),
            (32, 1, 6)]


@pytest.mark.parametrize("gw,vw,n_groups", B2_CASES)
def test_grouped_scan_matches_pallas(gw, vw, n_groups):
    rng = np.random.default_rng(gw * 100 + vw)
    gcodes = _group_codes(rng, gw, n_groups)
    vcodes = _value_codes(rng, vw)
    gwords, vwords = _plane(gcodes, gw), _plane(vcodes, vw)
    ranges = _b2_ranges(vw) + ([(None, None)] if gw == 1 else [])
    for lo, hi in ranges:
        got = grouped_scan.grouped_scan_table(
            _t(gwords), _t(vwords), SEG_ROWS, GMINS, VMINS, n_groups, lo, hi,
            lanes=LANES)
        ref = pallas_scan.grouped_scan_table(
            jnp.asarray(gwords), jnp.asarray(vwords), SEG_ROWS, GMINS, VMINS,
            n_groups, lo, hi, lanes=LANES)
        assert got.dtype == np.int64 and got.shape == (n_groups, 2)
        np.testing.assert_array_equal(got, np.asarray(ref))
        np.testing.assert_array_equal(
            got, _b2_oracle(gcodes, vcodes, n_groups, lo, hi))


# ----------------------------------------------------------------------
# B3
# ----------------------------------------------------------------------

# name -> (group widths, strides, value widths, monomials, predicated
# planes, n_groups); a width of 0 is a constant plane (None stack)
B3_CASES = {
    "zero_width_planes": ((2, 0), (3, 1), (5, 0, 32, 3),
                          ((0,), (0, 1), (2,), (0, 3, 1)), (1, 3), 6),
    "six_group_planes": ((1, 1, 2, 1, 1, 3), (8, 4, 2, 1, 1, 5), (9, 17),
                         ((0, 1, 1), (1,), (0, 0, 0)), (), 16),
    "eight_predicates": ((), (), (1, 3, 8, 12, 16, 20, 24, 32),
                         ((0, 1, 2), (3,), (7,), (4, 5), (6, 6, 2)),
                         tuple(range(8)), 1),
}


def _b3_inputs(name):
    gws, strides, vws, monos, preds, n_groups = B3_CASES[name]
    rng = np.random.default_rng(len(name))
    n_seg = len(SEG_ROWS)
    scal = np.zeros((n_seg, grouped_scan.SCAL_COLS), np.uint32)
    scal[:, grouped_scan._SC_COUNT] = SEG_ROWS
    scal[:, grouped_scan._SC_LORIG] = LANES
    gstacks, vstacks, gcodes, vcodes = [], [], [], []
    for j, w in enumerate(gws):
        scal[:, grouped_scan._SC_GMIN + j] = rng.integers(0, 2, n_seg)
        codes = (_group_codes(rng, w, 3) if w else
                 [np.zeros(n, np.uint32) for n in SEG_ROWS])
        gcodes.append(codes)
        gstacks.append(_plane(codes, w) if w else None)
    for p, w in enumerate(vws):
        scal[:, grouped_scan._SC_VMIN + p] = rng.integers(0, 1000, n_seg)
        codes = (_value_codes(rng, w) if w else
                 [np.zeros(n, np.uint32) for n in SEG_ROWS])
        vcodes.append(codes)
        vstacks.append(_plane(codes, w) if w else None)
    for q, p in enumerate(preds):
        top = (1 << max(vws[p], 1)) - 1
        lo, hi = sorted(int(x) for x in rng.integers(0, top, 2, endpoint=True))
        lo = min(lo, top // 4)
        hi = max(hi, 3 * top // 4)
        scal[:, grouped_scan._SC_PRED + 2 * q] = lo
        scal[:, grouped_scan._SC_PRED + 2 * q + 1] = hi
    return gstacks, vstacks, scal, gcodes, vcodes


def _b3_oracle(name, scal, gcodes, vcodes):
    gws, strides, vws, monos, preds, n_groups = B3_CASES[name]
    out = np.zeros((n_groups, len(monos) + 1), np.int64)
    for s, n in enumerate(SEG_ROWS):
        cnt = int(scal[s, grouped_scan._SC_COUNT])
        keep = np.arange(n) < cnt
        for q, p in enumerate(preds):
            lo = int(scal[s, grouped_scan._SC_PRED + 2 * q])
            hi = int(scal[s, grouped_scan._SC_PRED + 2 * q + 1])
            c = vcodes[p][s].astype(np.int64)
            keep &= ((c - lo) & M32) <= ((hi - lo) & M32)
        gid = np.zeros(n, np.int64)
        for j in range(len(gws)):
            gm = int(scal[s, grouped_scan._SC_GMIN + j])
            gid = (gid + ((gcodes[j][s].astype(np.int64) + gm) & M32)
                   * strides[j]) & M32
        keep &= gid < n_groups
        vals = [(vcodes[p][s].astype(np.int64)
                 + int(scal[s, grouped_scan._SC_VMIN + p])) & M32
                for p in range(len(vws))]
        for mi, m in enumerate(monos):
            t = vals[m[0]]
            for p in m[1:]:
                t = (t * vals[p]) & M32
            np.add.at(out[:, mi], gid[keep], t[keep])
        np.add.at(out[:, -1], gid[keep], 1)
    return out


@pytest.mark.parametrize("name", list(B3_CASES))
def test_multi_grouped_scan_matches_pallas(name):
    gws, strides, vws, monos, preds, n_groups = B3_CASES[name]
    gstacks, vstacks, scal, gcodes, vcodes = _b3_inputs(name)
    variants = [scal]
    emptied = scal.copy()  # a segment whose ranges are empty: count 0
    emptied[1, grouped_scan._SC_COUNT] = 0
    emptied[1, grouped_scan._SC_PRED:] = 0
    variants.append(emptied)
    for sc in variants:
        got = grouped_scan.multi_grouped_scan_table(
            [None if s is None else _t(s) for s in gstacks],
            [None if s is None else _t(s) for s in vstacks],
            sc, n_groups, strides, monos, preds)
        ref = pallas_scan.multi_grouped_scan_table(
            [None if s is None else jnp.asarray(s) for s in gstacks],
            [None if s is None else jnp.asarray(s) for s in vstacks],
            sc, n_groups, strides, monos, preds)
        assert got.dtype == np.int64 and got.shape == (n_groups, len(monos) + 1)
        np.testing.assert_array_equal(got, np.asarray(ref))
        np.testing.assert_array_equal(got, _b3_oracle(name, sc, gcodes, vcodes))
        assert got[:, -1].sum() > 0


def test_grouped_scans_reject_bad_shapes():
    w = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        grouped_scan.grouped_scan_table(w, w, [1, 1], [0, 0], [0, 0], 17)
    with pytest.raises(ValueError):
        grouped_scan.grouped_scan_table(w, w[:, :, :3], [1, 1], [0, 0],
                                        [0, 0], 4)
    scal = np.zeros((2, grouped_scan.SCAL_COLS), np.uint32)
    with pytest.raises(ValueError, match="at least one word plane"):
        grouped_scan.multi_grouped_scan_table([None], [None], scal, 2, (1,),
                                              ((0,),), ())
    with pytest.raises(ValueError):  # degree-4 monomial
        grouped_scan.multi_grouped_scan_table([w], [w], scal, 2, (1,),
                                              ((0, 0, 0, 0),), ())
    with pytest.raises(ValueError):  # a predicate on a missing plane
        grouped_scan.multi_grouped_scan_table([w], [w], scal, 2, (1,),
                                              ((0,),), (1,))
