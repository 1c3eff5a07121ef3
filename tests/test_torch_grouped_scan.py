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
    return _multi_oracle(SEG_ROWS, scal, gcodes, vcodes, strides, monos,
                         preds, n_groups)


def _multi_oracle(seg_rows, scal, gcodes, vcodes, strides, monos, preds,
                  n_groups):
    """numpy B3 over per-segment code arrays (gcodes[j][s], vcodes[p][s])."""
    out = np.zeros((n_groups, len(monos) + 1), np.int64)
    for s, n in enumerate(seg_rows):
        cnt = int(scal[s, grouped_scan._SC_COUNT])
        keep = np.arange(n) < cnt
        for q, p in enumerate(preds):
            lo = int(scal[s, grouped_scan._SC_PRED + 2 * q])
            hi = int(scal[s, grouped_scan._SC_PRED + 2 * q + 1])
            c = vcodes[p][s].astype(np.int64)
            keep &= ((c - lo) & M32) <= ((hi - lo) & M32)
        gid = np.zeros(n, np.int64)
        for j in range(len(gcodes)):
            gm = int(scal[s, grouped_scan._SC_GMIN + j])
            gid = (gid + ((gcodes[j][s].astype(np.int64) + gm) & M32)
                   * strides[j]) & M32
        keep &= gid < n_groups
        vals = [(vcodes[p][s].astype(np.int64)
                 + int(scal[s, grouped_scan._SC_VMIN + p])) & M32
                for p in range(len(vcodes))]
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


# ----------------------------------------------------------------------
# launch choices and the extremes of the kernel's accumulation
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n_groups,n_out,threads,mode", [
    (6, 7, 128, "private"),     # TPC-H Q1: 42 KB of slots
    (12, 2, 128, "private"),    # B2 GROUP BY over 12 groups
    (1, 2, 128, "private"),     # TPC-H Q6, ungrouped
    (16, 3, 128, "private"),    # exactly PRIVATE_BYTES
    (16, 4, 128, "warp"),
    (16, 33, 128, "warp"),      # the largest shape the kernel takes
    (6, 7, 256, "warp"),        # the budget is per block
])
def test_accumulator_mode(n_groups, n_out, threads, mode):
    assert grouped_scan.accumulator_mode(n_groups, n_out, threads) == mode


@pytest.mark.parametrize("n_readers,cls", [
    (1, 2), (2, 2), (3, 4), (4, 4), (5, 8), (7, 8), (8, 8), (9, 14), (14, 14)])
def test_reader_class(n_readers, cls):
    assert grouped_scan.reader_class(n_readers) == cls


def test_reader_class_rejects_too_many_planes():
    with pytest.raises(ValueError):
        grouped_scan.reader_class(15)


@pytest.mark.parametrize("n_seg,n_lanes,threads,resident,want", [
    (916, 2048, 128, 1320, 1320),  # Q1: 14,656 pieces, ~11 a block
    (1, 2048, 128, 1000, 16),      # one segment: a block a piece
    (3, 157, 128, 5, 5),           # 6 pieces: lanes not a multiple of a tile
    (1, 1, 128, 1056, 1),
])
def test_launch_blocks(n_seg, n_lanes, threads, resident, want):
    assert grouped_scan.launch_blocks(n_seg, n_lanes, threads, resident) == want


FULL_ROWS = [32 * 2048]  # one segment, every row of every lane kept


def _stack(codes_per_seg, width):
    L = max(bitpack.lanes_for(len(c)) for c in codes_per_seg)
    out = np.zeros((len(codes_per_seg), width, L), np.uint32)
    for s, codes in enumerate(codes_per_seg):
        out[s, :, :bitpack.lanes_for(len(codes))] = \
            bitpack.pack_numpy(codes, width)
    return out


def test_grouped_scan_one_group_maximal_codes():
    """32 x 2048 kept rows, all in group 5, every value code 0xFFFFFFFF:
    the per-group sums carry far past 2^32."""
    n = FULL_ROWS[0]
    g = _stack([np.full(n, 5, np.uint32)], 3)
    v = _stack([np.full(n, M32, np.uint32)], 32)
    lanes = [bitpack.lanes_for(n)]
    for vmins in ([0], [-(1 << 31)]):
        got = grouped_scan.grouped_scan_table(_t(g), _t(v), FULL_ROWS, [0],
                                              vmins, 16, lanes=lanes)
        ref = pallas_scan.grouped_scan_table(
            jnp.asarray(g), jnp.asarray(v), FULL_ROWS, [0], vmins, 16,
            lanes=lanes)
        want = np.zeros((16, 2), np.int64)
        want[5] = (n * (M32 + vmins[0]), n)
        np.testing.assert_array_equal(got, np.asarray(ref))
        np.testing.assert_array_equal(got, want)


def _full_scal(seg_rows, n_gp, n_vp):
    scal = np.zeros((len(seg_rows), grouped_scan.SCAL_COLS), np.uint32)
    scal[:, grouped_scan._SC_COUNT] = seg_rows
    scal[:, grouped_scan._SC_LORIG] = [bitpack.lanes_for(n) for n in seg_rows]
    return scal


def test_multi_grouped_scan_one_group_maximal_terms():
    """32 x 2048 kept rows of one group, three value planes at 0xFFFFFFFF:
    monomials of degree 1..3 at their largest, sums far past 2^32."""
    n = FULL_ROWS[0]
    gcodes = [[np.full(n, 1, np.uint32)]]
    vcodes = [[np.full(n, M32, np.uint32)] for _ in range(3)]
    monos = ((0,), (0, 1), (0, 1, 2), (2,))
    scal = _full_scal(FULL_ROWS, 1, 3)
    scal[:, grouped_scan._SC_GMIN] = 2          # group id 1 + 2 = 3
    gst = [_stack(c, 2) for c in gcodes]
    vst = [_stack(c, 32) for c in vcodes]
    args = (scal, 4, (1,), monos, ())
    got = grouped_scan.multi_grouped_scan_table(
        [_t(s) for s in gst], [_t(s) for s in vst], *args)
    ref = pallas_scan.multi_grouped_scan_table(
        [jnp.asarray(s) for s in gst], [jnp.asarray(s) for s in vst], *args)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(
        got, _multi_oracle(FULL_ROWS, scal, gcodes, vcodes, (1,), monos, (),
                           4))
    assert got[3, 0] == n * M32 and got[3, -1] == n


def _sixteen_group_inputs():
    """Group ids 0..15 spread across every warp (row i in group i % 16 of
    one plane, the other plane constant), eight value planes."""
    seg_rows = [2048, 1500]
    rng = np.random.default_rng(16)
    gcodes = [[(np.arange(n) % 16).astype(np.uint32) for n in seg_rows],
              [np.zeros(n, np.uint32) for n in seg_rows]]
    vws = (32, 1, 5, 13, 20, 32, 7, 3)
    vcodes = [[rng.integers(0, 1 << w, n, dtype=np.uint64).astype(np.uint32)
               for n in seg_rows] for w in vws]
    scal = _full_scal(seg_rows, 2, 8)
    scal[:, grouped_scan._SC_VMIN + 2] = 999
    scal[:, grouped_scan._SC_PRED] = 0                  # plane 3, 13 bits:
    scal[:, grouped_scan._SC_PRED + 1] = (1 << 13) - 1  # keeps every row
    scal[:, grouped_scan._SC_PRED + 2] = 3              # plane 2: codes
    scal[:, grouped_scan._SC_PRED + 3] = 27             # 3..27 of 0..31
    gst = [_stack(gcodes[0], 4), _stack(gcodes[1], 1)]
    vst = [_stack(c, w) for c, w in zip(vcodes, vws)]
    return seg_rows, gcodes, vcodes, scal, gst, vst


def test_multi_grouped_scan_sixteen_groups_32_monomials():
    """16 groups x 32 monomials (33 outputs): the kernel's warp-aggregated
    mode. The Pallas kernel refuses this shape (its VMEM budget), so the
    plain version is held against numpy here, and against Pallas at the
    widest shape Pallas takes (16 groups x 9 monomials)."""
    seg_rows, gcodes, vcodes, scal, gst, vst = _sixteen_group_inputs()
    rng = np.random.default_rng(32)
    monos = tuple(tuple(int(p) for p in rng.integers(0, 8, 1 + k % 3))
                  for k in range(32))
    strides, preds = (1, 4), (3, 2)
    assert grouped_scan.accumulator_mode(16, 33, 128) == "warp"
    got = grouped_scan.multi_grouped_scan_table(
        [_t(s) for s in gst], [_t(s) for s in vst], scal, 16, strides,
        monos, preds)
    want = _multi_oracle(seg_rows, scal, gcodes, vcodes, strides, monos,
                         preds, 16)
    np.testing.assert_array_equal(got, want)
    assert (got[:, -1] > 0).all()
    with pytest.raises(ValueError, match="VMEM"):
        pallas_scan.multi_grouped_scan_table(
            [jnp.asarray(s) for s in gst], [jnp.asarray(s) for s in vst],
            scal, 16, strides, monos, preds)
    got = grouped_scan.multi_grouped_scan_table(
        [_t(s) for s in gst], [_t(s) for s in vst], scal, 16, strides,
        monos[:9], preds)
    ref = pallas_scan.multi_grouped_scan_table(
        [jnp.asarray(s) for s in gst], [jnp.asarray(s) for s in vst],
        scal, 16, strides, monos[:9], preds)
    np.testing.assert_array_equal(got, np.asarray(ref))
