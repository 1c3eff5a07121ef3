"""Port table scan (adacom_tpu_torch.ops.fused_scan) against the JAX
package's Pallas kernel B1 (adacom_tpu.ops.pallas_scan.scan_table, run in
interpret mode on the CPU as the JAX package's own tests run it).

On the CPU the port's scan_table runs its plain PyTorch version; the CUDA
kernel is held against that plain version on the card by chip_smoke.py.
Results are integers and must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adacom_tpu import types as _jtt  # noqa: F401  (enables jax x64)
from adacom_tpu.ops import pallas_scan
from adacom_tpu_torch.ops import bitpack, fused_scan


@pytest.fixture(scope="module", autouse=True)
def _cold_pallas_runner_caches():
    """tests/test_pallas.py counts its Pallas runner caches' misses: leave
    them cold for the modules that run after this one in the process."""
    yield
    from adacom_tpu.ops import pallas_scan

    for f in vars(pallas_scan).values():
        if hasattr(f, "cache_clear") and \
                getattr(f, "__module__", None) == pallas_scan.__name__:
            f.cache_clear()


SEG_ROWS = [4096, 4096, 1500]      # ragged tail segment: fewer lanes
MINS = [-4000, 123, -(1 << 31)]    # signed frame-of-reference minima


def _inputs(width, seed, with_valid):
    """Stacked (n_seg, width, L) packed words + counts/mins/lanes (+ a
    validity plane): random codes of `width` bits per segment."""
    rng = np.random.default_rng(seed)
    L = bitpack.lanes_for(max(SEG_ROWS))
    words = np.zeros((len(SEG_ROWS), width, L), np.uint32)
    valids = np.full((len(SEG_ROWS), 1, L), 0xFFFFFFFF, np.uint32)
    lanes = []
    codes_all = []
    valid_all = []
    for s, n in enumerate(SEG_ROWS):
        codes = (rng.integers(0, 1 << 32, n, dtype=np.uint64)
                 & ((1 << width) - 1)).astype(np.uint32)
        ln = bitpack.lanes_for(n)
        lanes.append(ln)
        words[s, :, :ln] = bitpack.pack_numpy(codes, width)
        v = rng.random(n) > 0.2 if with_valid else np.ones(n, bool)
        if with_valid and s == 1:
            v[:] = True  # a fully-valid segment inside a NULL-carrying stack
        valids[s, :, :ln] = bitpack.pack_numpy(v.astype(np.uint32), 1)
        codes_all.append(codes)
        valid_all.append(v)
    return words, valids if with_valid else None, lanes, codes_all, valid_all


def _oracle(codes_all, valid_all, lo, hi):
    vals = np.concatenate([c.astype(np.int64) + m for c, m in zip(codes_all, MINS)])
    keep = np.concatenate(valid_all)
    if lo is not None:
        keep &= vals >= lo
    if hi is not None:
        keep &= vals <= hi
    sel = vals[keep]
    return int(sel.sum()), int(keep.sum()), sel


def _port(words, valids, lanes, lo, hi, minmax):
    return fused_scan.scan_table(
        torch.from_numpy(words.view(np.int32)), SEG_ROWS, MINS, lo, hi,
        lanes=lanes, minmax=minmax,
        valids=None if valids is None else torch.from_numpy(valids.view(np.int32)))


def _ranges(width):
    top = (1 << width) - 1
    return [
        (-3000, 123 + top // 2),          # cuts through every segment
        (10**12, 10**13),                 # empty for every segment
        (-(1 << 31) + top // 3, -3500),   # empty for some segments only
    ]


VARIANTS = {  # name -> (predicate, minmax, validity plane)
    "plain": (False, False, False),
    "pred": (True, False, False),
    "minmax": (False, True, False),
    "valid": (False, False, True),
    "all": (True, True, True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("width", [1, 13, 32])
def test_scan_table_matches_pallas(width, variant):
    pred, minmax, with_valid = VARIANTS[variant]
    words, valids, lanes, codes_all, valid_all = _inputs(width, width, with_valid)
    for lo, hi in (_ranges(width) if pred else [(None, None)]):
        got = _port(words, valids, lanes, lo, hi, minmax)
        ref = pallas_scan.scan_table(
            jnp.asarray(words), SEG_ROWS, MINS, lo, hi, lanes=lanes,
            minmax=minmax, valids=None if valids is None else jnp.asarray(valids))
        assert tuple(got) == tuple(int(x) for x in ref)
        s, c, sel = _oracle(codes_all, valid_all, lo, hi)
        assert got[:2] == (s, c)
        if minmax and c:
            assert got[2:] == (int(sel.min()), int(sel.max()))


@pytest.mark.parametrize("width", range(1, 33))
def test_scan_table_every_width(width):
    """Every width, every feature on, against a numpy oracle (the Pallas
    comparison above covers the widths that change the unpack shape)."""
    words, valids, lanes, codes_all, valid_all = _inputs(width, 100 + width, True)
    for lo, hi in _ranges(width) + [(None, None)]:
        s, c, mn, mx = _port(words, valids, lanes, lo, hi, True)
        rs, rc, sel = _oracle(codes_all, valid_all, lo, hi)
        assert (s, c) == (rs, rc)
        if c:
            assert (mn, mx) == (int(sel.min()), int(sel.max()))
        else:
            assert (mn, mx) == (np.iinfo(np.int64).max, np.iinfo(np.int64).min)


def test_scan_table_rejects_bad_shapes():
    w = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_scan.scan_table(w[0], [1], [0])
    with pytest.raises(ValueError):
        fused_scan.scan_table(w, [1, 1], [0, 0], valids=torch.zeros((2, 1, 5), dtype=torch.int32))
