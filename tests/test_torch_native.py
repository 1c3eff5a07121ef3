"""The port's native host library against the JAX package's and against its
own NumPy fallback: the twins of tests/test_native.py.

The port compiles native/adacom_native.cpp for the machine it runs on
(adacom_tpu_torch/build.py); the JAX package loads the committed
native/libadacom_native.so. Each case gives both builds the same seeded
inputs and runs the port's function a third time with its library
switched off (`tools.native_check.fallback()`, the function's NumPy
path): the three answers must be equal, and equal to the reference test's
NumPy golden. `test_native_check_finds_no_difference` runs the tool that
phase 17 of chip_smoke.py runs on the card's host, at a cut size.
Tolerance: every answer is an integer array and must match exactly.

One shared fault is repaired in the port: `packed_filter_eq_u32`'s
library path returns its hits lane by lane, its NumPy path in ascending
order. The port sorts the library's hits, so both paths give
`np.nonzero(...)`; the JAX package's library order is asserted beside."""

import numpy as np
import pytest

from adacom_tpu import native as jnative
from adacom_tpu.ops import bitpack as jbitpack
from adacom_tpu_torch import native as tnative
from adacom_tpu_torch.ops import bitpack as tbitpack
from adacom_tpu_torch.tools import native_check

SEED = 0x5EED

pytestmark = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="a native library is unavailable")


def _three(call):
    """call(native module) on the JAX package's build, the port's build and
    the port's NumPy path."""
    jax_out = call(jnative)
    port_out = call(tnative)
    with native_check.fallback():
        numpy_out = call(tnative)
    return jax_out, port_out, numpy_out


def _equal(outs, want=None):
    for o in outs:
        if isinstance(o, tuple):
            for a, b in zip(o, outs[0]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(o, outs[0])
    if want is not None:
        np.testing.assert_array_equal(outs[0], want)


@pytest.mark.parametrize("width", [1, 7, 16, 17, 31, 32])
def test_native_pack_matches_layout(width):
    rng = np.random.default_rng(SEED)
    n = 10_000
    codes = (rng.integers(0, 1 << 32, n, dtype=np.uint64)
             & ((1 << width) - 1)).astype(np.uint32)
    words = _three(lambda nat: nat.pack_u32(codes, width))
    _equal(words, jbitpack.pack_numpy(codes, width))
    np.testing.assert_array_equal(words[0], tbitpack.pack_numpy(codes, width))
    _equal(_three(lambda nat: nat.unpack_u32(words[0], n, width)), codes)


def test_native_gather():
    rng = np.random.default_rng(SEED)
    n, width = 5000, 19
    codes = rng.integers(0, 1 << width, n, dtype=np.uint32)
    words = tnative.pack_u32(codes, width)
    idx = rng.integers(0, n, 200)
    lanes = tbitpack.lanes_for(n)
    assert lanes == jbitpack.lanes_for(n)
    _equal(_three(lambda nat: nat.gather_u32(words, lanes, width, idx)),
           codes[idx])


def test_native_filters():
    rng = np.random.default_rng(SEED)
    vals = rng.integers(0, 100, 10_000).astype(np.uint32)
    _equal(_three(lambda nat: nat.filter_eq_u32(vals, 42)),
           np.nonzero(vals == 42)[0])


@pytest.mark.parametrize("n", [20_000, 400_000])
def test_native_packed_filter_eq(n):
    """At 20,000 rows the probe has one hit (the reference test's case); at
    400,000 it has more, one of them planted in lane 0 past row 1234."""
    rng = np.random.default_rng(SEED)
    width, base = 17, 1_000_000
    vals = (base + rng.integers(0, 1 << width, n)).astype(np.uint64)
    lanes = tbitpack.lanes_for(n)
    if n > 20_000:
        vals[2 * lanes] = vals[1234]
    words = tnative.pack_u32((vals - base).astype(np.uint32), width)
    v = int(vals[1234])
    want = np.nonzero(vals == v)[0]
    jax_out, port_out, numpy_out = _three(
        lambda nat: nat.packed_filter_eq_u32(words, n, width, base, v))
    np.testing.assert_array_equal(port_out, want)
    np.testing.assert_array_equal(numpy_out, want)
    # the JAX package's library path: the same hits, lane by lane
    np.testing.assert_array_equal(np.sort(jax_out), want)
    np.testing.assert_array_equal(
        jax_out, want[np.lexsort((want // lanes, want % lanes))])
    if n > 20_000:
        assert len(want) > 1 and not np.array_equal(jax_out, want)
    # misses below min_factor and above the span
    for miss in (5, base + (1 << width)):
        assert all(len(o) == 0 for o in _three(
            lambda nat: nat.packed_filter_eq_u32(words, n, width, base,
                                                 miss)))


def test_native_zipf():
    """Both builds draw the same sample (the NumPy path draws from another
    generator by design; tests/test_torch_bench.py holds it against the
    JAX package's NumPy path)."""
    s = tnative.zipf_sample(10_000, 1.0, 7, 20_000)
    np.testing.assert_array_equal(s, jnative.zipf_sample(10_000, 1.0, 7,
                                                         20_000))
    assert s.min() >= 1 and s.max() <= 10_000
    vals, counts = np.unique(s, return_counts=True)
    assert vals[np.argmax(counts)] <= 3


def test_groupby_i64_matches_unique():
    keys = np.random.default_rng(3).integers(-50, 50, 100_000) \
        .astype(np.int64)
    outs = _three(lambda nat: nat.groupby_i64(keys))
    _equal(outs)
    gid, first = outs[1]
    assert len(first) == len(np.unique(keys))
    assert (keys[first][gid] == keys).all()  # each gid maps to its key
    assert (np.sort(first) == first).all()  # first-occurrence order


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_group_sum_exact(dtype):
    gid = np.random.default_rng(4).integers(0, 7, 50_000).astype(np.int64)
    vals = np.random.default_rng(5).integers(-2**40, 2**40, 50_000)
    if dtype == "float64":
        # quarters below 2^18: every partial sum is exact in any order
        vals = (vals >> 20) / 4.0
    _equal(_three(lambda nat: nat.group_sum(gid, vals, 7)),
           np.asarray([vals[gid == g].sum() for g in range(7)]))


def test_argsort_u64_radix():
    keys = np.random.default_rng(6).integers(0, 2**63, 200_000) \
        .astype(np.uint64)
    outs = _three(lambda nat: nat.argsort_u64(keys))
    _equal(outs, np.argsort(keys, kind="stable"))
    assert (np.diff(keys[outs[1]].astype(np.int64)) >= 0).all()
    # stability: equal keys keep their row order
    keys2 = (np.arange(100_000) % 17).astype(np.uint64)
    outs = _three(lambda nat: nat.argsort_u64(keys2))
    _equal(outs, np.argsort(keys2, kind="stable"))


def test_hash_join_range_filters_gather_rows():
    """The functions whose callers fall back themselves: both builds equal,
    and equal to the NumPy expression the callers use."""
    rng = np.random.default_rng(SEED)
    build = rng.integers(0, 5000, 3000).astype(np.int64)
    probe = rng.integers(0, 5000, 20_000).astype(np.int64)
    pairs = [native_check._pairs(*nat.hash_join_i64(build, probe))
             for nat in (jnative, tnative)]
    _equal(pairs, native_check._pairs(*native_check._np_join(build, probe)))
    v64 = rng.integers(-1 << 40, 1 << 40, 50_000).astype(np.int64)
    v32 = rng.integers(-1 << 30, 1 << 30, 50_000).astype(np.int32)
    _equal([nat.filter_range_i64(v64, -1 << 38, 1 << 39)
            for nat in (jnative, tnative)],
           np.nonzero((v64 >= -1 << 38) & (v64 <= 1 << 39))[0])
    _equal([nat.filter_range_i32(v32, -1 << 28, 1 << 29)
            for nat in (jnative, tnative)],
           np.nonzero((v32 >= -1 << 28) & (v32 <= 1 << 29))[0])
    idx = rng.integers(0, 50_000, 70_000)
    for src in (v64, v32, (v32 & 0x7F).astype(np.uint8)):
        _equal([nat.gather_rows(src, idx) for nat in (jnative, tnative)],
               src[idx])
    with native_check.fallback():
        assert tnative.hash_join_i64(build, probe) is None
        assert tnative.filter_range_i64(v64, 0, 1) is None
        assert tnative.gather_rows(v64, idx) is None


def test_native_check_finds_no_difference():
    """The port alone: the tool holds the port's build against the port's
    NumPy path (the JAX package has no such tool); phase 17 runs it on the
    card's host."""
    res = native_check.compare(100_000, seed=3)
    assert res["failures"] == []
    assert res["comparisons"] == 29
    assert res["library"] == tnative._SO_PATH
