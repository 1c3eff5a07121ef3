"""Port segment codec (adacom_tpu_torch.ops.segcodec) against the JAX
package's: widths, min_factor and words equal for u32, i32, i64 and u64,
constant planes included; state converts between the packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adacom_tpu import types as jtt
from adacom_tpu.ops import segcodec as jsc
from adacom_tpu_torch import types as ttt
from adacom_tpu_torch.ops import segcodec as tsc

CPU = torch.device("cpu")


def _cases():
    rng = np.random.default_rng(0x5C)
    n = 3000  # ragged: not a multiple of 32 lanes
    return [
        ("UINTEGER", (7 + rng.integers(0, 1 << 20, n)).astype(np.uint32)),
        ("UINTEGER", rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)),
        ("INTEGER", rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)),
        ("INTEGER", np.full(n, -12345, np.int32)),                       # constant
        ("BIGINT", (-(1 << 40) + rng.integers(0, 1 << 45, n)).astype(np.int64)),
        ("BIGINT", np.full(n, 1 << 50, np.int64)),                       # constant
        ("BIGINT", rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)),
        ("UBIGINT", ((1 << 63) + rng.integers(0, 1 << 36, n, dtype=np.uint64)).astype(np.uint64)),
        ("UBIGINT", rng.integers(0, 1 << 64, n, dtype=np.uint64)),
    ]


CASES = _cases()


def _jax_pack(vals, tname, **kw):
    with jax.disable_jit():
        return jsc.pack_segment(jnp.asarray(vals), getattr(jtt, tname), **kw)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("prefix", [True, False])
def test_pack_segment_matches_reference(case, prefix):
    tname, vals = CASES[case]
    jp = _jax_pack(vals, tname, extract_prefix=prefix)
    tp = tsc.pack_segment(torch.from_numpy(vals), getattr(ttt, tname),
                          extract_prefix=prefix)
    assert tp.widths == jp.widths
    assert tp.min_factor == jp.min_factor
    assert (tp.count, tp.n_lanes) == (jp.count, jp.n_lanes)
    assert tp.dtype == np.dtype(jp.dtype)
    assert tp.nbytes == jp.nbytes
    for tw, jw in zip(tp.words, jp.words):
        assert (tw is None) == (jw is None)
        if tw is not None:
            np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    # decode and random access give the values back
    np.testing.assert_array_equal(tsc.unpack_segment(tp).numpy(), vals)
    idx = np.random.default_rng(case).integers(0, len(vals), 97)
    np.testing.assert_array_equal(
        tsc.gather_segment(tp, torch.from_numpy(idx)).numpy(), vals[idx])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_packed_from_numpy_round_trips(case):
    tname, vals = CASES[case]
    jp = _jax_pack(vals, tname)
    # JAX state -> port: decodes to the same values
    tp = tsc.packed_from_numpy(
        [None if w is None else np.asarray(w) for w in jp.words], jp.widths,
        jp.min_factor, jp.count, jp.n_lanes, jp.dtype, CPU)
    np.testing.assert_array_equal(tsc.unpack_segment(tp).numpy(), vals)
    # port state -> JAX: the port's words decode in the JAX package
    own = tsc.pack_segment(torch.from_numpy(vals), getattr(ttt, tname))
    back = jsc.PackedData(
        words=tuple(None if w is None else jnp.asarray(w.numpy().view(np.uint32))
                    for w in own.words),
        widths=own.widths, min_factor=own.min_factor, count=own.count,
        n_lanes=own.n_lanes, dtype=own.dtype)
    with jax.disable_jit():
        np.testing.assert_array_equal(np.asarray(jsc.unpack_segment(back)), vals)


def test_plan_widths_matches_reference():
    for vmin, vmax, isz in [(0, 0, 4), (5, 6, 4), (-3, 1 << 31, 4),
                            (0, (1 << 32) - 1, 4), (0, 1 << 40, 8),
                            (-(1 << 63), (1 << 63) - 1, 8), (7, 7, 8)]:
        for prefix in (True, False):
            for padded in (True, False):
                kw = dict(extract_prefix=prefix, padded_to_byte=padded)
                assert tsc.plan_widths(vmin, vmax, isz, **kw) == \
                    jsc.plan_widths(vmin, vmax, isz, **kw)
