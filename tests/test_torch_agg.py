"""The port's aggregation and selection ops (adacom_tpu_torch.ops.agg,
ops.select) against the JAX package's, on the CPU, from the same seeded
numpy inputs. grouped_partial runs at domains 5 and 200 on both sides of the
JAX package's one-hot limit (128) and at 5,000; the port has one scatter
form for all. Tolerance: 0 for integers and float min/max, 1e-12 relative
for float sums (the summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adacom_tpu import types as _jtt  # noqa: F401  (turns on x64 in JAX)
from adacom_tpu.ops import agg as jagg
from adacom_tpu.ops import select as jselect
from adacom_tpu_torch.ops import agg, select

N = 20_000


def _inputs(domain, acc, seed):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, domain, N).astype(np.int32)
    mask = rng.random(N) > 0.3
    if np.dtype(acc).kind == "f":
        vals = rng.standard_normal(N) * 1e6
    else:
        vals = rng.integers(-(1 << 40), 1 << 40, N)
    return gid, mask, vals


def _check(got, want, acc, kind):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.dtype(acc).kind == "f" and kind in ("sum", "sumsq"):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("domain", [5, 200, 5000])
@pytest.mark.parametrize("acc", [np.int64, np.float64])
@pytest.mark.parametrize("masked", [True, False])
def test_grouped_partial_matches_reference(domain, acc, masked):
    gid, mask, vals = _inputs(domain, acc, seed=domain)
    kinds = ["count", "sum", "sumsq", "min", "max"]
    if np.dtype(acc).kind != "f":
        vals = vals % (1 << 20)  # sumsq stays inside int64
    specs_j = [(k, None if k == "count" else jnp.asarray(vals), acc)
               for k in kinds]
    specs_t = [(k, None if k == "count" else torch.from_numpy(vals), acc)
               for k in kinds]
    mj = jnp.asarray(mask) if masked else None
    mt = torch.from_numpy(mask) if masked else None
    want = jagg.grouped_partial(jnp.asarray(gid), mj, specs_j, domain)
    got = agg.grouped_partial(torch.from_numpy(gid).to(torch.int64), mt,
                              specs_t, domain)
    for k, g, w in zip(kinds, got, want):
        _check(g.numpy(), w, acc, k)


@pytest.mark.parametrize("acc", [np.int64, np.float64])
def test_masked_reductions_match_reference(acc):
    _gid, mask, vals = _inputs(7, acc, seed=3)
    vj, mj = jnp.asarray(vals), jnp.asarray(mask)
    vt, mt = torch.from_numpy(vals), torch.from_numpy(mask)
    _check(agg.masked_sum(vt, mt, acc).numpy(),
           jagg.masked_sum(vj, mj, acc), acc, "sum")
    assert int(agg.masked_count(mt, N)) == int(jagg.masked_count(mj, N))
    assert int(agg.masked_count(None, N)) == int(jagg.masked_count(None, N))
    hi, lo = agg._max_sentinel(acc), agg._min_sentinel(acc)
    _check(agg.masked_min(vt, mt, acc, hi).numpy(),
           jagg.masked_min(vj, mj, acc, hi), acc, "min")
    _check(agg.masked_max(vt, mt, acc, lo).numpy(),
           jagg.masked_max(vj, mj, acc, lo), acc, "max")
    # cast points: int32 values reach the accumulator before the reduce
    v32 = (vals % 1000).astype(np.int32) if np.dtype(acc).kind != "f" \
        else vals.astype(np.float32)
    _check(agg.masked_sum(torch.from_numpy(v32), mt, acc).numpy(),
           jagg.masked_sum(jnp.asarray(v32), mj, acc), acc, "sum")


def test_dense_group_ids_match_reference():
    rng = np.random.default_rng(9)
    a = rng.integers(-3, 9, N).astype(np.int32)
    c = rng.integers(100, 140, N).astype(np.int64)
    mins, strides, domain = [-3, 100], [40, 1], 12 * 40
    want = jagg.dense_group_ids([jnp.asarray(a), jnp.asarray(c)], mins,
                                strides, domain)
    got = agg.dense_group_ids([torch.from_numpy(a), torch.from_numpy(c)],
                              mins, strides, domain)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["count", "sum", "sumsq", "min", "max"])
def test_merge_partials_matches_reference(kind):
    rng = np.random.default_rng(4)
    x, y = rng.integers(-99, 99, 50), rng.integers(-99, 99, 50)
    got = agg.merge_partials(kind, torch.from_numpy(x), torch.from_numpy(y))
    want = jagg.merge_partials(kind, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_matches_reference():
    rng = np.random.default_rng(5)
    mask = rng.random(3000) > 0.6
    a = rng.integers(0, 1 << 30, 3000)
    count, (out,) = select.compact(torch.from_numpy(mask),
                                   [torch.from_numpy(a)])
    jcount, (jout,) = jselect.compact(jnp.asarray(mask), jnp.asarray(a))
    assert count == int(jcount)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout)[:count])
    counts = torch.tensor([0, 17, 64])
    got = select.tail_mask(64, counts)
    for row, c in zip(got, counts.tolist()):
        np.testing.assert_array_equal(row.numpy(),
                                      np.asarray(jselect.tail_mask(64, c)))
