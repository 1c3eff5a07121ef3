"""The port's multi-device layer (adacom_tpu_torch.parallel) against the JAX
package's on its 8-device virtual CPU mesh: the same numpy inputs, from a
seed, through adacom_tpu.parallel.ops on jax's mesh and through
adacom_tpu_torch.parallel.ops on make_virtual_mesh(8, "cpu"). Hashes,
destinations, repartition bins, validity and overflow counts, group-by
sums, join outputs, top-k values and row ids and scan-aggregate results
are exact (all integer). Where the JAX package misses a pair (a build key
of int64 max), the port is held against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adacom_tpu import types as jtt
from adacom_tpu.ops import bitpack as jbitpack
from adacom_tpu.ops import segcodec as jsegcodec
from adacom_tpu.parallel import mesh as jmesh
from adacom_tpu.parallel import ops as jops
from adacom_tpu_torch import types as tt
from adacom_tpu_torch.ops import bitpack, segcodec
from adacom_tpu_torch.parallel import collectives as coll
from adacom_tpu_torch.parallel import mesh as pmesh
from adacom_tpu_torch.parallel import ops as pops

pytestmark = pytest.mark.mesh

N_DEV = 8
I64 = np.iinfo(np.int64)


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


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < N_DEV:
        pytest.skip("needs 8 devices")
    return jmesh.make_mesh(N_DEV), pmesh.make_virtual_mesh(N_DEV, "cpu")


def _j(jm, a):
    return jmesh.shard_leading(jm, jnp.asarray(a))


def _t(tm, a):
    return pmesh.shard_leading(tm, torch.from_numpy(np.ascontiguousarray(a)))


def _cat(shards):
    return pmesh.gather_leading(shards).numpy()


EDGE_KEYS = np.array([0, 1, -1, 2, -2, 7, 8, 1 << 31, -(1 << 31),
                      (1 << 32) - 1, 1 << 32, I64.max, I64.min,
                      I64.max - 1, I64.min + 1, 0x5EED, -0x5EED],
                     dtype=np.int64)


# ----------------------------------------------------------------------
# the mesh and the collectives
# ----------------------------------------------------------------------

def test_mesh_construction_and_sharding():
    m = pmesh.make_virtual_mesh(4, "cpu")
    assert m.size == 4 and m.shape == {"d": 4} and m.virtual
    assert m.devices == (torch.device("cpu"),) * 4
    assert pmesh.make_mesh(1, "cpu").size == 1
    with pytest.raises(ValueError, match="need 2 devices"):
        pmesh.make_mesh(2, "cpu")
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="need 4 devices"):
            pmesh.make_mesh(4, "cuda")
    t = torch.arange(12).reshape(6, 2)
    parts = pmesh.shard_leading(pmesh.make_virtual_mesh(3, "cpu"), t)
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                           [[8, 9], [10, 11]]]
    assert torch.equal(pmesh.gather_leading(parts), t)
    with pytest.raises(ValueError, match="not a multiple"):
        pmesh.shard_leading(m, torch.arange(6))
    assert pmesh.pad_to_multiple(9, 4) == 12
    assert [r.tolist() for r in pmesh.replicate(m, torch.arange(2))] == \
        [[0, 1]] * 4


def test_collectives():
    xs = [torch.arange(8) + 100 * s for s in range(4)]
    out = coll.all_to_all(xs, 0, 0)
    for d in range(4):
        assert out[d].tolist() == sum(
            (xs[s][2 * d:2 * d + 2].tolist() for s in range(4)), [])
    total = sum(int(x.sum()) for x in xs)
    assert [int(o) for o in coll.psum([x.sum() for x in xs])] == [total] * 4
    assert coll.pmin(xs)[2].tolist() == xs[0].tolist()
    assert coll.pmax(xs)[0].tolist() == xs[3].tolist()
    g = coll.all_gather(xs)
    assert g[1].shape == (4, 8) and g[1][3].tolist() == xs[3].tolist()
    m = pmesh.make_virtual_mesh(4, "cpu")
    outs = coll.shard_map(m, lambda i, a, r: (i, a.sum() + r), [xs], [1])
    assert [o[0] for o in outs] == [0, 1, 2, 3]
    assert [int(o[1]) for o in outs] == [int(x.sum()) + 1 for x in xs]


# ----------------------------------------------------------------------
# hashing and repartition
# ----------------------------------------------------------------------

def test_hash64_and_destinations_bit_exact(rng):
    keys = np.concatenate([EDGE_KEYS,
                           rng.integers(I64.min, I64.max, 4000, np.int64)])
    want = np.asarray(jops._hash64(jnp.asarray(keys)))
    got = pops._hash64(torch.from_numpy(keys)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    for n in (1, 2, 3, 4, 5, 7, 8, 12):
        d = pops._dest(torch.from_numpy(want.view(np.int64).copy()), n).numpy()
        np.testing.assert_array_equal(d, (want % np.uint64(n)).astype(np.int64))
    dest = np.asarray([3, 0, 3, 8, 3, 1, 0, 8], np.int64)
    np.testing.assert_array_equal(
        pops._rank_within(torch.from_numpy(dest), 9).numpy(),
        np.asarray(jops._rank_within(jnp.asarray(dest, jnp.int32), 9, 8)))


@pytest.mark.parametrize("case", ["uniform", "skewed"])
def test_hash_repartition_same_bins(meshes, rng, case):
    jm, tm = meshes
    n = N_DEV * 256
    if case == "uniform":
        keys = rng.integers(0, 1 << 30, n).astype(np.int64)
        keys[:len(EDGE_KEYS)] = EDGE_KEYS
        capacity = 128
    else:
        # one key on 70% of the rows overflows its destination's bins
        keys = np.where(rng.random(n) < 0.7, 42,
                        rng.integers(-1000, 1000, n)).astype(np.int64)
        capacity = 64
    vals = rng.integers(I64.min, I64.max, n, np.int64)
    valid = np.ones(n, dtype=bool)
    valid[::17] = False
    j_k, j_v, j_ovf, j_p = jops.make_hash_repartition(
        jm, capacity, n_payloads=1)(_j(jm, keys), _j(jm, valid), _j(jm, vals))
    t_k, t_v, t_ovf, t_p = pops.make_hash_repartition(
        tm, capacity, n_payloads=1)(_t(tm, keys), _t(tm, valid), _t(tm, vals))
    np.testing.assert_array_equal(_cat(t_k), np.asarray(j_k))
    np.testing.assert_array_equal(_cat(t_v), np.asarray(j_v))
    np.testing.assert_array_equal(_cat(t_p), np.asarray(j_p))
    np.testing.assert_array_equal(t_ovf.numpy(), np.asarray(j_ovf))
    assert (int(t_ovf.sum()) > 0) == (case == "skewed")
    # every kept row sits on the shard its key hashes to
    k = _cat(t_k).reshape(N_DEV, N_DEV, capacity)
    v = _cat(t_v).reshape(N_DEV, N_DEV, capacity)
    h = pops._hash64(torch.from_numpy(k[v])).numpy().view(np.uint64)
    np.testing.assert_array_equal(
        (h % np.uint64(N_DEV)).astype(np.int64),
        np.nonzero(v)[0])
    assert int(v.sum()) + int(t_ovf.sum()) == int(valid.sum())


def test_groupby_sum_and_preagg(meshes, rng):
    jm, tm = meshes
    n = N_DEV * 512
    domain = 64
    keys = rng.integers(0, domain, n).astype(np.int64)
    vals = rng.integers(-1000, 1000, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    exp_s = np.zeros(domain, np.int64)
    exp_c = np.zeros(domain, np.int64)
    np.add.at(exp_s, keys[valid], vals[valid])
    np.add.at(exp_c, keys[valid], 1)
    for cap in (n, 64):  # 64 slots per destination drop rows silently
        js, jc = jops.make_distributed_groupby_sum(jm, cap, domain)(
            _j(jm, keys), _j(jm, valid), _j(jm, vals))
        ts, tc = pops.make_distributed_groupby_sum(tm, cap, domain)(
            _t(tm, keys), _t(tm, valid), _t(tm, vals))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        if cap == n:
            np.testing.assert_array_equal(ts.numpy(), exp_s)
            np.testing.assert_array_equal(tc.numpy(), exp_c)
    # the combiner under a 95%-hot key, with float values
    hot = np.where(rng.random(n) < 0.95, 3, keys).astype(np.int64)
    fvals = rng.random(n) * 100
    js, jc = jops.make_distributed_groupby_preagg(jm, domain)(
        _j(jm, hot), _j(jm, valid), _j(jm, fvals))
    ts, tc = pops.make_distributed_groupby_preagg(tm, domain)(
        _t(tm, hot), _t(tm, valid), _t(tm, fvals))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-12)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ----------------------------------------------------------------------
# joins
# ----------------------------------------------------------------------

def _join_inputs(rng, nb=512, npr=2048):
    build = rng.permutation(np.arange(-nb // 2, nb // 2)).astype(np.int64)
    probe = rng.integers(-nb, nb, npr).astype(np.int64)
    bvalid = rng.random(nb) > 0.05
    pvalid = rng.random(npr) > 0.05
    return build, bvalid, probe, pvalid


def test_distributed_join_same_as_jax(meshes, rng):
    jm, tm = meshes
    bk, bv, pk, pv = _join_inputs(rng)
    bx = bk * 3 + 1
    px = np.arange(len(pk), dtype=np.int64)
    args = (bk, bv, bx, pk, pv, px)
    j_out = jops.make_distributed_join(jm, 2048)(*(_j(jm, a) for a in args))
    t_out = pops.make_distributed_join(tm, 2048)(*(_t(tm, a) for a in args))
    for t, j in zip(t_out, j_out):
        np.testing.assert_array_equal(_cat(t), np.asarray(j))
    m = _cat(t_out[0])
    live = {int(k) for k in bk[bv]}
    assert int(m.sum()) == sum(1 for k, ok in zip(pk, pv) if ok and k in live)
    np.testing.assert_array_equal(_cat(t_out[1])[m], _cat(t_out[3])[m] * 3 + 1)


@pytest.mark.parametrize("capacity", [1024, 40])
def test_distributed_join_rowids_same_as_jax(meshes, rng, capacity):
    jm, tm = meshes
    bk, bv, pk, pv = _join_inputs(rng)
    br = np.arange(len(bk), dtype=np.int64)
    pr = np.arange(len(pk), dtype=np.int64)
    args = (bk, bv, br, pk, pv, pr)
    jmat, jb, jp, jo = jops.make_distributed_join_rowids(jm, capacity)(
        *(_j(jm, a) for a in args))
    tmat, tb, tp, to = pops.make_distributed_join_rowids(tm, capacity)(
        *(_t(tm, a) for a in args))
    np.testing.assert_array_equal(_cat(tmat), np.asarray(jmat))
    np.testing.assert_array_equal(_cat(tb), np.asarray(jb))
    np.testing.assert_array_equal(_cat(tp), np.asarray(jp))
    assert int(to) == int(jo)
    assert (int(to) > 0) == (capacity == 40)
    if capacity == 1024:
        m = _cat(tmat)
        np.testing.assert_array_equal(bk[_cat(tb)[m]], pk[_cat(tp)[m]])


@pytest.mark.parametrize("build_row", [1, 60])
def test_join_int64_max_key_vs_numpy(meshes, build_row):
    """A build key of int64 max matches its probe from whichever shard it
    comes (the JAX package loses it from shard 7 of 8, ROADMAP queue C)."""
    _jm, tm = meshes
    nb = npr = 64
    bk = np.arange(nb, dtype=np.int64) * 5
    bk[build_row] = I64.max
    pk = np.arange(npr, dtype=np.int64) * 3
    pk[0] = I64.max
    ones = np.ones(nb, bool)
    rid = np.arange(nb, dtype=np.int64)
    m, b, p, ovf = pops.make_distributed_join_rowids(tm, 64)(
        *(_t(tm, a) for a in (bk, ones, rid, pk, ones, rid)))
    m = _cat(m)
    got = sorted(zip(_cat(p)[m].tolist(), _cat(b)[m].tolist()))
    want = sorted((i, j) for i in range(npr) for j in range(nb)
                  if pk[i] == bk[j])
    assert int(ovf) == 0 and got == want and (0, build_row) in got
    bx = bk * 2
    out = pops.make_distributed_join(tm, 64)(
        *(_t(tm, a) for a in (bk, ones, bx, pk, ones, rid)))
    m2 = _cat(out[0])
    assert sorted(_cat(out[2])[m2].tolist()) == [i for i, _ in want]
    assert np.array_equal(_cat(out[1])[m2], _cat(out[3])[m2] * 2)


# ----------------------------------------------------------------------
# top-k, hot keys, broadcast
# ----------------------------------------------------------------------

@pytest.mark.parametrize("largest", [True, False])
def test_topk_ties_same_as_jax(meshes, rng, largest):
    jm, tm = meshes
    n = 4096
    vals = rng.integers(-20, 20, n).astype(np.int64)  # many ties
    valid = rng.random(n) > 0.2
    for k in (1, 16, 40):
        jv, jg = jops.make_distributed_topk(jm, k, largest)(
            _j(jm, vals), _j(jm, valid))
        tv, tg = pops.make_distributed_topk(tm, k, largest)(
            _t(tm, vals), _t(tm, valid))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        exp = np.sort(vals[valid])
        exp = exp[::-1][:k] if largest else exp[:k]
        np.testing.assert_array_equal(tv.numpy(), exp)
        np.testing.assert_array_equal(vals[tg.numpy()], tv.numpy())


def test_sample_hot_keys_and_broadcast(rng):
    keys = np.where(rng.random(100_000) < 0.6, 42,
                    rng.integers(0, 10_000, 100_000)).astype(np.int64)
    for n_dev in (8, 16):
        hot = pops.sample_hot_keys(keys, n_dev=n_dev)
        np.testing.assert_array_equal(hot, jops.sample_hot_keys(keys, n_dev))
        assert 42 in hot
    small = pops.sample_hot_keys(keys[:1000], n_dev=8, hot_factor=1.0)
    np.testing.assert_array_equal(
        small, jops.sample_hot_keys(keys[:1000], 8, hot_factor=1.0))
    rep = pops.broadcast_small(pmesh.make_virtual_mesh(3, "cpu"),
                               torch.arange(5))
    assert len(rep) == 3 and all(r.tolist() == list(range(5)) for r in rep)


# ----------------------------------------------------------------------
# the segment-parallel scan-aggregate
# ----------------------------------------------------------------------

def _packs(rng, n_seg, seg_rows, make):
    jp, tp, datas = [], [], []
    for _s in range(n_seg):
        vals, jtype, ttype = make(rng, seg_rows)
        datas.append(vals)
        jp.append(jsegcodec.pack_segment(jnp.asarray(vals), jtype))
        tp.append(segcodec.pack_segment(torch.from_numpy(vals), ttype))
    return jp, tp, datas


def test_scan_agg_one_plane(meshes, rng):
    jm, tm = meshes

    def make(rng, rows):
        base = rng.integers(0, 1 << 20)
        return ((base + rng.integers(0, 1 << 13, rows)).astype(np.uint32),
                jtt.UINTEGER, tt.UINTEGER)

    jp, tp, datas = _packs(rng, 16, 1024, make)
    widths, n_lanes = tp[0].widths, tp[0].n_lanes
    assert jp[0].widths == widths
    thresh = 1 << 19
    jw, jmin, jc = jops.stack_packed_segments(jp, n_lanes)
    tw, tmin, tc = pops.stack_packed_segments(tp, n_lanes)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    js, jn = jops.make_distributed_scan_agg(
        jm, widths, n_lanes, predicate=lambda v, p: v < p)(
        _j(jm, jw), _j(jm, jmin), _j(jm, jc), np.uint32(thresh))
    ts, tn = pops.make_distributed_scan_agg(
        tm, widths, n_lanes, predicate=lambda v, p: v < p)(
        _t(tm, tw), _t(tm, tmin), _t(tm, tc), thresh)
    all_vals = np.concatenate(datas)
    m = all_vals < thresh
    assert (int(ts), int(tn)) == (int(js), int(jn)) == (
        int(all_vals[m].astype(np.int64).sum()), int(m.sum()))


def test_scan_agg_two_plane_validity(meshes, rng):
    jm, tm = meshes

    def make(rng, rows):
        base = (1 << 40) + int(rng.integers(0, 1 << 20))
        return ((base + rng.integers(0, 1 << 34, rows)).astype(np.int64),
                jtt.BIGINT, tt.BIGINT)

    jp, tp, datas = _packs(rng, 16, 512, make)
    widths, n_lanes = tp[0].widths, tp[0].n_lanes
    assert len(widths) == 2 and jp[0].widths == widths
    vbits = [rng.random(512) > 0.1 for _ in datas]
    vplanes = np.stack([np.asarray(jbitpack.pack(jbitpack.pad_codes(
        jnp.asarray(v.astype(np.uint32)), n_lanes), width=1)) for v in vbits])
    tvplanes = torch.stack([bitpack.pack(bitpack.pad_codes(
        torch.from_numpy(v.astype(np.int64)), n_lanes), width=1)
        for v in vbits])
    np.testing.assert_array_equal(tvplanes.numpy().view(np.uint32), vplanes)
    thresh = (1 << 40) + (1 << 33)
    jw, jmin, jc = jops.stack_packed_segments(jp, n_lanes)
    tw, tmin, tc = pops.stack_packed_segments(tp, n_lanes)
    js, jn = jops.make_distributed_scan_agg(
        jm, widths, n_lanes, predicate=lambda v, p: v < p,
        has_validity=True)(_j(jm, jw), _j(jm, vplanes), _j(jm, jmin),
                           _j(jm, jc), np.int64(thresh))
    ts, tn = pops.make_distributed_scan_agg(
        tm, widths, n_lanes, predicate=lambda v, p: v < p,
        has_validity=True)(_t(tm, tw), _t(tm, tvplanes), _t(tm, tmin),
                           _t(tm, tc), thresh)
    all_vals = np.concatenate(datas)
    m = np.concatenate(vbits) & (all_vals < thresh)
    assert (int(ts), int(tn)) == (int(js), int(jn)) == (
        int(all_vals[m].sum()), int(m.sum()))


# ----------------------------------------------------------------------
# the entry points
# ----------------------------------------------------------------------

def test_graft_entry_on_cpu():
    from adacom_tpu_torch import graft_entry
    from adacom_tpu_torch.ops import fused_scan

    fn, args = graft_entry.entry("cpu")
    assert fn is fused_scan.scan_table
    vals = np.arange(100_000, 104_096)
    m = (vals >= 100_100) & (vals <= 100_999)
    assert tuple(fn(*args)) == (int(vals[m].sum()), int(m.sum()), 100_100,
                                100_999)
    line = graft_entry.dryrun_multichip(N_DEV, "cpu")
    assert "8 virtual shards on cpu" in line
