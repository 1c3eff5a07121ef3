"""Distributed query operators: the SPMD scan-aggregate, the all-to-all
shuffle, the hash-partitioned group-by, the shuffle joins and top-k.

Port of adacom_tpu/parallel/ops.py, function for function, with its
semantics and static capacities. Segments shard over the mesh's segment
axis; each shard decodes, filters and partially aggregates its own segments
with the port's batched decoder (ops/segcodec.decode_stack), and the
partial states merge with psum. Repartitioning sends fixed-capacity bins
with validity flags through all_to_all and reports per-destination
overflow counts (skew handling is capacity headroom plus that report).
The JAX package computes all of this in jnp inside shard_map; here each
body runs PyTorch tensor ops on its shard's device (parallel/collectives).

Sharded arguments and results are lists of per-shard tensors
(parallel/mesh.shard_leading); replicated results are single tensors on the
first shard's device.

Hashing is the JAX package's splitmix64 bit for bit, in int64: wrapping
multiplies, logical right shifts by masking, and the destination
hash % n_devices as an unsigned modulo assembled from the 32-bit halves.

One departure, where the JAX package misses SQL pairs: its local join sorts
empty bin slots under the sentinel int64 max, so a probe of key int64 max
can land on an empty slot and miss its valid build row. Here the local join
searches only the valid build slots.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from adacom_tpu_torch.ops import bitpack, segcodec
from adacom_tpu_torch.parallel import collectives as coll
from adacom_tpu_torch.parallel.mesh import Mesh, replicate


# ======================================================================
# distributed scan + aggregate
# ======================================================================


def make_distributed_scan_agg(mesh: Mesh, widths: Tuple[int, ...],
                              n_lanes: int,
                              predicate: Optional[Callable] = None,
                              has_validity: bool = False):
    """SPMD scan-aggregate over stacked packed segments.

    fn(words, [valid,] mins, counts, params) -> (sum, count): words a
    sharded (n_seg, sum(widths), n_lanes) int32 stack, valid (with
    has_validity) a sharded (n_seg, 1, n_lanes) width-1 validity plane
    stack, mins and counts sharded (n_seg,); params replicated, passed to
    predicate(values, params) -> bool mask. Values decode as int64."""
    n_pad = bitpack.ROWS * n_lanes
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(int)

    def body(_shard, words, *rest):
        if has_validity:
            vplane, mins, counts, params = rest
        else:
            (mins, counts, params), vplane = rest, None
        planes = [words[:, offs[i]:offs[i + 1]] if widths[i] else None
                  for i in range(len(widths))]
        vals = segcodec.decode_stack(planes, mins.to(torch.int64), widths,
                                     n_lanes)
        idx = torch.arange(n_pad, device=vals.device)
        mask = idx.unsqueeze(0) < counts.to(torch.int64).unsqueeze(1)
        if vplane is not None:
            mask &= bitpack.unpack(vplane, width=1).reshape(mask.shape) != 0
        if predicate is not None:
            mask &= predicate(vals, params)
        s = torch.where(mask, vals, 0).sum()
        return s, mask.sum()

    def fn(words, *rest):
        sharded, params = list(rest[:-1]), rest[-1]
        s, c = coll.unzip(coll.shard_map(mesh, body, [words, *sharded],
                                         [params]))
        return coll.psum(s)[0], coll.psum(c)[0]

    return fn


def stack_packed_segments(packed_list, n_lanes: int):
    """Stack same-meta PackedData into (n_seg, sum(w), L) int32 words plus
    (n_seg,) int64 minima and int32 counts. Multi-plane segments
    concatenate their planes on the word axis (the offsets of
    make_distributed_scan_agg); constant planes contribute no words."""
    words = torch.stack([
        torch.cat([w for w in p.words if w is not None], dim=0)
        for p in packed_list])
    dev = words.device
    mins = torch.tensor([segcodec._wrap64(p.min_factor) for p in packed_list],
                        dtype=torch.int64, device=dev)
    counts = torch.tensor([p.count for p in packed_list], dtype=torch.int32,
                          device=dev)
    return words, mins, counts


# ======================================================================
# all-to-all hash repartition (the exchange operator)
# ======================================================================


def _bins(keys: torch.Tensor, valid: torch.Tensor, payloads, n_dev: int,
          capacity: int):
    """One shard's rows binned by destination: (bins, overflow) with bins
    the (n_dev, capacity) key, validity and payload bins (a row's slot is
    its rank among the shard's rows of its destination) and overflow the
    (n_dev,) int64 count of rows past a destination's capacity."""
    dev = keys.device
    dest = _dest(_hash64(keys), n_dev)
    dest = torch.where(valid, dest, n_dev)  # invalid rows -> dropped
    slot = _rank_within(dest, n_dev + 1)
    live = dest < n_dev
    over = (slot >= capacity) & live
    overflow = torch.zeros(n_dev, dtype=torch.int64, device=dev).index_add_(
        0, dest.clamp(max=n_dev - 1), over.to(torch.int64))
    drop = ~live | (slot >= capacity)
    target = torch.where(drop, n_dev * capacity,
                         dest * capacity + slot.clamp(max=capacity - 1))

    def scatter(x):
        out = torch.zeros(n_dev * capacity + 1, dtype=x.dtype, device=dev)
        out[target] = x
        return out[:-1].reshape(n_dev, capacity)

    bins = [scatter(keys), scatter(valid & ~drop)]
    bins += [scatter(p) for p in payloads]
    return bins, overflow


def _repartition(mesh: Mesh, capacity: int, keys, valid, payloads=()):
    """Bin every shard's rows and exchange the bins: per array a list of
    received (n_dev, capacity) bins (row s from source shard s), and the
    per-shard overflow vectors. Each shard's send bins are dropped as soon
    as they are exchanged."""
    n_dev = mesh.size
    outs = coll.shard_map(
        mesh, lambda _i, k, v, *p: _bins(k, v, p, n_dev, capacity),
        [keys, valid, *payloads])
    sent = coll.unzip([o[0] for o in outs])
    overflow = [o[1] for o in outs]
    del outs
    received = []
    while sent:
        received.append(coll.all_to_all(sent.pop(0), 0, 0))
    return received, overflow


def make_hash_repartition(mesh: Mesh, capacity: int, n_payloads: int = 0):
    """SPMD hash repartition.

    Each shard bins its (keys, valid, payloads...) rows by
    hash(key) % n_devices into fixed-capacity bins, then all_to_all
    exchanges the bins so shard i holds every row whose key hashes to i.
    fn(keys, valid, *payloads) -> (keys, valid, overflow, *payloads): each
    sharded (n_dev, capacity) per shard except overflow, the (n_dev,)
    psum of the rows that did not fit their destination's bins."""

    def fn(keys, valid, *payloads):
        if len(payloads) != n_payloads:
            raise ValueError(f"{len(payloads)} payloads, expected "
                             f"{n_payloads}")
        received, overflow = _repartition(mesh, capacity, keys, valid,
                                          payloads)
        return (received[0], received[1], coll.psum(overflow)[0],
                *received[2:])

    return fn


def _dense_partial(gid_keys, valid, values, domain: int):
    gid = torch.where(valid, gid_keys.to(torch.int32).to(torch.int64),
                      domain)
    sums = torch.zeros(domain + 1, dtype=values.dtype, device=values.device)
    sums.index_add_(0, gid, torch.where(valid, values, 0))
    cnts = torch.zeros(domain + 1, dtype=torch.int64, device=values.device)
    cnts.index_add_(0, gid, valid.to(torch.int64))
    return sums[:domain], cnts[:domain]


def make_distributed_groupby_sum(mesh: Mesh, capacity: int, domain: int):
    """Hash-repartition the rows, scatter-add each shard's rows into a dense
    (domain,) partial, psum the partials (each key lives on one shard, so
    the partials are disjoint stripes).

    fn(keys int64, valid, values) sharded -> (sums (domain,), counts
    (domain,)). Keys must lie in [0, domain)."""

    def fn(keys, valid, values):
        (k_r, v_r, x_r), _ovf = _repartition(mesh, capacity, keys, valid,
                                             [values])
        parts = coll.shard_map(
            mesh, lambda _i, k, v, x: _dense_partial(
                k.reshape(-1), v.reshape(-1), x.reshape(-1), domain),
            [k_r, v_r, x_r])
        sums, cnts = coll.unzip(parts)
        return coll.psum(sums)[0], coll.psum(cnts)[0]

    return fn


def make_distributed_groupby_preagg(mesh: Mesh, domain: int):
    """Skew-immune distributed group-by for dense key domains: each shard
    pre-aggregates its rows into a (domain,) partial and one psum merges
    them, with no all_to_all, so a 99%-hot key costs what a uniform one
    does (the combiner fix for skewed shuffles)."""

    def fn(keys, valid, values):
        parts = coll.shard_map(
            mesh, lambda _i, k, v, x: _dense_partial(k, v, x, domain),
            [keys, valid, values])
        sums, cnts = coll.unzip(parts)
        return coll.psum(sums)[0], coll.psum(cnts)[0]

    return fn


# ======================================================================
# distributed hash join (shuffle join: repartition both sides, join local)
# ======================================================================


def _local_join(bk, bv, bx, pk, pv):
    """One shard's join of its received bins: for each probe slot, whether
    a valid build slot holds its key, and that slot's payload (0 when
    unmatched). Only valid build slots are searched."""
    sel = bv.nonzero().squeeze(1)
    sk, order = torch.sort(bk[sel], stable=True)
    sx = bx[sel][order]
    if sk.numel() == 0:
        return (torch.zeros_like(pv), torch.zeros(pk.shape, dtype=bx.dtype,
                                                  device=bx.device))
    pos = torch.searchsorted(sk, pk).clamp(max=sk.numel() - 1)
    matched = pv & (sk[pos] == pk)
    return matched, torch.where(matched, sx[pos], 0)


def make_distributed_join(mesh: Mesh, capacity: int):
    """SPMD equi-join for a unique-key build side (PK-FK): both sides
    hash-repartition by key, so matching keys land on one shard; the local
    join sorts the shard's build keys once and binary-searches each probe
    key.

    fn(build_keys, build_valid, build_vals, probe_keys, probe_valid,
    probe_vals) -> (matched, build_val_for_probe, probe_vals, probe_keys),
    each sharded like the probe side after the repartition (n_dev *
    capacity slots per shard)."""

    def fn(bk, bv, bx, pk, pv, px):
        (bk_r, bv_r, bx_r), _ = _repartition(mesh, capacity, bk, bv, [bx])
        (pk_r, pv_r, px_r), _ = _repartition(mesh, capacity, pk, pv, [px])

        def body(_i, bk_, bv_, bx_, pk_, pv_, px_):
            m, x = _local_join(bk_.reshape(-1), bv_.reshape(-1),
                               bx_.reshape(-1), pk_.reshape(-1),
                               pv_.reshape(-1))
            return m, x, px_.reshape(-1), pk_.reshape(-1)

        return tuple(coll.unzip(coll.shard_map(
            mesh, body, [bk_r, bv_r, bx_r, pk_r, pv_r, px_r])))

    return fn


def make_distributed_join_rowids(mesh: Mesh, capacity: int):
    """Distributed equi-join on 64-bit key hashes with row-id payloads:
    the shuffle join the SQL executor routes through (the build side must
    have unique keys; the executor checks and falls back to the host join
    otherwise, and verifies true key equality afterwards).

    fn(bk, bv, b_rid, pk, pv, p_rid) -> (matched, b_rid_out, p_rid_out,
    overflow): the first three sharded like the probe partition, overflow
    the global count of rows dropped by bin capacity. Callers must fall
    back when overflow > 0."""

    def fn(bk, bv, br, pk, pv, pr):
        (bk_r, bv_r, br_r), ovf_b = _repartition(mesh, capacity, bk, bv, [br])
        (pk_r, pv_r, pr_r), ovf_p = _repartition(mesh, capacity, pk, pv, [pr])

        def body(_i, bk_, bv_, br_, pk_, pv_, pr_):
            m, r = _local_join(bk_.reshape(-1), bv_.reshape(-1),
                               br_.reshape(-1), pk_.reshape(-1),
                               pv_.reshape(-1))
            return m, r, pr_.reshape(-1)

        matched, b_rid, p_rid = coll.unzip(coll.shard_map(
            mesh, body, [bk_r, bv_r, br_r, pk_r, pv_r, pr_r]))
        ovf = coll.psum([ob.sum() + op.sum() for ob, op in zip(ovf_b, ovf_p)])
        return matched, b_rid, p_rid, ovf[0]

    return fn


# ======================================================================
# distributed top-k (global ORDER BY ... LIMIT k merge)
# ======================================================================


def _top(v: torch.Tensor, k: int):
    """lax.top_k: the k largest, the lower index first among equals."""
    vals, idx = torch.sort(v, descending=True, stable=True)
    return vals[:k], idx[:k]


def make_distributed_topk(mesh: Mesh, k: int, largest: bool = True):
    """Per-shard top-k, all_gather of the n_dev * k candidates, a final
    top-k (the per-block heap + merge of a top-N operator).

    fn(values, valid) sharded -> (top values, global row ids)."""

    def body(shard, values, valid):
        n_local = values.shape[0]
        v = values if largest else -values
        v = torch.where(valid, v, torch.full((), -(2 ** 62), dtype=v.dtype,
                                             device=v.device))
        loc_v, loc_i = _top(v, min(k, n_local))
        return loc_v, shard * n_local + loc_i

    def fn(values, valid):
        loc_v, gid = coll.unzip(coll.shard_map(mesh, body, [values, valid]))
        all_v = coll.all_gather(loc_v)[0].reshape(-1)
        all_g = coll.all_gather(gid)[0].reshape(-1)
        if all_v.numel() < k:
            raise ValueError(f"top-{k} of {all_v.numel()} candidates")
        fin_v, fin_i = _top(all_v, k)
        return (fin_v if largest else -fin_v), all_g[fin_i]

    return fn


def sample_hot_keys(keys: np.ndarray, n_dev: int, sample: int = 65536,
                    hot_factor: float = 4.0) -> np.ndarray:
    """Skew planner: sample the key stream and return the keys whose
    estimated frequency exceeds hot_factor / n_dev of all rows (they would
    overflow one shard's bin; the caller broadcasts or salts them)."""
    keys = np.asarray(keys)
    if len(keys) > sample:
        idx = np.random.default_rng(0).integers(0, len(keys), sample)
        keys = keys[idx]
    uniq, cnt = np.unique(keys, return_counts=True)
    thresh = hot_factor * len(keys) / max(1, n_dev)
    return uniq[cnt > thresh]


def broadcast_small(mesh: Mesh, arr) -> List[torch.Tensor]:
    """Replicate a small build side to every shard (broadcast join side)."""
    return replicate(mesh, arr)


# ======================================================================
# helpers
# ======================================================================

_M32 = 0xFFFFFFFF
_C1 = 0xBF58476D1CE4E5B9 - (1 << 64)  # splitmix64 constants as int64
_C2 = 0x94D049BB133111EB - (1 << 64)


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _hash64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer: the uint64 hash of each value's int64 bit
    pattern, returned as int64 bit patterns."""
    z = x.to(torch.int64)
    z = (z ^ _srl(z, 30)) * _C1
    z = (z ^ _srl(z, 27)) * _C2
    return z ^ _srl(z, 31)


def _dest(h: torch.Tensor, n: int) -> torch.Tensor:
    """uint64(h) % n for int64 bit patterns h and 0 < n < 2**31."""
    hi = _srl(h, 32) % n
    lo = (h & _M32) % n
    return (hi * ((1 << 32) % n) + lo) % n


def _rank_within(dest: torch.Tensor, n_bins: int) -> torch.Tensor:
    """slot[i] = the number of earlier rows with the same dest."""
    ranks = torch.zeros_like(dest, dtype=torch.int64)
    for b_ in range(n_bins):
        is_b = dest == b_
        ranks = torch.where(is_b, torch.cumsum(is_b, 0) - 1, ranks)
    return ranks
