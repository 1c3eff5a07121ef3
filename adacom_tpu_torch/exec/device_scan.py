"""The generic device path: decode -> filter -> partial aggregates (or a
compacted scan) over pools of segments, in PyTorch tensor ops on the
database's device.

Port of the JAX package's generic device tier (adacom_tpu/exec/
executor.py: seg_arg_count / make_seg_decoder :73-111, _scan_batches
:303, _materialize_scan_device :503, _scan_agg_batches :1798, the kernel
factories :2788-3002 and the helpers :3011-3082), the first module split
out of the executor. It takes whatever the fused kernels (B1-B3) decline:
plain segments and generic codecs, delete masks, several columns, floats,
expressions, and dense GROUP BY domains wider than the kernels' 16 groups.

Candidate segments whose columns share one representation (the same meta
per column, the same padded row count, and whether they carry a delete
mask) form a pool. A pool's decoder arguments stack along a leading axis,
cached on the segments' (serial, version), and each column decodes with
one batched decoder. The JAX package compiles one vmapped kernel per pool;
here a pool is decoded, filtered and reduced in chunks of at most
CHUNK_ROWS rows, which bounds the path's extra device memory. Delete masks
change with every DELETE, so a pool of segments that carry one uploads
their masks per query (the JAX package's per-segment delete-mask branch).

Not carried over, being TPU-link or XLA workarounds: the one-hot grouped
reduce, power-of-two pool padding with dummy segments on one device, the
16-wide count vector and the padded pulls.

With a mesh (Database(mesh=...)), the scan-aggregate takes the distributed
pooled path, the twin of the JAX package's _build_distributed_scan_agg_kernel
(executor.py:2855) under its pool rules (:1838-1905): every pool of
segments without a delete mask pads to a power of two and then to a
multiple of the shard count with zero-count dummies, shards over the mesh,
runs the pooled body on each shard and merges the shards' partials with
psum / pmin / pmax (parallel/collectives.py). Pools of segments that carry
a delete mask stay on the single-device path, as in the JAX package.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, List, Optional

import numpy as np
import torch

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.ops import agg as agg_ops
from adacom_tpu_torch.ops import bitpack, codecs, segcodec
from adacom_tpu_torch.ops.select import compact, tail_mask
from adacom_tpu_torch.sql import bound as b
from adacom_tpu_torch.exec.expr import ExprCompiler, compute_dtype_of, device_args
from adacom_tpu_torch.parallel import collectives as coll
from adacom_tpu_torch.parallel import mesh as pmesh

# generic scan-aggregates and device scans run (a plain integer, like the
# kernels' launch counters: a run resets and reads it to check routing)
RUNS = 0

# rows decoded at once: a chunk of a pool holds every scanned column of
# this many rows (as int64 at most) plus the filter and aggregate
# temporaries
CHUNK_ROWS = 1 << 24


# ======================================================================
# segment decoding from meta
# ======================================================================


def seg_arg_count(meta) -> int:
    kind = meta[0]
    if kind == "plain":
        return 1
    if kind == "packed":
        widths, _n_lanes, _dtype = meta[1]
        return sum(1 for w in widths if w > 0) + 1  # words... + min_factor
    if kind in codecs.REGISTRY:  # generic codec framework (ops/codecs.py)
        return codecs.arg_count(meta)
    raise ValueError(meta)


def make_seg_decoder(meta, compute_dtype):
    """decode(args) for a pool of n segments of one meta: each argument
    stacked along a leading axis -> (n, n_pad) values in the device dtype
    of compute_dtype (types.device_dtype)."""
    dt = tt.device_dtype(compute_dtype)
    kind = meta[0]
    if kind == "plain":
        n_pad = bitpack.ROWS * bitpack.lanes_for(meta[2])

        def decode(args):
            v = args[0].to(dt)
            if v.shape[1] == n_pad:
                return v
            return torch.nn.functional.pad(v, (0, n_pad - v.shape[1]))
        return decode
    if kind in codecs.REGISTRY:
        return codecs.make_decoder(meta, compute_dtype)
    widths, n_lanes, _dtype = meta[1]

    def decode(args):
        words = iter(args[:-1])
        ws = [None if w == 0 else next(words) for w in widths]
        return segcodec.decode_stack(ws, args[-1], widths, n_lanes).to(dt)
    return decode


def _seg_args(seg):
    """(meta, decoder arguments) of one segment: its reader arrays plus, for
    a succinct segment, the frame-of-reference minimum (a host int, which
    the pool stacks into one tensor)."""
    meta, arrays = seg.reader_arrays()
    if meta[0] == "packed":
        arrays = arrays + (segcodec._wrap64(seg._packed.min_factor),)
    return meta, arrays


def _stack(values, device) -> torch.Tensor:
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return torch.tensor(values, dtype=torch.int64, device=device)


def _decode_columns(metas, dtypes, args, n_pad):
    """Stacked arguments of a chunk -> [(values, valid | None)] per column,
    each flat (n * n_pad,); row r of the chunk's segment j is j*n_pad + r."""
    cols = []
    k = 0
    for (meta, vflag), dt in zip(metas, dtypes):
        nargs = seg_arg_count(meta)
        v = make_seg_decoder(meta, dt)(args[k:k + nargs]).reshape(-1)
        k += nargs
        valid = None
        if vflag == "v":
            valid = bitpack.unpack(args[k], width=1).reshape(-1) != 0
            k += 1
        cols.append((v, valid))
    return cols


def _rows(v: torch.Tensor, n: int) -> torch.Tensor:
    """An evaluated value as n rows (a constant broadcasts)."""
    return v if v.dim() and v.shape[0] == n else torch.broadcast_to(v, (n,))


def _chunk(metas, dtypes, n_pad, filt, fparams, counts, args, dels=None):
    """Decode and filter a chunk of a pool: (mask, cols) with the flat
    (n * n_pad,) mask of rows that are real, not deleted (dels: the flat
    delete mask, or None) and pass the filter, and cols as
    _decode_columns gives them."""
    cols = _decode_columns(metas, dtypes, args, n_pad)
    mask = tail_mask(n_pad, counts).reshape(-1)
    if dels is not None:
        mask &= ~dels
    if filt is not None:
        # a BOOLEAN column filters as its 0/1 values
        fv, fm = filt.fn(cols, fparams)
        mask &= _rows(fv, mask.shape[0]).to(torch.bool)
        if fm is not None:
            mask &= _rows(fm, mask.shape[0])
    return mask, cols


# ======================================================================
# the pool cache
# ======================================================================

def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(x) for x in obj)
    return 0


class PoolCache:
    """A table's stacked decoder arguments (the pools of the generic path
    and the stacks of kernels B1-B3), kept between queries on the segments'
    (serial, version). Bounded in bytes by the table's encoded bytes
    (Table.footprint_bytes) and, under a memory_limit, by what the limit
    leaves beside the resident segments: least recently used entries go
    first, and an entry that does not fit beside those the running
    statement (BufferManager.statement) already used is not kept. Its
    bytes are charged to the buffer manager (BufferManager.cache_bytes)."""

    def __init__(self, table):
        self.table = table
        # key -> (stacked tensors, bytes, the statement that used it last),
        # least recently used first
        self._entries: "OrderedDict[Any, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.nbytes = 0
        self._bound = 0
        self._bound_at = None

    def _charge(self, delta: int) -> None:
        self.nbytes += delta
        self.table.bm.charge_cache(delta)

    def bound(self) -> int:
        n = self.table.footprint_bytes()
        bm = self.table.bm
        if bm.memory_limit is not None:
            n = min(n, max(0, bm.memory_limit - bm.device_bytes))
        return n

    def get(self, key):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries[key] = (e[0], e[1], self.table.bm.statement)
            self._entries.move_to_end(key)
            return e[0]

    def put(self, key, value) -> None:
        n = _tensor_bytes(value)
        statement = self.table.bm.statement
        with self._lock:
            if self.nbytes + n > self._bound and self._bound_at != statement:
                # the table may have grown (at most once a statement: the
                # sum walks every segment)
                self._bound, self._bound_at = self.bound(), statement
            while self.nbytes + n > self._bound and self._entries:
                old = next(iter(self._entries))
                if self._entries[old][2] == statement:
                    break  # the rest were used by the running statement
                self._charge(-self._entries.pop(old)[1])
            if self.nbytes + n <= self._bound:
                self._entries[key] = (value, n, statement)
                self._charge(n)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._charge(-self.nbytes)


def pool_cache(table) -> PoolCache:
    cache = getattr(table, "_pool_cache", None)
    if cache is None:
        cache = table._pool_cache = PoolCache(table)
    return cache


# ======================================================================
# partial aggregates
# ======================================================================


def _agg_partials(cols, mask, params, spec_entries, group_fns, dense):
    """One chunk's partial state per spec: (domain,) tensors when grouped
    over a dense domain, 0-d tensors otherwise."""
    n = mask.shape[0]
    dev = mask.device
    if dense is not None:
        mins, strides, _sizes, domain = dense
        keys = [_rows(gf(cols, params)[0], n) for gf in group_fns]
        gid = agg_ops.dense_group_ids(keys, mins, strides, domain)
        # per-spec NULL arguments become neutral values, so the one filter
        # mask serves every scatter
        outs = []
        for kind, argf, acc in spec_entries:
            if kind == "count":
                outs.append(agg_ops.grouped_partial(
                    gid, mask, [("count", None, acc)], domain)[0])
                continue
            v, vm = argf(cols, params)
            if kind == "count_arg":
                ones = torch.ones(n, dtype=torch.int64, device=dev)
                if vm is not None:
                    ones = torch.where(vm, ones, 0)
                outs.append(agg_ops.grouped_partial(
                    gid, mask, [("sum", ones, np.int64)], domain)[0])
                continue
            v = _rows(v, n)
            if vm is not None:
                # in the accumulator dtype: a sentinel of int64 does not
                # fit an int32 column (the JAX package raises there)
                v = v.to(tt.device_dtype(acc))
                if kind in ("sum", "sumsq"):
                    v = torch.where(vm, v, 0)
                elif kind == "min":
                    v = torch.where(vm, v, agg_ops._max_sentinel(acc))
                elif kind == "max":
                    v = torch.where(vm, v, agg_ops._min_sentinel(acc))
            outs.append(agg_ops.grouped_partial(
                gid, mask, [(kind, v, acc)], domain)[0])
        return tuple(outs)

    outs = []
    for kind, argf, acc in spec_entries:
        if kind == "count":
            outs.append(agg_ops.masked_count(mask, n))
            continue
        v, vm = argf(cols, params)
        m = mask if vm is None else (mask & vm)
        if kind == "count_arg":
            outs.append(agg_ops.masked_count(m, n))
            continue
        v = _rows(v, n)
        if kind == "sum":
            outs.append(agg_ops.masked_sum(v, m, acc))
        elif kind == "sumsq":
            vv = v.to(tt.device_dtype(acc))
            outs.append(agg_ops.masked_sum(vv * vv, m, acc))
        elif kind == "min":
            outs.append(agg_ops.masked_min(v, m, acc,
                                           agg_ops._max_sentinel(acc)))
        elif kind == "max":
            outs.append(agg_ops.masked_max(v, m, acc,
                                           agg_ops._min_sentinel(acc)))
        else:
            raise ValueError(kind)
    return tuple(outs)


def _pull_partials(partials) -> List[Any]:
    """Device partials -> numpy, with one transfer per dtype."""
    outs: List[Any] = [None] * len(partials)
    by_dtype: dict = {}
    for i, p in enumerate(partials):
        if isinstance(p, torch.Tensor):
            by_dtype.setdefault(p.dtype, []).append(i)
        else:
            outs[i] = np.asarray(p)
    for idxs in by_dtype.values():
        flat = torch.cat([partials[i].reshape(-1) for i in idxs]).cpu().numpy()
        off = 0
        for i in idxs:
            shape = tuple(partials[i].shape)
            n = partials[i].numel()
            chunk = flat[off:off + n]
            off += n
            outs[i] = chunk.reshape(shape) if shape else chunk[0]
    return outs


def _merge_kind(kind: str) -> str:
    if kind in ("count", "count_arg", "sum", "sumsq"):
        return "sum" if kind != "count" else "count"
    return kind


def _init_empty_partials(spec_entries, dense):
    """The partials of a scan that read no segment."""
    outs = []
    domain = dense[3] if dense is not None else None
    for kind, _, acc in spec_entries:
        if dense is not None:
            if kind in ("count", "count_arg"):
                outs.append(np.zeros(domain, np.int64))
            elif kind in ("sum", "sumsq"):
                outs.append(np.zeros(domain, acc))
            elif kind == "min":
                outs.append(np.full(domain, agg_ops._max_sentinel(acc), acc))
            else:
                outs.append(np.full(domain, agg_ops._min_sentinel(acc), acc))
        else:
            if kind in ("count", "count_arg"):
                outs.append(np.int64(0))
            elif kind in ("sum", "sumsq"):
                outs.append(np.zeros((), acc))
            elif kind == "min":
                outs.append(np.asarray(agg_ops._max_sentinel(acc), acc))
            else:
                outs.append(np.asarray(agg_ops._min_sentinel(acc), acc))
    return outs


def _any_count_index(spec_entries):
    for i, (kind, _, _) in enumerate(spec_entries):
        if kind in ("count", "count_arg"):
            return i
    return None


def declines(get, exprs=()) -> bool:
    """True when the generic device path does not take a scan: one whose
    columns, filters or further expressions over it (group keys, aggregate
    arguments) hold a UBIGINT value. UBIGINT has no exact device dtype
    (torch has no uint64 arithmetic, and as int64 it would compare signed),
    so such plans stay on the host tier, decided before any tensor op."""
    if any(t.np_dtype == np.uint64 for t in get.types):
        return True
    return any(getattr(node.ty, "np_dtype", None) == np.uint64
               for e in (*get.filters, *exprs) for node in b.expr_walk(e))


# ======================================================================
# executor methods
# ======================================================================


class DeviceScan:
    """The executor's generic device path (mixed into exec.executor's
    Executor, whose snapshot, zonemap and filter helpers it uses)."""

    def _scan_pools(self, get, lits):
        """The candidate segments of a scan grouped into pools, and what
        decoding and filtering them takes: (pools, dtypes, filt, fparams),
        pools mapping (metas, n_pad, has_del) to the entries
        (segment index, rows, segments, decoder arguments, delete mask).
        Callers route a scan that declines() to the host tier first."""
        if declines(get):
            raise ValueError("a UBIGINT scan reached the generic device path")
        snap = self._pin_snapshot(get.table)
        filt = self._compiled_filter(get)
        fparams = (device_args(filt.prep_args(lits), self.db.device)
                   if filt is not None else ())
        dtypes = [compute_dtype_of(t) for t in get.types]
        pools: dict = {}
        for i in self._zonemap_candidates(get, lits, snap):
            segs = [snap.segment(c, i) for c in get.column_ids]
            count = segs[0].count if segs else snap.segment_rows(i)
            metas, arrays = [], []
            for s in segs:
                meta, arrs = _seg_args(s)
                vwords = s.validity_arrays()
                metas.append((meta, None if vwords is None else "v"))
                arrays.extend(arrs + (vwords or ()))
            del_mask = snap.delete_mask(i)
            n_pad = bitpack.ROWS * bitpack.lanes_for(count)
            key = (tuple(metas), n_pad, del_mask is not None)
            pools.setdefault(key, []).append((i, count, segs, arrays, del_mask))
        return pools, dtypes, filt, fparams

    def _pool_chunks(self, table, key, entries, dtypes, filt, fparams):
        """Decode and filter one pool on the device, a chunk at a time.
        Yields (seg_ids, counts, n_pad, mask, cols): the chunk's n segment
        indices and row counts (host lists), its padded rows per segment,
        the flat (n * n_pad,) mask of rows that are real, not deleted and
        pass the filter, and per scan column (values, valid | None), flat,
        in the device dtype."""
        dev = self.db.device
        metas, n_pad, has_del = key
        # stacked arguments, reused while no segment of the pool changes;
        # keyed on monotonic segment serials, never on id()
        cache = pool_cache(table)
        stack_key = ("generic", key, tuple(
            (s.serial, s.version) for e in entries for s in e[2]))
        stacked = cache.get(stack_key)
        if stacked is None:
            counts_t = torch.tensor([e[1] for e in entries],
                                    dtype=torch.int64, device=dev)
            stacked = (counts_t,) + tuple(
                _stack([e[3][a] for e in entries], dev)
                for a in range(len(entries[0][3])))
            cache.put(stack_key, stacked)
        counts_t, args = stacked[0], stacked[1:]
        step = max(1, CHUNK_ROWS // n_pad)
        for s0 in range(0, len(entries), step):
            part = entries[s0:s0 + step]
            dels = None
            if has_del:
                dm = np.zeros((len(part), n_pad), dtype=bool)
                for j, e in enumerate(part):
                    k = min(len(e[4]), n_pad)
                    dm[j, :k] = e[4][:k]
                dels = torch.from_numpy(dm.reshape(-1)).to(dev)
            mask, cols = _chunk(metas, dtypes, n_pad, filt, fparams,
                                counts_t[s0:s0 + step],
                                [a[s0:s0 + step] for a in args], dels)
            yield [e[0] for e in part], [e[1] for e in part], n_pad, mask, cols

    def _filtered_chunks(self, get, lits):
        """Every pool of a scan through _pool_chunks."""
        pools, dtypes, filt, fparams = self._scan_pools(get, lits)
        for key, entries in pools.items():
            yield from self._pool_chunks(get.table, key, entries, dtypes,
                                         filt, fparams)

    def _scan_batches(self, get, lits):
        """Device scan: yields (seg_ids, counts, (mask, cols)) per decoded
        chunk, with the mask and each column's values and validity shaped
        (n, n_pad) for the chunk's n segments. (The JAX package yields one
        segment at a time.)"""
        global RUNS
        RUNS += 1
        for ids, counts, n_pad, mask, cols in self._filtered_chunks(get, lits):
            n = len(ids)
            yield ids, counts, (mask.reshape(n, n_pad), [
                (v.reshape(n, n_pad), None if m is None else m.reshape(n, n_pad))
                for v, m in cols])

    def _materialize_scan_device(self, get, lits):
        """Materialize a scan on the device: decode, filter and compact
        each chunk there, pull only the kept rows, in segment order."""
        from adacom_tpu_torch.exec.executor import Mat

        ncols = len(get.column_ids)
        dtypes = [compute_dtype_of(t) for t in get.types]
        pieces = {}
        for ids, _counts, (mask, cols) in self._scan_batches(get, lits):
            bounds = np.cumsum(mask.sum(dim=1).cpu().numpy())[:-1]
            _n, kept = compact(mask, [v for v, _m in cols] +
                               [m for _v, m in cols if m is not None])
            kept = iter(kept)
            vals = [np.split(next(kept).cpu().numpy().astype(dt, copy=False),
                             bounds) for dt in dtypes]
            valids = [None if m is None else np.split(next(kept).cpu().numpy(),
                                                      bounds)
                      for _v, m in cols]
            for j, i in enumerate(ids):
                pieces[i] = ([v[j] for v in vals],
                             [None if m is None else m[j] for m in valids])
        if not pieces:
            return Mat.empty_like(get)
        order = sorted(pieces)
        cols_np = [np.concatenate([pieces[i][0][c] for i in order])
                   for c in range(ncols)]
        valids_np: List[Optional[np.ndarray]] = []
        for c in range(ncols):
            per = [pieces[i][1][c] for i in order]
            if all(v is None for v in per):
                valids_np.append(None)
            else:
                valids_np.append(np.concatenate([
                    v if v is not None else np.ones(len(pieces[i][0][c]), bool)
                    for v, i in zip(per, order)]))
        dicts = getattr(get, "dicts", [None] * ncols)
        return Mat(list(get.names), list(get.types), list(dicts), cols_np,
                   valids_np)

    def _scan_agg_batches(self, get, lits, spec_entries, group_fns, dense,
                          params):
        """Partials of every decoded chunk (pools in chunks). With a mesh,
        each pool of segments without a delete mask runs distributed
        instead and yields its merged partials once (the JAX package sends
        segments with a delete mask down its single-device path)."""
        mesh = self.db.mesh
        pools, dtypes, filt, fparams = self._scan_pools(get, lits)
        for key, entries in pools.items():
            if mesh is not None and not key[2]:
                self.db.dist_stats["scan_agg"] += 1
                yield self._distributed_pool(
                    get.table, key, entries, dtypes, filt, fparams,
                    spec_entries, group_fns, dense, params)
                continue
            for _ids, _counts, _n_pad, mask, cols in self._pool_chunks(
                    get.table, key, entries, dtypes, filt, fparams):
                yield _agg_partials(cols, mask, params, spec_entries,
                                    group_fns, dense)

    def _distributed_pool(self, table, key, entries, dtypes, filt, fparams,
                          spec_entries, group_fns, dense, params):
        """One pool's partials over the mesh: the pool pads to a power of
        two, then to a multiple of the shard count, with zero-count copies
        of its last segment; its stacked arguments shard over the mesh's
        leading axis (cached on the segments' (serial, version) and the
        shard count); each shard runs the pooled body over its slice, in
        chunks; the shards' partials merge with psum / pmin / pmax (the
        twin of the JAX package's _build_distributed_scan_agg_kernel)."""
        mesh = self.db.mesh
        dev = self.db.device
        metas, n_pad, _has_del = key
        n, n_dev = len(entries), mesh.size
        n_padded = pmesh.pad_to_multiple(
            max(1 << (n - 1).bit_length(), n_dev), n_dev)
        cache = pool_cache(table)
        stack_key = ("mesh", key, tuple(
            (s.serial, s.version) for e in entries for s in e[2]),
            n_padded, n_dev)
        stacked = cache.get(stack_key)
        if stacked is None:
            counts = np.zeros(n_padded, np.int64)
            counts[:n] = [e[1] for e in entries]
            pad = [entries[-1][3]] * (n_padded - n)
            args = [_stack([e[3][a] for e in entries] + [p[a] for p in pad],
                           dev) for a in range(len(entries[0][3]))]
            stacked = tuple(pmesh.shard_leading(mesh, t)
                            for t in [torch.from_numpy(counts).to(dev)] + args)
            cache.put(stack_key, stacked)
        step = max(1, CHUNK_ROWS // n_pad)

        def body(_shard, counts_s, *rest):
            args_s, (fparams_s, params_s) = rest[:-2], rest[-2:]
            out = None
            for s0 in range(0, counts_s.shape[0], step):
                mask, cols = _chunk(metas, dtypes, n_pad, filt, fparams_s,
                                    counts_s[s0:s0 + step],
                                    [a[s0:s0 + step] for a in args_s])
                part = _agg_partials(cols, mask, params_s, spec_entries,
                                     group_fns, dense)
                out = list(part) if out is None else [
                    agg_ops.merge_partials(_merge_kind(spec_entries[k][0]),
                                           out[k], part[k])
                    for k in range(len(part))]
            return out

        shards = coll.unzip(coll.shard_map(mesh, body, list(stacked),
                                           [fparams, params]))
        merged = []
        for (kind, _f, _acc), xs in zip(spec_entries, shards):
            mk = _merge_kind(kind)
            reduce = (coll.psum if mk in ("sum", "count") else
                      coll.pmin if mk == "min" else coll.pmax)
            merged.append(reduce(xs)[0].to(dev))
        return tuple(merged)

    def _aggregate_generic(self, node, get, lits, specs, finishers, dense):
        """The generic branch of _aggregate_over_scan: group keys and
        aggregate arguments compile once, every chunk's partials merge on
        the device, and one pull per dtype brings them to the host finish."""
        from adacom_tpu_torch.exec.executor import Mat, _agg_finalize_row

        global RUNS
        RUNS += 1
        comp = ExprCompiler()
        group_fns = [comp._c(g) for g in node.groups]
        arg_fns = {}
        for _kind, arg, _acc, _d in specs:
            if arg is not None and id(arg) not in arg_fns:
                arg_fns[id(arg)] = comp._c(arg)
        spec_entries = [
            (kind, None if arg is None else arg_fns[id(arg)], acc)
            for kind, arg, acc, _d in specs
        ]
        params = device_args(tuple(p(lits) for p in comp.preps),
                             self.db.device)

        partials = None
        for batch in self._scan_agg_batches(get, lits, spec_entries,
                                            group_fns, dense, params):
            if partials is None:
                partials = list(batch)
            else:
                partials = [
                    agg_ops.merge_partials(_merge_kind(spec_entries[k][0]),
                                           partials[k], batch[k])
                    for k in range(len(batch))
                ]
        if partials is None:
            partials = _init_empty_partials(spec_entries, dense)

        host = _pull_partials(partials)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        if not node.groups:
            prim = [h.item() if h.ndim == 0 else h for h in host]
            out_vals = [f(prim) for f in finishers]
            cols, valids = _agg_finalize_row(node, out_vals)
            return Mat(list(node.names), list(node.types), dicts, cols, valids)

        mins, strides, sizes, domain = dense
        count_idx = _any_count_index(spec_entries)
        present = (host[count_idx] > 0 if count_idx is not None
                   else np.ones(domain, bool))
        gidx = np.nonzero(present)[0]
        prim = [h[gidx] for h in host]
        agg_cols = [f(prim) for f in finishers]
        cols: List[np.ndarray] = []
        valids: List[Optional[np.ndarray]] = []
        for gi, g in enumerate(node.groups):
            vals = (gidx // strides[gi]) % sizes[gi] + mins[gi]
            cols.append(vals.astype(compute_dtype_of(g.ty)))
            valids.append(None)
        for a, v in zip(node.aggregates, agg_cols):
            arr = np.asarray(v)
            if a.func in ("min", "max", "first") and arr.dtype.kind in "iu":
                arr = arr.astype(compute_dtype_of(a.ty))
            cols.append(arr)
            valids.append(None)
        return Mat(list(node.names), list(node.types), dicts, cols, valids)
