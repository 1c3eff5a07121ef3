"""Aggregation ops: masked partial reductions + dense grouped scatter.

Port of adacom_tpu/ops/agg.py. Parity with the reference's aggregate
operators (src/execution/operator/aggregate/*): the ungrouped path is a
masked reduction per scan batch with a merge of partials (the reference's
local/global sink states); the grouped path uses the *perfect hash*
strategy (reference PerfectAggregateHashTable): group keys with a small
bounded domain become dense indices and aggregation scatters into a
(domain,) accumulator per aggregate, merged across batches elementwise.

A scan adds each chunk of a dense GROUP BY into its running accumulators
in place (grouped_accumulate): on a card one launch of the kernel
csrc/grouped_accumulate.cu does every spec of a chunk and skips the rows
the filter rejects; on the CPU its plain version runs grouped_partial's
scatters and merges them. One scatter form serves every domain there:
``index_add_`` for sums and counts, ``scatter_reduce_`` with amin/amax for
min and max. (The JAX package's one-hot reduction below 128 groups worked
around slow TPU scatters; its (n, domain) mask would not fit at scale.)
The values are cast to the accumulator dtype before the reduce, as in the
JAX package, so integer overflow behaves the same in both."""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from adacom_tpu_torch import build
from adacom_tpu_torch import types as tt

I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max


def _acc(dt) -> torch.dtype:
    return tt.device_dtype(dt)


def masked_sum(values: torch.Tensor, mask: Optional[torch.Tensor], acc_dtype
               ) -> torch.Tensor:
    v = values.to(_acc(acc_dtype))
    if mask is not None:
        v = torch.where(mask, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return v.sum()


def masked_count(mask: Optional[torch.Tensor], n: int,
                 device=None) -> torch.Tensor:
    if mask is None:
        return torch.tensor(n, dtype=torch.int64, device=device)
    return mask.sum(dtype=torch.int64)


def masked_min(values, mask, acc_dtype, sentinel) -> torch.Tensor:
    v = values.to(_acc(acc_dtype))
    if mask is not None:
        v = torch.where(mask, v, torch.tensor(sentinel, dtype=v.dtype,
                                              device=v.device))
    return v.min()


def masked_max(values, mask, acc_dtype, sentinel) -> torch.Tensor:
    v = values.to(_acc(acc_dtype))
    if mask is not None:
        v = torch.where(mask, v, torch.tensor(sentinel, dtype=v.dtype,
                                              device=v.device))
    return v.max()


# ---------------- grouped (perfect-hash / dense domain) ----------------


def dense_group_ids(keys: List[torch.Tensor], mins: List[int],
                    strides: List[int], domain: int) -> torch.Tensor:
    """Mixed-radix dense id (int64) for multi-column small-domain keys."""
    gid = None
    for k, mn, st in zip(keys, mins, strides):
        part = (k.to(torch.int64) - int(mn)) * int(st)
        gid = part if gid is None else gid + part
    return torch.clamp(gid, 0, domain - 1)


def grouped_partial(gid: torch.Tensor, mask: Optional[torch.Tensor], specs,
                    domain: int):
    """One batch's grouped partial state: a tuple of (domain,) tensors.

    gid: (n,) int64 dense group ids; mask: (n,) bool or None; specs: list
    of (kind, values | None, acc_dtype) with kind in 'count', 'sum',
    'sumsq', 'min', 'max'. Masked rows scatter into a spare slot
    `domain`, which is dropped."""
    dev = gid.device
    safe_gid = gid if mask is None else torch.where(
        mask, gid, torch.full((), domain, dtype=gid.dtype, device=dev))
    outs = []
    for kind, values, acc_dtype in specs:
        if kind == "count":
            acc = torch.zeros(domain + 1, dtype=torch.int64, device=dev)
            acc.index_add_(0, safe_gid, torch.ones_like(safe_gid))
            outs.append(acc[:domain])
            continue
        v = values.to(_acc(acc_dtype))
        if kind in ("sum", "sumsq"):
            if kind == "sumsq":
                v = v * v
            acc = torch.zeros(domain + 1, dtype=v.dtype, device=dev)
            acc.index_add_(0, safe_gid, v)
        elif kind == "min":
            acc = torch.full((domain + 1,), _max_sentinel(acc_dtype),
                             dtype=v.dtype, device=dev)
            acc.scatter_reduce_(0, safe_gid, v, "amin", include_self=True)
        elif kind == "max":
            acc = torch.full((domain + 1,), _min_sentinel(acc_dtype),
                             dtype=v.dtype, device=dev)
            acc.scatter_reduce_(0, safe_gid, v, "amax", include_self=True)
        else:
            raise ValueError(kind)
        outs.append(acc[:domain])
    return tuple(outs)


def _max_sentinel(dt):
    dt = np.dtype(dt)
    return np.finfo(dt).max if dt.kind == "f" else np.iinfo(dt).max


def _min_sentinel(dt):
    dt = np.dtype(dt)
    return np.finfo(dt).min if dt.kind == "f" else np.iinfo(dt).min


def merge_partials(kind: str, a, b_):
    if kind in ("count", "sum", "sumsq"):
        return a + b_
    if kind == "min":
        return torch.minimum(a, b_)
    if kind == "max":
        return torch.maximum(a, b_)
    raise ValueError(kind)


# ---------------- a scan's running accumulators, added in place ----------------

# launches of the grouped-accumulate kernel (csrc/grouped_accumulate.cu) by
# grouped_accumulate (a plain integer, like the other kernels' counters: a
# run resets and reads it to show the main path went through the kernel)
SCATTER_LAUNCHES = 0

# the kernel's op code of a spec is kind * 2 + accumulator type
_KIND_CODES = {"count": 0, "sum": 1, "sumsq": 2, "min": 3, "max": 4}
_TYPE_CODES = {torch.int64: 0, torch.float64: 1}


def new_accumulators(specs, domain: int, device) -> List[torch.Tensor]:
    """A scan's running (domain,) accumulators of a dense GROUP BY, one per
    spec (kind, acc_dtype): zeros for count, sum and sumsq, and for min and
    max the sentinels grouped_partial starts from."""
    accs = []
    for kind, acc_dtype in specs:
        dt = torch.int64 if kind == "count" else _acc(acc_dtype)
        if kind == "min":
            accs.append(torch.full((domain,), _max_sentinel(acc_dtype),
                                   dtype=dt, device=device))
        elif kind == "max":
            accs.append(torch.full((domain,), _min_sentinel(acc_dtype),
                                   dtype=dt, device=device))
        else:
            accs.append(torch.zeros(domain, dtype=dt, device=device))
    return accs


def grouped_accumulate(accs: List[torch.Tensor], gid: torch.Tensor,
                       mask: torch.Tensor, specs) -> Tuple[int, int]:
    """Adds one chunk's rows into a scan's running accumulators, in place.

    accs: one (domain,) tensor per spec, as new_accumulators makes them;
    gid and specs as grouped_partial takes them, mask an (n,) bool tensor. On CUDA tensors one
    launch of the kernel for every 32 specs (its limit) adds the kept rows
    of each (it raises on what the kernel does not take, and never falls
    back); on CPU tensors the plain version, grouped_accumulate_reference,
    runs. Returns (kernel, shared): 1 when the kernel ran, and 1 when it
    kept per-block accumulators in shared memory; (0, 0) on the CPU."""
    if gid.device.type == "cpu":
        grouped_accumulate_reference(accs, gid, mask, specs)
        return 0, 0
    return _accumulate_kernel(accs, gid, mask, specs)


def grouped_accumulate_reference(accs: List[torch.Tensor], gid: torch.Tensor,
                                 mask: torch.Tensor, specs) -> None:
    """Plain PyTorch version of grouped_accumulate, on the tensors' device:
    the chunk's partials by grouped_partial, merged into accs by
    merge_partials."""
    parts = grouped_partial(gid, mask, specs, accs[0].shape[0])
    for acc, (kind, _v, _a), part in zip(accs, specs, parts):
        acc.copy_(merge_partials(kind, acc, part))


@functools.lru_cache(maxsize=None)
def _kernel_limits() -> Tuple[int, int]:
    """The most specs one launch of the kernel takes, and the shared memory
    (bytes) its per-block accumulators may use."""
    lib = build.kernels()
    return lib.adacom_accumulate_max_specs(), lib.adacom_accumulate_smem_bytes()


def _accumulate_kernel(accs, gid, mask, specs) -> Tuple[int, int]:
    """grouped_accumulate on the current stream of the tensors' card:
    csrc/grouped_accumulate.cu, with per-block accumulators in shared
    memory where a launch's specs x domain x 8 B fit the kernel's limit."""
    global SCATTER_LAUNCHES
    dev = gid.device
    if not specs or len(accs) != len(specs):
        raise ValueError(f"grouped accumulate kernel: {len(specs)} specs for "
                         f"{len(accs)} accumulators")
    if gid.dim() != 1 or gid.dtype != torch.int64:
        raise ValueError(f"grouped accumulate kernel: group ids must be an "
                         f"(n,) int64 tensor, got {tuple(gid.shape)} {gid.dtype}")
    n, domain = int(gid.shape[0]), int(accs[0].shape[0])
    if tuple(mask.shape) != (n,) or mask.dtype != torch.bool or mask.device != dev:
        raise ValueError(f"grouped accumulate kernel: the mask must be an "
                         f"({n},) bool tensor on {dev}, got "
                         f"{tuple(mask.shape)} {mask.dtype} on {mask.device}")
    gid, mask = gid.contiguous(), mask.contiguous()
    if mask.data_ptr() % 16:
        mask = mask.clone()  # the kernel loads 16 mask bytes at once
    ops, vals = [], []
    for acc, (kind, values, _a) in zip(accs, specs):
        if kind not in _KIND_CODES:
            raise ValueError(f"grouped accumulate kernel: no kind {kind!r}")
        if (acc.dtype not in _TYPE_CODES or acc.device != dev
                or tuple(acc.shape) != (domain,) or not acc.is_contiguous()
                or (kind == "count" and acc.dtype != torch.int64)):
            raise ValueError(f"grouped accumulate kernel: a {kind} accumulator "
                             f"must be a contiguous ({domain},) int64"
                             f"{'' if kind == 'count' else ' or float64'} "
                             f"tensor on {dev}, got {tuple(acc.shape)} "
                             f"{acc.dtype} on {acc.device}")
        v = None
        if kind != "count":
            if values is None or tuple(values.shape) != (n,) or values.device != dev:
                raise ValueError(f"grouped accumulate kernel: {kind} values "
                                 f"must be ({n},) on {dev}")
            v = values.to(acc.dtype)
            if v.stride(0) != 0:  # a constant keeps stride 0
                v = v.contiguous()
        ops.append(_KIND_CODES[kind] * 2 + _TYPE_CODES[acc.dtype])
        vals.append(v)
    if dev.type != "cuda":
        raise ValueError(f"grouped accumulate kernel: no kernel for device {dev}")
    if n == 0:
        return 0, 0
    lib = build.kernels()
    most, smem = _kernel_limits()
    shared_ran = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s0 in range(0, len(ops), most):
            k = min(most, len(ops) - s0)
            part = vals[s0:s0 + k]
            shared = int(k * domain * 8 <= smem)
            rc = lib.adacom_grouped_accumulate(
                gid.data_ptr(), mask.data_ptr(), n, domain, k,
                (ctypes.c_int * k)(*ops[s0:s0 + k]),
                (ctypes.c_void_p * k)(*[None if v is None else v.data_ptr()
                                        for v in part]),
                (ctypes.c_longlong * k)(*[0 if v is None else v.stride(0)
                                          for v in part]),
                (ctypes.c_void_p * k)(*[a.data_ptr() for a in accs[s0:s0 + k]]),
                shared, stream)
            if rc != 0:
                raise RuntimeError(f"grouped accumulate kernel launch failed: "
                                   f"CUDA error {rc}")
            SCATTER_LAUNCHES += 1
            shared_ran |= shared
    return 1, shared_ran
