"""Aggregation ops: masked partial reductions + dense grouped scatter.

Port of adacom_tpu/ops/agg.py. Parity with the reference's aggregate
operators (src/execution/operator/aggregate/*): the ungrouped path is a
masked reduction per scan batch with a merge of partials (the reference's
local/global sink states); the grouped path uses the *perfect hash*
strategy (reference PerfectAggregateHashTable): group keys with a small
bounded domain become dense indices and aggregation scatters into a
(domain,) accumulator per aggregate, merged across batches elementwise.

One scatter form serves every domain: ``index_add_`` for sums and counts,
``scatter_reduce_`` with amin/amax for min and max. (The JAX package's
one-hot reduction below 128 groups worked around slow TPU scatters; its
(n, domain) mask would not fit at scale.) The values are cast to the
accumulator dtype before the reduce, as in the JAX package, so integer
overflow behaves the same in both."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

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
