"""The mesh's collectives over per-shard tensors.

XLA supplies these to the JAX package (shard_map, psum, pmin, pmax,
all_gather, all_to_all). Here a per-shard body is called once per shard, in
shard order, on that shard's tensors, and a collective takes the list of
per-shard tensors (one per shard, as parallel/mesh.py shards them) and
returns the list of per-shard results, each moved to its destination
shard's device with `.to(device)`. On a virtual mesh every shard shares one
device and `.to` moves nothing. There is no process per shard and no
torch.distributed: reductions run in shard order on the first shard's
device.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from adacom_tpu_torch.parallel.mesh import Mesh


def _on(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_on(v, dev) for v in x)
    return x


def shard_map(mesh: Mesh, body: Callable, sharded: Sequence[Sequence[Any]],
              replicated: Sequence[Any] = ()) -> List[Any]:
    """body(shard, *sharded_i, *replicated) for each shard i, where
    sharded_i is element i of each per-shard list and the replicated
    arguments' tensors are moved to the shard's device. Returns the list of
    per-shard results."""
    for s in sharded:
        if len(s) != mesh.size:
            raise ValueError(f"a sharded argument has {len(s)} parts for a "
                             f"mesh of {mesh.size}")
    outs = []
    for i, dev in enumerate(mesh.devices):
        rep = [_on(r, dev) for r in replicated]
        outs.append(body(i, *(s[i] for s in sharded), *rep))
    return outs


def unzip(outs: Sequence[Sequence[Any]]) -> List[List[Any]]:
    """Per-shard tuples of outputs -> per-output lists of shards."""
    return [list(x) for x in zip(*outs)]


def _reduce(xs: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(acc.device))
    return [acc.to(x.device) for x in xs]


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce(xs, torch.add)


def pmin(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce(xs, torch.minimum)


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce(xs, torch.maximum)


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard gets all shards' tensors, stacked on a new leading
    axis."""
    return [torch.stack([x.to(d.device) for x in xs]) for d in xs]


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int = 0,
               concat_dim: int = 0) -> List[torch.Tensor]:
    """The tiled lax.all_to_all: shard s splits its tensor along split_dim
    into n parts and sends part d to shard d, which concatenates the parts
    it receives in source order along concat_dim."""
    n = len(xs)
    for x in xs:
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)}"
                             f" does not split into {n}")
    parts = [torch.tensor_split(x, n, dim=split_dim) for x in xs]
    return [torch.cat([parts[s][d].to(xs[d].device) for s in range(n)],
                      dim=concat_dim) for d in range(n)]
