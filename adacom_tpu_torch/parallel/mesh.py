"""Device meshes and leading-axis sharding.

Port of adacom_tpu/parallel/mesh.py. A mesh is an ordered tuple of torch
devices, one per shard, along one axis (SEG_AXIS, the segment/data-parallel
axis). A tensor sharded over the mesh is a list of tensors, element i being
shard i's slice of the leading axis on mesh.devices[i]; a replicated value
is such a list of equal tensors. `gather_leading` is the inverse of
`shard_leading`.

`make_mesh` takes the first n cards and raises when there are fewer: it
never maps shards onto fewer cards. `make_virtual_mesh(n, device)` puts n
logical shards on one device, on request only: it is the counterpart of the
JAX package's virtual CPU devices (--xla_force_host_platform_device_count)
and runs every shard of the multi-device layer on one CPU or one card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

SEG_AXIS = "d"  # segment/data-parallel axis


class Mesh:
    """n shards along one named axis, shard i on devices[i]."""

    def __init__(self, devices: Sequence, axis: str = SEG_AXIS,
                 virtual: bool = False):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        types = {d.type for d in self.devices}
        if len(types) != 1:
            raise ValueError(f"mesh devices of several types: {types}")
        self.axis = axis
        self.virtual = virtual

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis == other.axis)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis))

    def __repr__(self) -> str:
        kind = "virtual " if self.virtual else ""
        return (f"Mesh({kind}{self.shape}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_devices: Optional[int] = None, platform: str = "cuda",
              axis: str = SEG_AXIS) -> Mesh:
    """A mesh over the first n_devices devices of `platform` (all of them
    when None). The CPU counts as one device."""
    if platform == "cuda":
        have = torch.cuda.device_count()
        devs = [torch.device("cuda", i) for i in range(have)]
    elif platform == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported platform {platform!r}")
    if n_devices is None:
        n_devices = len(devs)
    if len(devs) < n_devices or n_devices < 1:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    return Mesh(devs[:n_devices], axis)


def make_virtual_mesh(n: int, device="cpu", axis: str = SEG_AXIS) -> Mesh:
    """n logical shards on one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return Mesh([dev] * n, axis, virtual=True)


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.asarray(arr)
    return torch.from_numpy(np.ascontiguousarray(a))


def shard_leading(mesh: Mesh, arr) -> List[torch.Tensor]:
    """Split the leading dim evenly over the mesh, each part on its shard's
    device. Raises when the leading dim is not a multiple of mesh.size."""
    t = _tensor(arr)
    n = t.shape[0] if t.dim() else 0
    if t.dim() == 0 or n % mesh.size:
        raise ValueError(f"leading dim {n} is not a multiple of the mesh "
                         f"size {mesh.size}")
    m = n // mesh.size
    return [t[i * m:(i + 1) * m].to(d) for i, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh, arr) -> List[torch.Tensor]:
    """The same tensor on every shard's device."""
    t = _tensor(arr)
    return [t.to(d) for d in mesh.devices]


def gather_leading(shards: Sequence[torch.Tensor], device=None
                   ) -> torch.Tensor:
    """A sharded tensor as one tensor (on the first shard's device unless
    `device` is given)."""
    dev = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in shards])


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
