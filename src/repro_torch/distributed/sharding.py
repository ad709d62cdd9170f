"""The serving mesh: a device list with named axes.

Port of `repro.distributed.sharding`'s serving half. A `jax.sharding.Mesh`
is an array of devices with axis names; its torch counterpart here is
`Mesh`, a numpy object array of `torch.device` (one per shard slot) and
the axis names. Unlike a JAX mesh it may repeat a device: S shard slots
on one card are S row blocks on that card (the counterpart of forcing
host devices in the reference's tests). Shards move their data between
devices explicitly; there is no collective here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: an object array of `torch.device`, one per shard slot,
    shaped like the mesh; axis_names: one name per axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")
        if not self.devices.size:
            raise ValueError("need at least one device")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def slots(self) -> list[torch.device]:
        """The shard slots' devices, flattened row-major (the order the
        reference's flattened mesh axes deal row blocks in)."""
        return list(self.devices.flat)


def device_array(devices, shape: tuple[int, ...]) -> np.ndarray:
    """A list of devices as an object array of `shape`."""
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr.reshape(shape)


def serving_shard_mesh(devices) -> Mesh:
    """1-D ("shard",) mesh over the serving shards' devices.

    The sharded serving runtime's topology object: one axis, one device
    per shard slot. Devices that repeat (shards that share a card) are
    dropped, keeping the order, as the reference drops them; the runtime
    keeps its own shard -> device map for dispatch. On elastic shrink the
    runtime rebuilds this mesh from the survivors."""
    devs = list(dict.fromkeys(torch.device(d) for d in devices))
    if not devs:
        raise ValueError("need at least one device")
    return Mesh(device_array(devs, (len(devs),)), ("shard",))
