"""Mesh builders for tests and examples (functions: importing this module
touches no device).

Port of `repro.launch.mesh`'s `make_test_mesh`. The reference's
production builders (`make_production_mesh`, `make_train_opt_mesh`) shape
TPU pods of 256 and 512 chips; they have no counterpart here (ROADMAP A3f).
"""
from __future__ import annotations

from repro_torch._device import visible_devices
from repro_torch.distributed.collectives import RankMesh, World
from repro_torch.distributed.sharding import Mesh, device_array


def make_test_mesh(data: int = 1, model: int = 1, device=None,
                   world: World | None = None) -> Mesh | RankMesh:
    """A (data, model) mesh of shard slots dealt round-robin over the
    visible CUDA devices (or over `device`, e.g. "cpu"). Slots may share a
    device: four slots on one card are four row blocks on that card.

    Given the `world` of a spawned run of data * model ranks, a RankMesh
    over all of them instead (a new process group; every rank calls)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
    if world is not None:
        return world.join(range(world.size), (data, model),
                          ("data", "model"), "test_mesh")
    devs = visible_devices(device)
    slots = [devs[i % len(devs)] for i in range(data * model)]
    return Mesh(device_array(slots, (data, model)), ("data", "model"))
