"""Mesh builders (functions: importing this module touches no device).

Port of `repro.launch.mesh`. `make_test_mesh` deals shard slots over the
visible devices (or ranks) for tests, examples and the launchers.
`make_production_mesh` and `make_train_opt_mesh` keep the reference's
production shapes, (16, 16) and (2, 16, 16), (64, 4) and (2, 64, 4), as
abstract meshes of slots on `meta`: nothing runs on them. They exist for
the dry run (`launch/dryrun.py`), which runs one chosen rank of such a
mesh through `collectives.DryMesh` and reads the sharding rules off them.
"""
from __future__ import annotations

from repro_torch.compat import make_mesh
from repro_torch.distributed.collectives import RankMesh, World
from repro_torch.distributed.sharding import Mesh


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
    return make_mesh((data, model), ("data", "model"), devices=device)


def _production(shape: tuple[int, ...], multi_pod: bool) -> Mesh:
    axes = ("data", "model")
    if multi_pod:
        shape, axes = (2, *shape), ("pod", *axes)
    return make_mesh(shape, axes, devices="meta")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 slots. Multi-pod adds a
    leading pod axis: (pod=2, data=16, model=16) = 512 slots."""
    return _production((16, 16), multi_pod)


def make_train_opt_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's rebalanced training mesh over the same slots: TP=4
    instead of TP=16, (data=64, model=4) or (pod=2, data=64, model=4)."""
    return _production((64, 4), multi_pod)
