"""Version shims and mesh spellings of the port (the counterpart of
`repro.compat`).

The reference's module resolves JAX's moving API surface (`jax.shard_map`,
`jax.set_mesh`, `get_abstract_mesh`, `AxisType`). The port's counterparts:

  * make_mesh / mesh_from_device_array -> the port's slot `Mesh`
    (`distributed.sharding.Mesh`: an object array of `torch.device`, one
    per shard slot, and the axis names), as the launchers build it.
  * set_mesh / get_abstract_mesh -> the active-mesh context of
    `models.common` (`set_mesh`, `active_mesh`); None outside any mesh.
  * _quiet -> torch's collective renames: torch 2.13 warns on the tensor
    collectives it renamed (`*_single`), which the card's torch 2.11
    lacks, so `distributed.collectives` calls them through it.

`shard_map` has no counterpart: the port runs a mesh as per-slot loops
(`core/index.py`'s sharded index) or as ranks, one process per slot
(`distributed/collectives.py`), never as one traced program over a mesh.

The imports of the port's modules sit inside the functions:
`distributed.collectives` imports this module, so this module imports
nothing of the port when it is loaded.
"""
from __future__ import annotations

import math
import warnings


def _quiet(fn, *args, **kw):
    """fn(...) without its FutureWarning (torch 2.13's collective
    renames, which torch 2.11 lacks)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


def get_abstract_mesh():
    """The innermost mesh set by `set_mesh`, or None."""
    from repro_torch.models.common import active_mesh
    return active_mesh()


def set_mesh(mesh):
    """Context manager making `mesh` the active mesh (`common.set_mesh`)."""
    from repro_torch.models.common import set_mesh as _set_mesh
    return _set_mesh(mesh)


def make_mesh(axis_shapes, axis_names, *, devices=None):
    """A slot Mesh of `axis_shapes` over `axis_names`, its slots dealt
    round-robin over `devices` (a list of devices, or one device such as
    "cpu" or "meta"; the visible CUDA devices when None), as
    `launch.mesh.make_test_mesh` deals them."""
    from repro_torch._device import visible_devices
    from repro_torch.distributed.sharding import Mesh, device_array
    shape = tuple(int(n) for n in axis_shapes)
    devs = (list(devices) if isinstance(devices, (list, tuple))
            else visible_devices(devices))
    if not devs:
        raise ValueError("need at least one device")
    n = math.prod(shape)
    return Mesh(device_array([devs[i % len(devs)] for i in range(n)], shape),
                tuple(axis_names))


def mesh_from_device_array(devices, axis_names):
    """A slot Mesh over an array of devices already laid out in the mesh's
    shape (a numpy array or nested lists)."""
    import numpy as np

    from repro_torch.distributed.sharding import Mesh, device_array
    arr = np.asarray(devices, dtype=object)
    return Mesh(device_array(list(arr.flat), arr.shape), tuple(axis_names))
