"""Sharding: the serving mesh, and the parameter, optimizer, batch and
cache rules of a training state sharded over a mesh of ranks.

Port of `repro.distributed.sharding`. A `jax.sharding.Mesh` is an array of
devices with axis names; the serving half's counterpart here is `Mesh`, a
numpy object array of `torch.device` (one per shard slot) and the axis
names. Unlike a JAX mesh it may repeat a device: S shard slots on one card
are S row blocks on that card (the counterpart of forcing host devices in
the reference's tests). Shards move their data between devices
explicitly; there is no collective in the serving half.

The training rules are the reference's, line for line: 2-D "hybrid"
sharding, tensor-parallel over `model` and FSDP over the batch axes
(`data`, plus `pod` when present), every rule divisibility-guarded so one
rule set covers every architecture (qwen2's 14 heads, odd vocabularies,
batch 1). They are pure metadata over leaf names and shapes, so they
cover families the port does not run yet (the MoE, SSM and enc-dec leaf
names too), and take any mesh with `.shape` (axis -> size) and
`.axis_names`: the serving `Mesh`, a `collectives.RankMesh`, or a stub.
`PartitionSpec` is their result: a tuple whose entries are None, an axis
name or a tuple of names, one per leading dim of a leaf.

On a `RankMesh`, `shard`/`shard_tree` keep this rank's block of each leaf
(a tensor of its own, so a rank holds only its blocks) and
`gather`/`gather_tree` join a leaf whole over the axes it is split over.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.distributed import collectives as coll


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


# ---------------------------------------------------------------------------
# Training rules (the reference's, over the port's trees)
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """The port's `jax.sharding.PartitionSpec`: one entry per leading dim
    of a leaf, each None (replicated), an axis name or a tuple of names
    (split over them, row-major); trailing dims left out are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A leaf's layout: the mesh and the spec (`jax.sharding.NamedSharding`)."""
    mesh: Any
    spec: PartitionSpec


def mesh_axes(mesh) -> tuple[tuple[str, ...], str]:
    """Returns (batch_axes, model_axis) for our mesh layouts."""
    names = tuple(mesh.axis_names)
    if "model" in names:
        mp = "model"
        dp = tuple(n for n in names if n != "model")
    else:
        mp = None
        dp = names
    return dp, mp


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _fits(dim: int, mesh, axes) -> bool:
    return axes is not None and dim % _size(mesh, axes) == 0


def _path_names(path) -> list[str]:
    """A path of dict keys and sequence indices (`_tree`) as names."""
    return [str(e) for e in path]


SERVE_REPLICATE_BYTES = 128 * 1024 * 1024   # per layer-slice per device


def param_spec(path, shape: tuple[int, ...], mesh, cfg=None,
               serve: bool = False, dtype_bytes: int = 4) -> PartitionSpec:
    """serve=True replicates SMALL weights over the batch axes (no FSDP):
    at decode, FSDP-sharded weights would be all-gathered every step for
    a handful of tokens. The rule is SIZE-AWARE: a tensor whose per-layer,
    per-model-shard slice exceeds SERVE_REPLICATE_BYTES (e.g. llama4
    expert banks) stays batch-sharded. TP over `model` is always kept.
    `cfg` is unused, as in the reference."""
    dp, mp = mesh_axes(mesh)
    names = _path_names(path)
    name = names[-1] if names else ""
    nd = len(shape)

    if serve and nd >= 2:
        slice_elems = 1
        for d in shape[1:] if nd >= 3 else shape:   # per stacked-layer slice
            slice_elems *= d
        per_dev = slice_elems * dtype_bytes / _size(mesh, mp)
        serve = per_dev <= SERVE_REPLICATE_BYTES

    def trailing(*pattern):
        """pattern entries: 'dp' | 'mp' | None per trailing dim; leading
        (stack) dims replicated. Divisibility-guarded, axes used once."""
        spec = [None] * nd
        used = set()
        for i, want in enumerate(pattern):
            d = nd - len(pattern) + i
            if d < 0:
                continue
            if want == "dp" and serve:
                continue
            if want == "dp" and "dp" not in used and _fits(shape[d], mesh, dp):
                spec[d] = dp if len(dp) > 1 else dp[0]
                used.add("dp")
            elif want == "mp" and "mp" not in used and _fits(shape[d], mesh, mp):
                spec[d] = mp
                used.add("mp")
        return P(*spec)

    if name == "embed":
        v, d = shape
        if _fits(v, mesh, mp):
            return trailing("mp", "dp")
        return trailing(None, "mp")            # shard d_model instead
    if name == "lm_head" or name == "proj":
        d, v = shape
        if _fits(v, mesh, mp):
            return trailing("dp", "mp")
        return trailing("mp", None)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "sh_gate", "sh_up",
                "in_proj", "xwq", "xwk", "xwv"):
        if name in ("w_gate", "w_up") and nd >= 3 and len(names) >= 2 \
                and names[-2] == "moe":
            # (SB, E, D, F): expert-parallel over model, FSDP over D
            return trailing("mp", "dp", None)
        return trailing("dp", "mp")            # (..., D, O)
    if name in ("wo", "w_down", "sh_down", "out_proj", "xwo"):
        if name == "w_down" and nd >= 3 and len(names) >= 2 \
                and names[-2] == "moe":
            return trailing("mp", None, "dp")  # (SB, E, F, D)
        return trailing("mp", "dp")            # (..., O, D)
    if name in ("bq", "bk", "bv"):
        return trailing("mp")
    if name == "router":
        return trailing("dp", None)            # (SB, D, E)
    # norms, conv, A_log, dt_bias, D, scalar state: replicated
    return P()


def _itemsize(leaf) -> int:
    dt = leaf.dtype
    return dt.itemsize if isinstance(dt, torch.dtype) else np.dtype(dt).itemsize


def param_shardings(abstract_params: Any, mesh, cfg=None,
                    serve: bool = False) -> Any:
    """A NamedSharding per leaf of a tree of tensors (meta tensors do)."""
    return _tree.tree_map_with_path(
        lambda p, l: NamedSharding(mesh, param_spec(
            p, tuple(l.shape), mesh, cfg, serve=serve,
            dtype_bytes=_itemsize(l))),
        abstract_params)


def opt_state_shardings(abstract_opt_state: Any, abstract_params: Any,
                        mesh, cfg=None) -> Any:
    """Optimizer moments shard like their parameter. AdamW mu/nu mirror the
    param tree; Adafactor factored vr/vc inherit the matching param dims."""
    flat_specs = {}
    _tree.tree_map_with_path(
        lambda p, l: flat_specs.__setitem__(
            tuple(_path_names(p)), param_spec(p, tuple(l.shape), mesh, cfg)),
        abstract_params)

    def resolve(path, leaf):
        names = tuple(_path_names(path))
        if names and names[-1] == "step":
            return NamedSharding(mesh, P())
        # strip the optimizer-state prefix ("mu"/"nu"/"v") and suffix
        # ("vr"/"vc"/"v") to find the matching param path
        core = names[1:] if names and names[0] in ("mu", "nu", "v") else names
        suffix = None
        if core and core[-1] in ("vr", "vc", "v"):
            suffix = core[-1]
            core = core[:-1]
        spec = flat_specs.get(tuple(core))
        if spec is None:
            return NamedSharding(mesh, P())
        parts = list(spec) + [None] * (leaf.ndim + 2 - len(spec))
        if suffix == "vr":        # param dims minus the LAST dim
            parts = parts[:leaf.ndim]
        elif suffix == "vc":      # param dims minus the SECOND-TO-LAST dim
            parts = parts[:leaf.ndim + 1]
            parts = parts[:-2] + [parts[-1]]
        else:                     # mirrors the param exactly
            parts = parts[:leaf.ndim]
        return NamedSharding(mesh, P(*parts))

    return _tree.tree_map_with_path(resolve, abstract_opt_state)


def batch_spec(shape: tuple[int, ...], mesh) -> PartitionSpec:
    dp, _ = mesh_axes(mesh)
    if shape and _fits(shape[0], mesh, dp):
        return P(dp if len(dp) > 1 else dp[0], *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def batch_shardings(abstract_batch: Any, mesh) -> Any:
    return _tree.tree_map(
        lambda l: NamedSharding(mesh, batch_spec(tuple(l.shape), mesh)),
        abstract_batch)


def cache_spec(path, shape: tuple[int, ...], mesh, cfg=None
               ) -> PartitionSpec:
    """KV/SSM cache sharding. Leaf names: k/v/self_k/.../state/conv/length."""
    dp, mp = mesh_axes(mesh)
    names = _path_names(path)
    name = names[-1] if names else ""
    nd = len(shape)
    if name == "length" or nd <= 1:
        return P()
    if name == "k_scale":                      # (L, B, T, KH)
        spec = [None] * nd
        if _fits(shape[1], mesh, dp):
            spec[1] = dp if len(dp) > 1 else dp[0]
        if _fits(shape[3], mesh, mp):
            spec[3] = mp
        elif _fits(shape[2], mesh, mp):
            spec[2] = mp
        return P(*spec)
    if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v",
                "k_msb", "k_lsb"):
        # (L|APPS, B, T, KH, hd)
        spec = [None] * nd
        b_dim, t_dim, kh_dim = 1, 2, 3
        used_dp = False
        if _fits(shape[b_dim], mesh, dp):
            spec[b_dim] = dp if len(dp) > 1 else dp[0]
            used_dp = True
        if _fits(shape[kh_dim], mesh, mp):
            spec[kh_dim] = mp
        elif _fits(shape[t_dim], mesh, mp):
            spec[t_dim] = mp                  # context-parallel decode
        if not used_dp:
            rem = [a for a in dp if shape[t_dim] % (mesh.shape[a]
                   * (_size(mesh, mp) if spec[t_dim] == mp else 1)) == 0]
            if rem and spec[t_dim] in (None, mp):
                extra = tuple(rem)
                spec[t_dim] = (extra + (mp,)) if spec[t_dim] == mp else (
                    extra if len(extra) > 1 else extra[0])
        return P(*spec)
    if name == "state":                        # (L, B, H, P, N)
        spec = [None] * nd
        if _fits(shape[1], mesh, dp):
            spec[1] = dp if len(dp) > 1 else dp[0]
        if _fits(shape[2], mesh, mp):
            spec[2] = mp
        return P(*spec)
    if name == "conv":                         # (L, B, W-1, C)
        spec = [None] * nd
        if _fits(shape[1], mesh, dp):
            spec[1] = dp if len(dp) > 1 else dp[0]
        if _fits(shape[3], mesh, mp):
            spec[3] = mp
        return P(*spec)
    return P()


def cache_shardings(abstract_cache: Any, mesh, cfg=None) -> Any:
    return _tree.tree_map_with_path(
        lambda p, l: NamedSharding(mesh, cache_spec(p, tuple(l.shape), mesh,
                                                    cfg)),
        abstract_cache)


# ---------------------------------------------------------------------------
# Blocks of a sharded leaf on a RankMesh
# ---------------------------------------------------------------------------

def _entries(spec: PartitionSpec, ndim: int) -> list:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} for a {ndim}-D leaf")
    return list(spec) + [None] * (ndim - len(spec))


def split_axes(sharding: NamedSharding) -> tuple[str, ...]:
    """Every axis the leaf is split over, in the mesh's order."""
    used = {a for e in sharding.spec for a in coll.axes_of(e)}
    return tuple(a for a in sharding.mesh.axis_names if a in used)


def block_slices(shape: tuple[int, ...], sharding: NamedSharding
                 ) -> tuple[slice, ...]:
    """This rank's block of a leaf of `shape`; raises where a split dim
    does not divide (the rules never make one)."""
    return _slices(shape, _entries(sharding.spec, len(shape)), sharding.mesh)


def _slices(shape, entries, mesh) -> tuple[slice, ...]:
    out = []
    for d, entry in zip(shape, entries):
        k = mesh.axes_size(entry)
        if d % k:
            raise ValueError(f"dim {d} of {shape} does not split over "
                             f"{entry} ({k} blocks)")
        i, n = mesh.index(entry), d // k
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def local_shape(shape: tuple[int, ...], sharding: NamedSharding
                ) -> tuple[int, ...]:
    return tuple(s.stop - s.start for s in block_slices(shape, sharding))


def shard(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of a whole leaf, as a tensor of its own on the
    mesh's device."""
    block = full[block_slices(tuple(full.shape), sharding)]
    return block.to(sharding.mesh.device, copy=True,
                    memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The whole leaf from the blocks of the ranks it is split over."""
    out = local
    for d, entry in enumerate(_entries(sharding.spec, local.ndim)):
        if entry is not None:
            out = coll.all_gather(out, sharding.mesh, entry, dim=d)
    return out


def reduce_to_block(full: torch.Tensor, sharding: NamedSharding, axes
                    ) -> torch.Tensor:
    """This rank's block of the sum of `full` over the ranks of `axes`
    (each rank holding a whole-leaf partial sum, e.g. the grads of its
    batch block): a reduce-scatter along the dim split over exactly
    `axes` where there is one, else an all-reduce; then the block."""
    mesh = sharding.mesh
    entries = _entries(sharding.spec, full.ndim)
    axes = coll.axes_of(axes)
    if axes:
        dims = [d for d, e in enumerate(entries) if coll.axes_of(e) == axes]
        if dims:
            full = coll.reduce_scatter(full, mesh, axes, dim=dims[0])
            entries[dims[0]] = None
        else:
            full = coll.all_reduce(full, mesh, axes)
    block = full[_slices(tuple(full.shape), entries, mesh)]
    return block.clone(memory_format=torch.contiguous_format)


def owns(sharding: NamedSharding) -> bool:
    """Whether this rank holds the first copy of its block: its coordinate
    is 0 on every axis the leaf is not split over (so a sum over the mesh
    of the owners' blocks counts each element once)."""
    split = split_axes(sharding)
    return all(c == 0 for a, c in sharding.mesh.coords.items()
               if a not in split)


def shard_tree(tree: Any, shardings: Any) -> Any:
    return _tree.tree_map(shard, tree, shardings)


def gather_tree(tree: Any, shardings: Any) -> Any:
    return _tree.tree_map(gather, tree, shardings)


def block_bytes(tree: Any, shardings: Any) -> int:
    """The bytes of this rank's blocks of a tree of whole-leaf shapes
    (`tree` may hold meta tensors): what a rank holding only its blocks
    keeps resident."""
    return sum(math.prod(local_shape(tuple(l.shape), s)) * _itemsize(l)
               for l, s in zip(_tree.leaves(tree), _tree.leaves(shardings),
                               strict=True))


def resident_bytes(tree: Any) -> int:
    """The bytes of the distinct storages behind a tree's tensors (a view
    of a whole leaf counts the whole leaf)."""
    seen = {}
    for t in _tree.leaves(tree):
        st = t.untyped_storage()
        seen[(st.data_ptr(), t.device)] = st.nbytes()
    return sum(seen.values())
