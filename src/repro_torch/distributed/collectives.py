"""A mesh whose slots are the ranks of a `torch.distributed` group, and the
collectives the sharded training state runs over its axes.

The reference's training mesh is a `jax.sharding.Mesh` of devices, and
its collectives (`psum`, `psum_scatter`, `all_gather`, `pmax`) run inside
`jit`/`shard_map` over named axes. Here a `RankMesh` lays the ranks of the
default process group out row-major over named axes; each rank owns one
slot and that slot's device. One process group is made per set of axes
(every non-empty set, each coset of it, once per mesh, in the same order
on every rank), so a collective over "data", over "model" or over
("pod", "data") is one call on the matching group.

Transport: gloo, on the CPU and on the card alike. The H100 machine has
one card, and NCCL does not place two ranks on one GPU, so ranks share
cuda:0 and exchange its tensors over gloo; torch 2.11's gloo takes CUDA
tensors for every collective used here (all_reduce SUM and MAX on f32 and
int32, reduce_scatter_tensor, all_gather_into_tensor, barrier), so no
collective stages through a host buffer of its own.

Every group is made with a timeout (`TIMEOUT_S`), so a rank that dies
makes the others raise instead of hang; rendezvous goes through a file
store under a directory the caller names, never a fixed TCP port.

`spawn` starts the ranks of one run (`torch.multiprocessing`, spawn
start method) and returns each rank's result, raising when a rank fails
or outlives its time limit.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import _quiet

TIMEOUT_S = 60.0

Axes = tuple[str, ...]


def axes_of(entry) -> Axes:
    """A PartitionSpec entry (None, an axis name or a tuple of names) as a
    tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class RankMesh:
    """The ranks of the default process group as a mesh of `shape` over
    `axis_names`, row-major (rank r sits at `np.unravel_index(r, shape)`).

    `shape` is a dict axis -> size, as `jax.sharding.Mesh.shape`; `coords`
    this rank's coordinate on each axis; `device` its slot's device. A
    one-slot mesh needs no process group. `comm` counts this rank's
    collectives since its last reset: calls, the bytes a ring algorithm
    sends from this rank, and host seconds inside them (each starts after
    a synchronize of the rank's device, so the device's earlier work is
    not counted as communication)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device, timeout_s: float = TIMEOUT_S):
        self.axis_names = tuple(axis_names)
        dims = tuple(int(n) for n in shape)
        if len(dims) != len(self.axis_names) or min(dims, default=0) < 1:
            raise ValueError(f"mesh shape {dims} for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, dims))
        self.size = math.prod(dims)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size:
            raise ValueError(f"a {dims} mesh needs {self.size} ranks, the "
                             f"process group has {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank,
                                                                 dims))))
        self.device = torch.device(device)
        self.comm = {"calls": 0, "bytes_sent": 0, "seconds": 0.0}
        self._groups: dict[Axes, Any] = {}
        grid = np.arange(self.size).reshape(dims)
        timeout = datetime.timedelta(seconds=timeout_s)
        for n in range(1, len(dims) + 1):
            for combo in itertools.combinations(range(len(dims)), n):
                axes = tuple(self.axis_names[i] for i in combo)
                k = math.prod(dims[i] for i in combo)
                if k == 1:
                    continue
                if k == self.size:
                    self._groups[axes] = dist.group.WORLD
                    continue
                rest = [i for i in range(len(dims)) if i not in combo]
                cosets = grid.transpose(rest + list(combo)).reshape(-1, k)
                for ranks in cosets.tolist():
                    g = dist.new_group(ranks, timeout=timeout)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def ordered(self, axes) -> Axes:
        """`axes` (a name, a tuple of names or None) in the mesh's order;
        raises on a name the mesh lacks or a tuple out of the mesh's order
        (a block index is row-major over the tuple, a group's ranks are
        row-major over the mesh)."""
        axes = axes_of(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} not in mesh {self.axis_names}")
        if list(axes) != sorted(axes, key=self.axis_names.index):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.ordered(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over `axes` (its block's index)."""
        i = 0
        for a in self.ordered(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of the ranks that share this rank's
        coordinates off `axes`; None when those axes hold one slot."""
        axes = self.ordered(axes)
        return self._groups.get(tuple(a for a in self.axis_names
                                      if a in axes))

    def reset_comm(self) -> None:
        self.comm = {"calls": 0, "bytes_sent": 0, "seconds": 0.0}

    def _run(self, fn, sent: int, kind: str = "", result: int = 0):
        """fn() timed and counted; `kind` and `result` (the collective's
        name and result bytes) are for `DryMesh`, which runs nothing."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.comm["calls"] += 1
        self.comm["bytes_sent"] += sent
        self.comm["seconds"] += time.perf_counter() - t0
        return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_reduce(x: torch.Tensor, mesh: RankMesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """The SUM or MAX of `x` over the ranks of `axes` (a new tensor)."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    g, k = mesh.group(axes), mesh.axes_size(axes)
    out = x.clone(memory_format=torch.contiguous_format)
    if g is None:
        return out
    mesh._run(lambda: dist.all_reduce(out, op=red, group=g),
              2 * (k - 1) * _nbytes(out) // k, "all-reduce", _nbytes(out))
    return out


def reduce_scatter(x: torch.Tensor, mesh: RankMesh, axes, dim: int = 0
                   ) -> torch.Tensor:
    """The sum of `x` over the ranks of `axes`, split along `dim` into as
    many blocks as those ranks; this rank's block (index `mesh.index`)."""
    g, k = mesh.group(axes), mesh.axes_size(axes)
    if g is None:
        return x.clone(memory_format=torch.contiguous_format)
    if x.shape[dim] % k:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {k} blocks")
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // k, *src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    mesh._run(lambda: _quiet(dist.reduce_scatter_tensor, out, src, group=g),
              (k - 1) * _nbytes(out), "reduce-scatter", _nbytes(out))
    return out.movedim(0, dim).contiguous()


def all_gather(x: torch.Tensor, mesh: RankMesh, axes, dim: int = 0
               ) -> torch.Tensor:
    """The blocks of the ranks of `axes` joined along `dim`, in block
    order."""
    g, k = mesh.group(axes), mesh.axes_size(axes)
    if g is None:
        return x.clone(memory_format=torch.contiguous_format)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] * k, *src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    mesh._run(lambda: _quiet(dist.all_gather_into_tensor, out, src, group=g),
              (k - 1) * _nbytes(src), "all-gather", _nbytes(out))
    return out.movedim(0, dim).contiguous()


class DryMesh(RankMesh):
    """One chosen rank of a mesh of `shape`, with no process group: the dry
    run's stand-in for a RankMesh. `group` answers a token wherever the
    axes hold more than one slot, and `_run` counts a collective (calls,
    ring-model bytes sent, and per kind its count and result bytes in
    `kinds`, and per (kind, result bytes) its count in `calls`) without
    running it, so a collective's
    output keeps the empty tensor it was given (meta in the dry run). A
    step made for a RankMesh runs on it unchanged and makes every
    collective it would make, at its real size."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0, device="meta"):
        self.axis_names = tuple(axis_names)
        dims = tuple(int(n) for n in shape)
        if len(dims) != len(self.axis_names) or min(dims, default=0) < 1:
            raise ValueError(f"mesh shape {dims} for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, dims))
        self.size = math.prod(dims)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} of a {dims} mesh")
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(rank, dims))))
        self.device = torch.device(device)
        self.reset_comm()

    def group(self, axes):
        axes = self.ordered(axes)
        return ("dry", axes) if self.axes_size(axes) > 1 else None

    def reset_comm(self) -> None:
        self.comm = {"calls": 0, "bytes_sent": 0, "seconds": 0.0}
        self.kinds: dict[str, dict[str, int]] = {}
        self.calls: dict[tuple[str, int], int] = {}

    def _run(self, fn, sent: int, kind: str = "", result: int = 0):
        self.comm["calls"] += 1
        self.comm["bytes_sent"] += sent
        k = self.kinds.setdefault(kind, {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += result
        self.calls[(kind, result)] = self.calls.get((kind, result), 0) + 1
        return None


def barrier(mesh: RankMesh) -> None:
    if mesh.size > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# Ranks: one process each
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class World:
    """What one rank of a spawned run knows: its rank among `size`, the
    directory its file stores go under, and its device. `join` forms a
    process group over some of the run's ranks (all of them at first;
    the survivors after a failure), `leave` ends it."""
    rank: int
    size: int
    store_dir: str
    device: torch.device
    timeout_s: float = TIMEOUT_S

    def join(self, ranks: Sequence[int], shape: Sequence[int],
             axis_names: Sequence[str], tag: str) -> RankMesh:
        """A RankMesh of `shape` over `ranks` (this rank among them), in a
        new process group whose store is `store_dir/tag` (a tag names one
        generation of the group and is never reused)."""
        ranks = list(ranks)
        self.leave()
        if len(ranks) > 1:
            dist.init_process_group(
                "gloo", init_method="file://" + os.path.join(self.store_dir,
                                                             tag),
                rank=ranks.index(self.rank), world_size=len(ranks),
                timeout=datetime.timedelta(seconds=self.timeout_s))
        elif ranks != [self.rank]:
            raise ValueError(f"rank {self.rank} is not in {ranks}")
        return RankMesh(shape, axis_names, self.device, self.timeout_s)

    @staticmethod
    def leave() -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def rank_device(device, rank: int) -> torch.device:
    """The device of rank `rank` when a run is asked for `device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(fn, world: World, args, results) -> None:
    try:
        if world.device.type == "cuda":
            torch.cuda.set_device(world.device)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world.size))
        results.put((world.rank, True, fn(world, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, re-raised
        results.put((world.rank, False, traceback.format_exc()))
        raise
    finally:
        World.leave()


def spawn(fn: Callable, nranks: int, *args, device="cpu",
          timeout_s: float | None = None) -> list:
    """Run `fn(world, *args)` in `nranks` new processes, one per rank, on
    `device` (a CUDA device without an index: rank r on card r modulo the
    card count, so every rank on cuda:0 of a one-card machine); returns
    their results in rank order. `fn` must be importable by name (a
    module-level function). Raises, after stopping every rank, when a
    rank raises, dies, or the run outlives `timeout_s`."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    devs = [rank_device(device, r) for r in range(nranks)]
    with tempfile.TemporaryDirectory(prefix="ranks_") as store:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, World(r, nranks, store, devs[r]),
                                   args, results))
                 for r in range(nranks)]
        for p in procs:
            p.start()
        got: dict[int, Any] = {}
        errors: list[str] = []
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while len(got) + len(errors) < nranks:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead and results.empty():
                        errors.append(f"ranks {dead} exited with codes "
                                      f"{[procs[r].exitcode for r in dead]}")
                        break
                    if deadline is not None and time.monotonic() > deadline:
                        errors.append(f"the run outlived {timeout_s} s")
                        break
                    continue
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
            for p in procs:
                p.join(timeout=0 if errors else 30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if errors:
            raise RuntimeError("a rank failed: " + "\n".join(errors))
    return [got[r] for r in range(nranks)]
