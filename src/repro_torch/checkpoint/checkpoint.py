"""Fault-tolerant checkpointing of a training state (port of
`repro.checkpoint.checkpoint`, its on-disk format unchanged).

  * Each leaf is one `{i:05d}.npy` file under a step directory, in JAX's
    leaf order (dict keys sorted, tuples by index), with a JSON manifest
    of the leaves' names ("0__blocks__wq"), shapes and dtypes: a
    checkpoint written by either package restores in the other.
  * ATOMIC PUBLISH: writes go to `step_<n>.tmp/`, then one os.rename to
    `step_<n>/`; restore only ever sees fully renamed directories.
  * ASYNC: `CheckpointManager.save_async` copies the state to host memory
    before it returns (a blocking device-to-host copy, so the next step
    cannot change what is saved), then writes on a background thread.
  * RETENTION: keeps the newest `keep` checkpoints.
  * RESTORE to a device: each leaf goes to the device of the matching
    leaf of `like`, or to a device (or a tree of devices) given.
  * SHARDED: given `shardings` (a NamedSharding per leaf on a
    `collectives.RankMesh`), a save gathers each leaf whole and rank 0
    writes it while the other ranks wait at a barrier; a restore loads
    each leaf and keeps this rank's block (the reference's reshard on
    restore), reading only that block's bytes from the file.

Leaves are float32, int32 or bfloat16; a leaf of another dtype raises,
naming itself. A bfloat16 leaf is written as the reference writes it
(`np.save` of an ml_dtypes array): its 2-byte records under the `.npy`
descr `<V2`, with "bfloat16" in the manifest, so the files match byte for
byte; the port reads it back by the manifest's dtype as `torch.bfloat16`
(the reference's own restore hands back the raw `V2` records).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh

_MANIFEST = "manifest.json"
_DTYPES = ("float32", "int32", "bfloat16")
_BF16_DESCR = "<V2"          # what np.save writes for an ml_dtypes bfloat16


def _to_host(name: str, leaf) -> tuple[np.ndarray, str]:
    """A leaf as a C-ordered numpy array of its own (a blocking copy from
    the device) and its dtype's name; a bfloat16 leaf as its bits
    (int16)."""
    if isinstance(leaf, torch.Tensor):
        dtype = str(leaf.dtype).removeprefix("torch.")
        if dtype in _DTYPES:
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.view(torch.int16)
            leaf = leaf.to("cpu", copy=True).numpy()
    else:
        leaf = np.asarray(leaf)
        dtype = str(leaf.dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"checkpoint leaf {name} is {dtype}; the training "
                        "state holds float32, int32 and bfloat16 only")
    return np.asarray(leaf, order="C"), dtype


def _snapshot(tree: Any, shardings: Any = None
              ) -> list[tuple[str, np.ndarray, str]] | None:
    """Host copies of the leaves; with shardings each leaf is gathered
    whole (every rank takes part) and only rank 0 keeps the copy (None
    elsewhere)."""
    named = _tree.named_leaves(tree)
    if shardings is None:
        return [(name, *_to_host(name, leaf)) for name, leaf in named]
    layouts = _tree.leaves(shardings)
    root = layouts[0].mesh.rank == 0
    out = []
    for (name, leaf), s in zip(named, layouts, strict=True):
        whole = sh.gather(leaf, s)
        if root:
            out.append((name, *_to_host(name, whole)))
        del whole
    return out if root else None


def _save(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _write(directory: str, step: int,
           host: list[tuple[str, np.ndarray, str]]) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, arr, dtype) in enumerate(host):
        fn = f"{i:05d}.npy"
        _save(os.path.join(tmp, fn), arr, dtype)
        manifest["leaves"].append({"name": name, "file": fn,
                                   "shape": list(arr.shape),
                                   "dtype": dtype})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                    # atomic publish
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    shardings: Any = None) -> str:
    """Synchronous atomic save. Returns the published path. With
    `shardings`, every rank calls it with its blocks; rank 0 writes."""
    host = _snapshot(tree, shardings)
    path = os.path.join(directory, f"step_{step:08d}")
    if host is not None:
        path = _write(directory, step, host)
    if shardings is not None:
        coll.barrier(_tree.leaves(shardings)[0].mesh)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, d, _MANIFEST)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _load(path: str, entry: dict, sharding=None) -> torch.Tensor:
    """A leaf file as a CPU tensor of the manifest's dtype: the whole leaf,
    or this rank's block of it (read through a memory map)."""
    arr = np.load(path, mmap_mode="r" if sharding is not None else None)
    if sharding is not None:
        arr = arr[sh.block_slices(tuple(arr.shape), sharding)]
    if entry["dtype"] == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16)
    if entry["dtype"] not in _DTYPES or str(arr.dtype) != entry["dtype"]:
        raise TypeError(f"{path} holds {arr.dtype}, the manifest says "
                        f"{entry['dtype']}")
    return torch.from_numpy(np.array(arr))


def restore_checkpoint(directory: str, like: Any, step: int | None = None,
                       device: Any = None, shardings: Any = None
                       ) -> tuple[Any, int]:
    """Restore into the structure of `like` (a tree of tensors). Each leaf
    goes to `device` (a device, or a tree of devices shaped like `like`)
    or, when None, to the device of its leaf in `like`. With `shardings`
    (a NamedSharding per leaf), each rank keeps its block of each leaf
    on its mesh device, and `like` holds blocks. The manifest's names and
    shapes (of the blocks, when sharded) must be `like`'s."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)["leaves"]
    named = _tree.named_leaves(like)
    if [n for n, _ in named] != [leaf["name"] for leaf in manifest]:
        raise ValueError(f"{path} holds leaves "
                         f"{[leaf['name'] for leaf in manifest]}, the state "
                         f"{[n for n, _ in named]}")
    if shardings is not None:
        layouts = _tree.leaves(shardings)
        targets = [s.mesh.device for s in layouts]
    else:
        layouts = [None] * len(named)
        if device is None:
            targets = [leaf.device if isinstance(leaf, torch.Tensor)
                       else torch.device("cpu") for _, leaf in named]
        elif isinstance(device, (dict, tuple, list)):
            targets = _tree.leaves(device)
        else:
            targets = [device] * len(named)
    out = []
    for (name, leaf), entry, dev, s in zip(named, manifest, targets,
                                           layouts, strict=True):
        shape = tuple(entry["shape"])
        if s is not None:
            shape = sh.local_shape(shape, s)
        if shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {name} has shape "
                             f"{shape}, the state {tuple(leaf.shape)}")
        out.append(_load(os.path.join(path, entry["file"]), entry, s).to(dev))
    return _tree.unflatten(like, out), step


class CheckpointManager:
    """Async save + retention. One in-flight save at a time (a later save
    waits for it); a failed write raises from the next `wait`. A sharded
    save (`shardings=`) gathers on every rank and writes on rank 0; the
    next `wait`, which every rank calls, ends at a barrier after the
    write, so no rank looks for the newest checkpoint before it is
    published."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._mesh = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree: Any, shardings: Any = None
                   ) -> None:
        self.wait()
        # blocking copies (and gathers): taken before return
        host = _snapshot(tree, shardings)
        if shardings is not None:
            self._mesh = _tree.leaves(shardings)[0].mesh
        if host is None:
            return

        def work():
            try:
                _write(self.directory, step, host)
                self._gc()
            except Exception as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            coll.barrier(mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like: Any, device: Any = None,
                       shardings: Any = None):
        self.wait()
        return restore_checkpoint(self.directory, like, device=device,
                                  shardings=shardings)
