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

The training state holds float32 and int32 leaves only; a leaf of
another dtype raises, naming itself (a bfloat16 `.npy` file would need a
package that the card's machine does not have to read back).
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

_MANIFEST = "manifest.json"
_DTYPES = ("float32", "int32")


def _to_host(name: str, leaf) -> np.ndarray:
    """A leaf as a C-ordered numpy array of its own (a blocking copy from
    the device)."""
    if isinstance(leaf, torch.Tensor):
        dtype = str(leaf.dtype).removeprefix("torch.")
        if leaf.dtype in (torch.float32, torch.int32):
            leaf = leaf.detach().to("cpu", copy=True).numpy()
    else:
        leaf = np.asarray(leaf)
        dtype = str(leaf.dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"checkpoint leaf {name} is {dtype}; the training "
                        "state holds float32 and int32 only")
    return np.asarray(leaf, order="C")


def _snapshot(tree: Any) -> list[tuple[str, np.ndarray]]:
    return [(name, _to_host(name, leaf))
            for name, leaf in _tree.named_leaves(tree)]


def _write(directory: str, step: int,
           host: list[tuple[str, np.ndarray]]) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, arr) in enumerate(host):
        fn = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"name": name, "file": fn,
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                    # atomic publish
    return final


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic save. Returns the published path."""
    return _write(directory, step, _snapshot(tree))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, d, _MANIFEST)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Any, step: int | None = None,
                       device: Any = None) -> tuple[Any, int]:
    """Restore into the structure of `like` (a tree of tensors). Each leaf
    goes to `device` (a device, or a tree of devices shaped like `like`)
    or, when None, to the device of its leaf in `like`. The manifest's
    names and shapes must be `like`'s."""
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
    if device is None:
        targets = [leaf.device if isinstance(leaf, torch.Tensor)
                   else torch.device("cpu") for _, leaf in named]
    elif isinstance(device, (dict, tuple, list)):
        targets = _tree.leaves(device)
    else:
        targets = [device] * len(named)
    out = []
    for (name, leaf), entry, dev in zip(named, manifest, targets,
                                        strict=True):
        arr = np.load(os.path.join(path, entry["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {name} has shape "
                             f"{arr.shape}, the state {tuple(leaf.shape)}")
        out.append(torch.from_numpy(arr).to(dev))
    return _tree.unflatten(like, out), step


class CheckpointManager:
    """Async save + retention. One in-flight save at a time (a later save
    waits for it); a failed write raises from the next `wait`."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        host = _snapshot(tree)      # blocking copies: taken before return

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

    def restore_latest(self, like: Any, device: Any = None):
        self.wait()
        return restore_checkpoint(self.directory, like, device=device)
